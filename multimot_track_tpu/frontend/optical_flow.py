"""Dense optical flow: coarse-to-fine pyramidal Lucas-Kanade, pure jnp.

The reference *consumes* precomputed .flo files (PWC-Net outputs shipped
with the dataset; Examples/RGB-D/rgbd_tum.cc:129) and cannot run without
them.  This module makes the framework self-contained: a dense flow field
estimated on-device with the classic iterative LK scheme —

  per level (coarse to fine): warp I1 by the upsampled flow, compute
  spatio-temporal gradients, solve the 2x2 LK system per pixel from
  box-filtered gradient products (separable running sums), iterate.

Everything is whole-image tensor algebra (fusable elementwise work); no per-pixel
control flow.  Quality target is the pipeline's needs (sub-pixel static
flow for the flow-BA), not SOTA benchmarks — the .flo path remains
available and preferred when files exist.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from multimot_track_tpu.frontend.stereo import _box_filter
from multimot_track_tpu.geometry.camera import bilinear_sample


def _warp(img: jnp.ndarray, flow: jnp.ndarray) -> jnp.ndarray:
    H, W = img.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    uv = jnp.stack([xs + flow[..., 0], ys + flow[..., 1]], axis=-1)
    return bilinear_sample(img, uv)


def _lk_level(I0, I1, flow, radius: int, iters: int, eps: float = 1e-3):
    """Iterative LK refinement of ``flow`` at one pyramid level."""

    gx = 0.5 * (jnp.roll(I0, -1, 1) - jnp.roll(I0, 1, 1))
    gy = 0.5 * (jnp.roll(I0, -1, 0) - jnp.roll(I0, 1, 0))
    Ixx = _box_filter(gx * gx, radius)
    Ixy = _box_filter(gx * gy, radius)
    Iyy = _box_filter(gy * gy, radius)
    det = Ixx * Iyy - Ixy * Ixy
    ok = det > eps
    inv_det = jnp.where(ok, 1.0 / jnp.maximum(det, eps), 0.0)

    flow0 = flow

    def body(_, flow):
        It = _warp(I1, flow) - I0
        bx = _box_filter(gx * It, radius)
        by = _box_filter(gy * It, radius)
        du = -(Iyy * bx - Ixy * by) * inv_det
        dv = -(Ixx * by - Ixy * bx) * inv_det
        # damped, clamped update; total per-level correction trust region
        # keeps weakly-textured regions from drifting off the pyramid init
        upd = 0.5 * jnp.stack([jnp.clip(du, -1.0, 1.0), jnp.clip(dv, -1.0, 1.0)], -1)
        new = flow + upd
        return flow0 + jnp.clip(new - flow0, -3.0, 3.0)

    return jax.lax.fori_loop(0, iters, body, flow)


@functools.partial(jax.jit, static_argnames=("n_levels", "radius", "iters"))
def dense_flow(
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    n_levels: int = 5,
    radius: int = 5,
    iters: int = 8,
) -> jnp.ndarray:
    """(H, W) x2 -> (H, W, 2) forward flow img0 -> img1."""
    H, W = img0.shape
    pyr0 = [img0]
    pyr1 = [img1]
    for _ in range(n_levels - 1):
        pyr0.append(_box_filter(pyr0[-1], 1)[::2, ::2] / 9.0)
        pyr1.append(_box_filter(pyr1[-1], 1)[::2, ::2] / 9.0)
    flow = jnp.zeros(pyr0[-1].shape + (2,), jnp.float32)
    for lvl in range(n_levels - 1, -1, -1):
        if lvl < n_levels - 1:
            Hn, Wn = pyr0[lvl].shape
            flow = 2.0 * jax.image.resize(flow, (Hn, Wn, 2), "linear")
        flow = _lk_level(pyr0[lvl], pyr1[lvl], flow, radius, iters)
    return flow
