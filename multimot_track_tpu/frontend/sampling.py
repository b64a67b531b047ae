"""Feature sampling: dense object grids and static sparse points.

Batched re-design of the reference Frame constructor's sampling loops
(src/Frame.cc:188-324): instead of growing std::vectors pixel-by-pixel, we
evaluate the predicates over the whole grid at once and compact the valid
entries into fixed-capacity padded arrays (SURVEY.md §7: fixed-size,
mask-padded arrays everywhere), preserving the reference's row-major
ordering so cross-frame index alignment carries over.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class ObjSamples(NamedTuple):
    """Semi-dense points on instance masks (reference mvObjKeys family)."""

    uv: jnp.ndarray      # (N, 2) float32 pixel positions (x, y)
    depth: jnp.ndarray   # (N,) float32 metric depth at uv
    label: jnp.ndarray   # (N,) int32 semantic instance label (vSemObjLabel)
    flow: jnp.ndarray    # (N, 2) float32 flow to next frame (mvObjFlowNext)
    corres: jnp.ndarray  # (N, 2) float32 uv + flow (mvObjCorres)
    valid: jnp.ndarray   # (N,) bool
    patch: jnp.ndarray   # (N, P) intensity patch at uv — the photometric
    #                      witness for the object-motion consensus selector


class StaticSamples(NamedTuple):
    """Sparse background points (reference mvSiftKeysTmp family)."""

    uv: jnp.ndarray      # (N, 2) float32 keypoint positions
    depth: jnp.ndarray   # (N,) float32 depth at uv (mvSiftDepthTmp)
    flow: jnp.ndarray    # (N, 2) float32 flow at uv (mvFlowNext)
    corres: jnp.ndarray  # (N, 2) float32 uv + flow (mvCorres)
    valid: jnp.ndarray   # (N,) bool
    patch: jnp.ndarray   # (N, P) intensity patch at uv, for photometric
    #                      flow verification in the next pair (ops/photometric)


def compact(valid: jnp.ndarray, n_max: int, *payloads):
    """Compact entries where ``valid`` into the first slots of length-n_max
    arrays (stable order).  Returns (n_valid, mask, *packed).

    Implemented as one argsort + gathers instead of a ``.at[tgt].set``
    scatter over the 29k-point dense-object grid.  Key = original index, biased by +n for invalid
    entries, so valid entries come first in original (row-major) order —
    the ordering the reference's growing std::vectors produce."""
    valid = valid.reshape(-1)
    n = valid.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(valid, idx, idx + jnp.int32(n))
    order = jnp.argsort(key)
    if n >= n_max:
        take = order[:n_max]
    else:
        take = jnp.concatenate(
            [order, jnp.zeros((n_max - n,), jnp.int32)]
        )
    n_valid = jnp.sum(valid.astype(jnp.int32))
    out_mask = jnp.arange(n_max) < n_valid
    packed = []
    for p in payloads:
        flat = p.reshape(n, -1)
        out = jnp.where(out_mask[:, None], flat[take], 0).astype(flat.dtype)
        packed.append(out.reshape((n_max,) + p.shape[1:]))
    return n_valid, out_mask, *packed


@functools.partial(jax.jit, static_argnames=("step", "n_max", "patch_radius"))
def sample_dense_objects(
    depth_img: jnp.ndarray,
    sem_mask: jnp.ndarray,
    flow_img: jnp.ndarray,
    gray: jnp.ndarray = None,
    step: int = 4,
    max_depth: float = 25.0,
    n_max: int = 8192,
    patch_radius: int = 2,
) -> ObjSamples:
    """Every ``step``-th pixel where mask != 0 and 0 < depth < max_depth and
    the flow-shifted position stays strictly inside the image
    (src/Frame.cc:188-217)."""
    H, W = depth_img.shape
    gi = jnp.arange(0, H, step)
    gj = jnp.arange(0, W, step)
    yy, xx = jnp.meshgrid(gi, gj, indexing="ij")  # row-major like the C++ loops
    d = depth_img[yy, xx]
    lab = sem_mask[yy, xx]
    f = flow_img[yy, xx]  # (..., 2)
    xs = xx.astype(jnp.float32)
    ys = yy.astype(jnp.float32)
    nx = xs + f[..., 0]
    ny = ys + f[..., 1]
    valid = (
        (lab != 0)
        & (d < max_depth)
        & (d > 0)
        & (nx < W)
        & (nx > 0)
        & (ny < H)
        & (ny > 0)
    )
    uv = jnp.stack([xs, ys], axis=-1).reshape(-1, 2)
    corres = jnp.stack([nx, ny], axis=-1).reshape(-1, 2)
    P = (2 * patch_radius + 1) ** 2
    if gray is None:
        patch_grid = jnp.zeros((uv.shape[0], P), jnp.float32)
    else:
        # grid points sit at integer, stride-`step` positions, so every
        # patch tap is a strided SLICE of the (padded) image — 25 slices
        # for the whole grid instead of 8192 x 25 random gathers
        r = patch_radius
        g = jnp.pad(gray.astype(jnp.float32), r, mode="edge")
        Hg, Wg = yy.shape
        taps = [
            jax.lax.slice(
                g,
                (r + dy, r + dx),
                (r + dy + (Hg - 1) * step + 1, r + dx + (Wg - 1) * step + 1),
                (step, step),
            )
            for dy in range(-r, r + 1)
            for dx in range(-r, r + 1)
        ]
        patch_grid = jnp.stack(taps, axis=-1).reshape(-1, P)
    _, mask, uv_p, d_p, l_p, f_p, c_p, patch = compact(
        valid, n_max, uv, d.reshape(-1), lab.reshape(-1), f.reshape(-1, 2),
        corres, patch_grid,
    )
    return ObjSamples(uv=uv_p, depth=d_p, label=l_p, flow=f_p, corres=c_p,
                      valid=mask, patch=patch)


@functools.partial(jax.jit, static_argnames=("n_max", "patch_radius"))
def sample_static(
    kp_uv: jnp.ndarray,
    kp_valid: jnp.ndarray,
    depth_img: jnp.ndarray,
    sem_mask: jnp.ndarray,
    flow_img: jnp.ndarray,
    gray: jnp.ndarray = None,
    max_depth: float = 40.0,
    n_max: int = 2048,
    patch_radius: int = 2,
) -> StaticSamples:
    """Keep keypoints that are off-mask, have 0 < depth <= max_depth, carry
    non-zero flow, and whose flow-shifted position stays inside the image
    (src/Frame.cc:228-324; integer truncation of coordinates replicated).
    Depth is looked up at the truncated keypoint position and entries with
    depth <= 0 keep the reference's -1 sentinel (src/Frame.cc:312-324)."""
    H, W = depth_img.shape
    xi = jnp.clip(kp_uv[..., 0].astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(kp_uv[..., 1].astype(jnp.int32), 0, H - 1)
    lab = sem_mask[yi, xi]
    d = depth_img[yi, xi]
    f = flow_img[yi, xi]
    nx = kp_uv[..., 0] + f[..., 0]
    ny = kp_uv[..., 1] + f[..., 1]
    valid = (
        kp_valid
        & (lab == 0)
        & (d <= max_depth)
        & (d > 0)
        & (f[..., 0] != 0)
        & (f[..., 1] != 0)
        & (nx < W)
        & (ny < H)
        & (kp_uv[..., 0] < W)
        & (kp_uv[..., 1] < H)
    )
    depth_kept = jnp.where(d > 0, d, -1.0)
    corres = jnp.stack([nx, ny], axis=-1)
    _, mask, uv_p, d_p, f_p, c_p = compact(
        valid, n_max, kp_uv, depth_kept, f, corres
    )
    if gray is None:
        patch = jnp.zeros((n_max, (2 * patch_radius + 1) ** 2), jnp.float32)
    else:
        from multimot_track_tpu.ops import photometric

        # extract after compaction: n_max gathers, not len(kp_uv)
        patch = photometric.extract_patches(
            gray.astype(jnp.float32), uv_p, patch_radius
        )
    return StaticSamples(uv=uv_p, depth=d_p, flow=f_p, corres=c_p, valid=mask,
                         patch=patch)
