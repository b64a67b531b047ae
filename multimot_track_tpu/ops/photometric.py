"""Photometric verification of flow correspondences (patch ZNCC).

The reference trusts the precomputed .flo correspondences unconditionally
(src/Frame.cc:251-264 shifts keypoints by the flow with no verification);
bad flow — occlusions, motion boundaries, textureless road — enters the
camera solve and is only softened by the Huber kernel.  Measured on
kitti_sample, 10-20%% of static samples carry >10 px flow error in
coherent clusters that bias the pose (tools/diag_ego3.py).

This module adds an independent witness the reference lacks: compare a
small intensity patch around the point in the last frame with the patch
at its flow-shifted position in the current frame (zero-normalised cross
correlation).  Wrong flow ⇒ decorrelated patches ⇒ the point is dropped
before the solve.  On the device this is a batched bilinear gather + small
reductions — a few microseconds for thousands of points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_patches(gray: jnp.ndarray, uv: jnp.ndarray, radius: int) -> jnp.ndarray:
    """(N, (2r+1)^2) bilinear intensity patches centred at ``uv`` (x, y).

    Per-tap advanced indexing lowers to (2r+1)^2 * 4 scalar gathers per
    point; instead each point fetches its (2r+2)x(2r+2) support as 2r+2 row slices
    (vmapped dynamic_slice -> one lax.gather with slice_sizes=(1, 2r+2)),
    then blends bilinearly with in-register shifts — ~20x fewer, wider
    accesses.  Near the image border the whole support window is clamped
    inside the image (the old path clamped each tap independently); points
    more than r+1 px from the border — everything the samplers produce —
    are bit-identical.

    Points on a regular grid avoid gathers entirely — see
    frontend/sampling.sample_dense_objects' strided-slice patches.
    """
    H, W = gray.shape
    S = 2 * radius + 2                       # support width incl. +1 for blend
    x = jnp.clip(uv[..., 0], 0.0, W - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, H - 1.001)
    xb = jnp.floor(x).astype(jnp.int32)
    yb = jnp.floor(y).astype(jnp.int32)
    fx = (x - xb).astype(gray.dtype)
    fy = (y - yb).astype(gray.dtype)
    x0 = jnp.clip(xb - radius, 0, W - S)
    y0 = jnp.clip(yb - radius, 0, H - S)

    def rows(yy, xx):
        return jax.lax.dynamic_slice(gray, (yy, xx), (S, S))

    G = jax.vmap(rows)(y0, x0)                                  # (N, S, S)
    hx = G[:, :, :-1] * (1.0 - fx[:, None, None]) + G[:, :, 1:] * fx[:, None, None]
    v = hx[:, :-1, :] * (1.0 - fy[:, None, None]) + hx[:, 1:, :] * fy[:, None, None]
    return v.reshape(uv.shape[0], (2 * radius + 1) ** 2)


def zncc(patch_a: jnp.ndarray, patch_b: jnp.ndarray) -> jnp.ndarray:
    """Zero-normalised cross-correlation along the last axis, in [-1, 1].

    Textureless patches (zero variance) score ~0 — treated as unverifiable
    rather than verified, which is the conservative choice for flow gating.
    """
    a = patch_a - patch_a.mean(-1, keepdims=True)
    b = patch_b - patch_b.mean(-1, keepdims=True)
    num = (a * b).sum(-1)
    den = jnp.sqrt((a * a).sum(-1) * (b * b).sum(-1)) + 1e-6
    return num / den


def refine_position(
    gray: jnp.ndarray,        # (H, W) current frame
    uv: jnp.ndarray,          # (N, 2) predicted positions
    patch_ref: jnp.ndarray,   # (N, (2r+1)^2) reference patches to lock onto
    radius: int,              # patch radius r (must match patch_ref)
    search_radius: int = 2,
    step: float = 1.0,
):
    """KLT-style local re-centering: evaluate ZNCC against ``patch_ref`` on
    a (2s+1)^2 grid of candidate positions around each prediction and take
    the best.  One batched gather-and-reduce — the batched template
    tracker.  Returns (refined uv (N, 2), best zncc (N,))."""
    s = search_radius
    dy, dx = jnp.meshgrid(
        jnp.arange(-s, s + 1), jnp.arange(-s, s + 1), indexing="ij"
    )
    offs = jnp.stack([dx.reshape(-1), dy.reshape(-1)], -1).astype(uv.dtype) * step
    C = offs.shape[0]

    def score_offset(off):
        p = extract_patches(gray, uv + off[None, :], radius)
        return zncc(patch_ref, p)

    scores = jnp.stack([score_offset(offs[c]) for c in range(C)])  # (C, N)
    best = jnp.argmax(scores, axis=0)                              # (N,)
    k = 2 * s + 1
    grid = scores.reshape(k, k, -1)                                # (ky, kx, N)
    by = best // k
    bx = best % k
    n = jnp.arange(uv.shape[0])

    # subpixel: separable parabola through the best cell and its neighbours
    # (without it the returned positions are quantised to the search step,
    # which feeds ~step/2 of noise into any downstream least squares)
    def parab(sm, s0, sp):
        den = sm - 2.0 * s0 + sp
        d = jnp.where(jnp.abs(den) > 1e-9, 0.5 * (sm - sp) / den, 0.0)
        return jnp.clip(d, -0.5, 0.5)

    bxc = jnp.clip(bx, 1, k - 2)
    byc = jnp.clip(by, 1, k - 2)
    dxs = parab(grid[byc, bxc - 1, n], grid[byc, bxc, n], grid[byc, bxc + 1, n])
    dys = parab(grid[byc - 1, bxc, n], grid[byc, bxc, n], grid[byc + 1, bxc, n])
    # at the grid border the parabola support is off-centre — keep integer
    dxs = jnp.where((bx >= 1) & (bx <= k - 2), dxs, 0.0)
    dys = jnp.where((by >= 1) & (by <= k - 2), dys, 0.0)
    sub = jnp.stack([dxs, dys], -1) * step
    return uv + offs[best] + sub, jnp.max(scores, axis=0)
