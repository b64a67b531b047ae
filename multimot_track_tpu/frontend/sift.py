"""SIFT: DoG scale-space keypoints + 128-d descriptors, pure jnp.

Functional counterpart of the reference's cudasift subsystem
(src/cudasift/cudaSiftD.cu:22-896 ScaleDown/LowPass/FindPointsMulti/
ComputeOrientations/ExtractSiftDescriptors; host orchestration
cudaSiftH.cu:19-385) — not a translation: every stage is expressed as
whole-image tensor ops (separable convolutions, rolled comparisons,
batched gathers) that XLA fuses, with the descriptor stage as
one batched einsum over precomputed bin-weight masks.

Matching uses dot products of L2-normalised descriptors as one matmul
(ops/matching.match_float) — the counterpart of cudasift's
MatchSiftData/FindMaxCorr kernels (src/cudasift/matching.cu:7-536).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from multimot_track_tpu.frontend.orb import _gaussian_kernel1d


class SiftKeypoints(NamedTuple):
    uv: jnp.ndarray       # (N, 2) level-0 pixel coords
    scale: jnp.ndarray    # (N,) sigma in level-0 pixels
    angle: jnp.ndarray    # (N,) orientation (radians)
    score: jnp.ndarray    # (N,) |DoG| response
    valid: jnp.ndarray    # (N,)
    desc: jnp.ndarray     # (N, 128) L2-normalised float32


def _blur(img, sigma):
    radius = max(1, int(3.0 * sigma + 0.5))
    k = jnp.asarray(_gaussian_kernel1d(sigma, radius))
    x = img[None, None]
    x = jax.lax.conv_general_dilated(x, k.reshape(1, 1, -1, 1), (1, 1), [(radius, radius), (0, 0)])
    x = jax.lax.conv_general_dilated(x, k.reshape(1, 1, 1, -1), (1, 1), [(0, 0), (radius, radius)])
    return x[0, 0]


def _local_extrema(dog_prev, dog, dog_next, thresh):
    """26-neighborhood extremum test via rolled comparisons."""
    def nbr_max(x):
        m = x
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                m = jnp.maximum(m, jnp.roll(x, (dy, dx), (0, 1)))
        return m

    def nbr_min(x):
        m = x
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                m = jnp.minimum(m, jnp.roll(x, (dy, dx), (0, 1)))
        return m

    up_max = jnp.maximum(nbr_max(dog_prev), jnp.maximum(jnp.roll(dog_prev, 0, 0), dog_prev))
    dn_max = nbr_max(dog_next)
    all_max = jnp.maximum(nbr_max(dog), jnp.maximum(up_max, jnp.maximum(dn_max, jnp.maximum(dog_prev, dog_next))))
    up_min = nbr_min(dog_prev)
    dn_min = nbr_min(dog_next)
    all_min = jnp.minimum(nbr_min(dog), jnp.minimum(jnp.minimum(up_min, dn_min), jnp.minimum(dog_prev, dog_next)))
    is_max = (dog >= all_max) & (dog > thresh)
    is_min = (dog <= all_min) & (dog < -thresh)
    # edge rejection: 2x2 Hessian ratio (FindPointsMulti's edgeLimit)
    dxx = jnp.roll(dog, -1, 1) + jnp.roll(dog, 1, 1) - 2 * dog
    dyy = jnp.roll(dog, -1, 0) + jnp.roll(dog, 1, 0) - 2 * dog
    dxy = 0.25 * (
        jnp.roll(dog, (-1, -1), (0, 1)) + jnp.roll(dog, (1, 1), (0, 1))
        - jnp.roll(dog, (-1, 1), (0, 1)) - jnp.roll(dog, (1, -1), (0, 1))
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = 10.0
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    return (is_max | is_min) & edge_ok


@functools.lru_cache(maxsize=None)
def _descriptor_weights():
    """Precompute (16, 16, 4, 4) bilinear spatial weights of each pixel of a
    16x16 patch into the 4x4 descriptor grid + gaussian window."""
    coords = (np.arange(16) + 0.5) / 4.0 - 0.5   # in bin units, 0..3
    wy = np.zeros((16, 4))
    for i, c in enumerate(coords):
        for b in range(4):
            w = max(0.0, 1.0 - abs(c - b))
            wy[i, b] = w
    g = np.exp(-((np.arange(16) - 7.5) ** 2) / (2 * (8.0) ** 2))
    W = np.einsum("ia,jb->ijab", wy * g[:, None], wy * g[:, None])
    return W.astype(np.float32)  # (16y, 16x, 4by, 4bx)


def _descriptors(img, uv, scale, angle):
    """(N, 128) descriptors: rotated 16x16 gradient patch, 8 orientation
    bins with linear interpolation, bilinear spatial binning, L2 + clip."""
    H, W = img.shape
    gx = 0.5 * (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1))
    gy = 0.5 * (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0))

    ys, xs = jnp.mgrid[0:16, 0:16]
    # offsets in patch units centred at 7.5, spacing = scale/2 per pixel
    off = jnp.stack([(xs - 7.5), (ys - 7.5)], axis=-1).astype(jnp.float32)  # (16,16,2)
    c, s = jnp.cos(angle), jnp.sin(angle)
    R = jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)      # (N,2,2)
    step = (scale * 0.5)[:, None, None, None]
    pos = uv[:, None, None, :] + step * jnp.einsum("nij,yxj->nyxi", R, off)  # (N,16,16,2)
    xi = jnp.clip(jnp.round(pos[..., 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(pos[..., 1]).astype(jnp.int32), 0, H - 1)
    pgx = gx[yi, xi]
    pgy = gy[yi, xi]
    mag = jnp.sqrt(pgx * pgx + pgy * pgy)
    ori = jnp.arctan2(pgy, pgx) - angle[:, None, None]      # rotation invariant
    ob = (ori / (2 * jnp.pi) * 8.0) % 8.0                   # fractional bin
    b0 = jnp.floor(ob).astype(jnp.int32) % 8
    b1 = (b0 + 1) % 8
    f = ob - jnp.floor(ob)
    onehot0 = jax.nn.one_hot(b0, 8) * (1 - f)[..., None]
    onehot1 = jax.nn.one_hot(b1, 8) * f[..., None]
    obins = (onehot0 + onehot1) * mag[..., None]             # (N,16,16,8)
    Wsp = jnp.asarray(_descriptor_weights())                 # (16,16,4,4)
    desc = jnp.einsum("nyxo,yxab->nabo", obins, Wsp).reshape(-1, 128)
    n1 = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(n1, 1e-9)
    desc = jnp.minimum(desc, 0.2)                            # illumination clip
    n2 = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    return desc / jnp.maximum(n2, 1e-9)


def _orientation(img, uv, scale):
    """Dominant gradient orientation, 36-bin histogram (ComputeOrientations)."""
    H, W = img.shape
    gx = 0.5 * (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1))
    gy = 0.5 * (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0))
    dy, dx = jnp.mgrid[-8:9, -8:9]
    w_g = jnp.exp(-(dx * dx + dy * dy) / (2 * 4.5 ** 2)).astype(jnp.float32)
    xi = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32)[:, None, None] + dx, 0, W - 1)
    yi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32)[:, None, None] + dy, 0, H - 1)
    m = jnp.sqrt(gx[yi, xi] ** 2 + gy[yi, xi] ** 2) * w_g
    o = jnp.arctan2(gy[yi, xi], gx[yi, xi])
    bins = ((o / (2 * jnp.pi) * 36.0) % 36.0).astype(jnp.int32)
    hist = jnp.sum(jax.nn.one_hot(bins, 36) * m[..., None], axis=(1, 2))  # (N, 36)
    best = jnp.argmax(hist, axis=-1)
    return (best.astype(jnp.float32) + 0.5) / 36.0 * 2 * jnp.pi - jnp.pi


@functools.partial(jax.jit, static_argnames=("n_octaves", "n_scales", "n_max"))
def extract_sift(
    img: jnp.ndarray,
    n_octaves: int = 4,
    n_scales: int = 3,
    n_max: int = 1024,
    init_sigma: float = 1.6,
    dog_thresh: float = 2.0,
) -> SiftKeypoints:
    """Detect + describe; keypoints padded to n_max by descending response."""
    H0, W0 = img.shape
    per_oct = max(16, n_max // n_octaves)
    all_uv, all_s, all_score, all_valid = [], [], [], []
    base = img
    for o in range(n_octaves):
        Ho, Wo = base.shape
        sigmas = [init_sigma * (2.0 ** (s / n_scales)) for s in range(n_scales + 3)]
        gauss = [_blur(base, s) for s in sigmas]
        dogs = [gauss[i + 1] - gauss[i] for i in range(len(gauss) - 1)]
        for si in range(1, len(dogs) - 1):
            ext = _local_extrema(dogs[si - 1], dogs[si], dogs[si + 1], dog_thresh)
            resp = jnp.where(ext, jnp.abs(dogs[si]), 0.0)
            flat = resp.reshape(-1)
            k = per_oct // (n_scales)
            top, idx = jax.lax.top_k(flat, max(k, 1))
            ys = (idx // Wo).astype(jnp.float32)
            xs = (idx % Wo).astype(jnp.float32)
            sc = 2.0 ** o
            all_uv.append(jnp.stack([xs, ys], -1) * sc)
            all_s.append(jnp.full(top.shape, sigmas[si] * sc))
            all_score.append(top)
            all_valid.append(top > 0)
        base = base[::2, ::2]
    uv = jnp.concatenate(all_uv)
    sc = jnp.concatenate(all_s)
    score = jnp.concatenate(all_score)
    valid = jnp.concatenate(all_valid)
    # global top n_max by response
    n = uv.shape[0]
    if n < n_max:
        pad = n_max - n
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2))])
        sc = jnp.concatenate([sc, jnp.ones(pad)])
        score = jnp.concatenate([score, jnp.zeros(pad)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    top, ti = jax.lax.top_k(jnp.where(valid, score, 0.0), n_max)
    uv, sc, score = uv[ti], sc[ti], top
    valid = top > 0
    ang = _orientation(img, uv, sc)
    desc = _descriptors(img, uv, sc, ang)
    desc = jnp.where(valid[:, None], desc, 0.0)
    return SiftKeypoints(uv=uv, scale=sc, angle=ang, score=score, valid=valid, desc=desc)
