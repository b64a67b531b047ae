"""Oriented BRIEF (ORB-style) descriptors, pure jnp.

Functional counterpart of the reference ORBextractor descriptor stage
(src/ORBextractor.cc: IC_Angle orientation + steered rBRIEF), re-designed
for batched accelerators:

* The 256 comparison pairs are *generated* from a fixed-seed isotropic
  Gaussian (the original BRIEF recipe) instead of reusing OpenCV's
  hand-trained table — descriptors here only ever match against other
  descriptors from this extractor, so self-consistency is what matters.
* Orientation = intensity centroid over a radius-15 disc (IC_Angle).
* All keypoints are processed as one batch of gathers from the blurred
  image; no per-keypoint control flow.
* Descriptors are returned in {-1,+1} int8 "sign" form: Hamming distance
  between packed 256-bit strings equals (256 - s_a . s_b) / 2, which turns
  brute-force descriptor matching into one matmul (see ops/matching.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

PATCH_RADIUS = 15          # orientation disc radius (ORBextractor HALF_PATCH_SIZE)
N_BITS = 256


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Separable Gaussian blur (the 7x7 sigma-2 blur BRIEF sampling needs)."""
    k = jnp.asarray(_gaussian_kernel1d(sigma, radius))
    x = img[None, None]  # NCHW
    kv = k.reshape(1, 1, -1, 1)
    kh = k.reshape(1, 1, 1, -1)
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), [(radius, radius), (0, 0)])
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), [(0, 0), (radius, radius)])
    return x[0, 0]


@functools.lru_cache(maxsize=None)
def _disc_offsets(radius: int) -> Tuple[np.ndarray, np.ndarray]:
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    m = ys * ys + xs * xs <= radius * radius
    return xs[m].astype(np.int32), ys[m].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _random_pairs(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(n, 2, 2))
    return np.clip(np.round(pts), -PATCH_RADIUS, PATCH_RADIUS).astype(np.float32)


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234, n_bits: int = N_BITS) -> np.ndarray:
    """(n_bits, 2, 2) float32 sampling-pair offsets.

    Default: the LEARNED pattern shipped with the package
    (``brief_pattern_learned.npy``, produced by :func:`learn_brief_pattern`
    — the rBRIEF greedy variance/decorrelation selection of the ORB paper
    run on kitti_sample patches; A/B measured against the random-Gaussian
    pattern in tests/test_real_descriptors.py).  Falls back to the
    fixed-seed Gaussian of the BRIEF paper when the file is absent or a
    non-default seed is requested."""
    if seed == 1234 and n_bits == N_BITS:
        import pathlib

        f = pathlib.Path(__file__).with_name("brief_pattern_learned.npy")
        if f.exists():
            pat = np.load(f)
            if pat.shape == (n_bits, 2, 2):
                return pat.astype(np.float32)
    return _random_pairs(seed, n_bits)


def learn_brief_pattern(
    grays,                       # iterable of (H, W) float images
    n_bits: int = N_BITS,
    n_candidates: int = 3072,
    n_kp_per_image: int = 512,
    corr_thresh: float = 0.2,
    seed: int = 7,
) -> np.ndarray:
    """rBRIEF pattern learning (ORB paper sec. 4.3, the procedure behind
    OpenCV's shipped table — re-run here on our own data rather than
    copying anyone's constants): candidate tests are scored over steered
    training patches; greedy selection keeps tests with bit-mean closest
    to 0.5 whose |correlation| with every kept test stays under a
    threshold, raised until ``n_bits`` survive."""
    from multimot_track_tpu.frontend import fast

    cand = _random_pairs(seed, n_candidates)
    bits = []
    for g in grays:
        img = jnp.asarray(g, jnp.float32)
        kp = fast.detect_pyramid(img, n_levels=4, n_total=n_kp_per_image)
        blur = gaussian_blur(img)
        ang = compute_orientations(blur, kp.uv)
        b = brief_descriptors(blur, kp.uv, ang, pattern=cand)  # (N, M) +-1
        bits.append(np.asarray(b)[np.asarray(kp.valid)])
    B = np.concatenate(bits, axis=0).astype(np.float32)        # (T, M)
    T = B.shape[0]
    mean = B.mean(0)                                           # in [-1, 1]
    order = np.argsort(np.abs(mean))                           # closest to 0 first
    Bc = B - mean                                              # centred
    norm = np.sqrt(np.maximum((Bc * Bc).sum(0), 1e-9))

    for thresh in np.arange(corr_thresh, 1.01, 0.05):
        picked = []
        for j in order:
            if not picked:
                picked.append(int(j))
                continue
            c = np.abs(Bc[:, picked].T @ Bc[:, j]) / (norm[picked] * norm[j])
            if c.max() < thresh:
                picked.append(int(j))
            if len(picked) == n_bits:
                break
        if len(picked) == n_bits:
            return cand[np.asarray(picked)]
    raise RuntimeError(
        f"could not select {n_bits} decorrelated tests from "
        f"{n_candidates} candidates over {T} patches"
    )


def compute_orientations(img_blur: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle (radians) per keypoint (..., 2) -> (...,)."""
    H, W = img_blur.shape
    dx, dy = _disc_offsets(PATCH_RADIUS)
    dx = jnp.asarray(dx)
    dy = jnp.asarray(dy)
    xi = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32)[..., None] + dx, 0, W - 1)
    yi = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32)[..., None] + dy, 0, H - 1)
    vals = img_blur[yi, xi]                          # (..., P)
    m10 = jnp.sum(vals * dx, axis=-1)
    m01 = jnp.sum(vals * dy, axis=-1)
    return jnp.arctan2(m01, m10)


def brief_descriptors(
    img_blur: jnp.ndarray,
    uv: jnp.ndarray,
    angle: jnp.ndarray,
    seed: int = 1234,
    pattern: np.ndarray = None,
) -> jnp.ndarray:
    """Steered BRIEF: (N, 2) keypoints -> (N, n_bits) int8 descriptors in
    {-1, +1} sign form.  ``pattern`` overrides the default table (used by
    the rBRIEF learner to evaluate candidate tests)."""
    H, W = img_blur.shape
    pat = jnp.asarray(brief_pattern(seed) if pattern is None else pattern)
    c, s = jnp.cos(angle), jnp.sin(angle)
    # rotate both sample points of every pair by the keypoint angle
    R = jnp.stack(
        [jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], axis=-2
    )  # (N, 2, 2)
    rot = jnp.einsum("nij,bpj->nbpi", R, pat)        # (N, 256, 2, 2[xy])
    pos = uv[:, None, None, :] + rot                 # (N, 256, 2, 2)
    xi = jnp.clip(jnp.round(pos[..., 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(pos[..., 1]).astype(jnp.int32), 0, H - 1)
    vals = img_blur[yi, xi]                          # (N, 256, 2)
    bit = vals[..., 0] < vals[..., 1]
    return jnp.where(bit, jnp.int8(1), jnp.int8(-1))


@functools.partial(jax.jit, static_argnames=("seed",))
def describe(img: jnp.ndarray, uv: jnp.ndarray, seed: int = 1234):
    """Blur + orient + describe in one jitted program.

    Returns (descriptors (N, 256) int8 sign-form, angles (N,) radians).
    """
    blur = gaussian_blur(img)
    ang = compute_orientations(blur, uv)
    desc = brief_descriptors(blur, uv, ang, seed=seed)
    return desc, ang
