"""Descriptor matching as dense matmuls.

Batched re-design of the reference ORBmatcher (src/ORBmatcher.cc): instead of
per-keypoint radius searches over grid cells with popcount loops
(``DescriptorDistance``, ``SearchByProjection``, ``ProjMatching``
src/ORBmatcher.cc:55-416), the whole N x M problem is one (bf16) matmul:

  hamming(a, b) = (256 - s_a . s_b) / 2   for sign-form descriptors

Spatial gating (the radius search), threshold gates (TH_LOW/TH_HIGH),
best/second ratio and rotation-consistency checks are all elementwise masks
over the (N, M) distance matrix — fused by XLA around the matmul.  At the
reference's scales (4000 x 4000 x 256 = 4 G MACs) one matmul is far below
a millisecond on an accelerator; no grid-cell indexing structures are
needed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

TH_LOW = 50        # reference ORBmatcher::TH_LOW (best-match gate)
TH_HIGH = 100      # reference ORBmatcher::TH_HIGH
HISTO_BINS = 30    # rotation-consistency histogram bins (HISTO_LENGTH)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) x (M, 256) sign-form int8 -> (N, M) float32 Hamming distances.

    bf16 accumulation is exact here: every product is +-1 and the true
    result is an integer in [0, 256], well inside bf16's integer range —
    but we accumulate in f32 anyway (preferred_element_type) and let the
    matrix unit take bf16 inputs.
    """
    a = desc_a.astype(jnp.bfloat16)
    b = desc_b.astype(jnp.bfloat16)
    dots = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    n_bits = desc_a.shape[-1]
    return (n_bits - dots) * 0.5


class MatchResult(NamedTuple):
    idx: jnp.ndarray       # (N,) best match in B for each A (int32)
    dist: jnp.ndarray      # (N,) its Hamming distance
    valid: jnp.ndarray     # (N,) passed all gates


@functools.partial(jax.jit, static_argnames=("mutual", "threshold", "ratio"))
def match_descriptors(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    threshold: float = TH_LOW,
    ratio: float = 0.9,
    mutual: bool = True,
) -> MatchResult:
    """Brute-force matching with the reference's gates: distance threshold,
    best/second-best ratio (mfNNratio, ORBmatcher ctor default 0.9 in
    ProjMatching usage) and optional mutual-nearest check."""
    D = hamming_matrix(desc_a, desc_b)
    big = jnp.float32(1e9)
    D = jnp.where(valid_b[None, :], D, big)
    D = jnp.where(valid_a[:, None], D, big)

    neg = -D
    top2, top2_idx = jax.lax.top_k(neg, 2)           # (N, 2) largest of -D
    best = -top2[:, 0]
    second = -top2[:, 1]
    idx = top2_idx[:, 0]

    ok = valid_a & (best <= threshold) & (best < ratio * second)
    if mutual:
        best_for_b = jnp.argmin(D, axis=0)           # (M,)
        ok = ok & (best_for_b[idx] == jnp.arange(D.shape[0]))
    return MatchResult(idx=idx.astype(jnp.int32), dist=best, valid=ok)


@functools.partial(jax.jit, static_argnames=("threshold", "ratio"))
def match_projected(
    desc_a: jnp.ndarray,
    uv_pred: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    uv_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    radius: float = 15.0,
    threshold: float = TH_HIGH,
    ratio: float = 0.9,
) -> MatchResult:
    """Projection-guided matching (ORBmatcher::ProjMatching /
    SearchByProjection): candidate B keypoints must lie within ``radius``
    pixels of A's predicted position ``uv_pred``."""
    D = hamming_matrix(desc_a, desc_b)
    d2 = jnp.sum(
        (uv_pred[:, None, :] - uv_b[None, :, :]) ** 2, axis=-1
    )
    big = jnp.float32(1e9)
    D = jnp.where(
        valid_a[:, None] & valid_b[None, :] & (d2 <= radius * radius), D, big
    )
    neg = -D
    top2, top2_idx = jax.lax.top_k(neg, 2)
    best = -top2[:, 0]
    second = -top2[:, 1]
    idx = top2_idx[:, 0]
    ok = valid_a & (best <= threshold) & (best < ratio * second)
    return MatchResult(idx=idx.astype(jnp.int32), dist=best, valid=ok)


@functools.partial(jax.jit, static_argnames=("mutual", "ratio"))
def match_float(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    ratio: float = 0.8,
    mutual: bool = True,
) -> MatchResult:
    """Float-descriptor matching (SIFT): distance = 2 - 2 a.b for unit
    vectors, Lowe ratio test — the role of cudasift's MatchSiftData /
    FindMaxCorr kernels (src/cudasift/matching.cu), as one matmul."""
    dots = jax.lax.dot_general(
        desc_a, desc_b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    D = 2.0 - 2.0 * dots
    big = jnp.float32(1e9)
    D = jnp.where(valid_a[:, None] & valid_b[None, :], D, big)
    top2, top2_idx = jax.lax.top_k(-D, 2)
    best = -top2[:, 0]
    second = -top2[:, 1]
    idx = top2_idx[:, 0]
    ok = valid_a & (best < ratio * ratio * second) & (best < 4.0)
    if mutual:
        best_for_b = jnp.argmin(D, axis=0)
        ok = ok & (best_for_b[idx] == jnp.arange(D.shape[0]))
    return MatchResult(idx=idx.astype(jnp.int32), dist=best, valid=ok)


@functools.partial(jax.jit, static_argnames=())
def search_by_quad(
    desc_L0: jnp.ndarray, desc_R0: jnp.ndarray,
    desc_L1: jnp.ndarray, desc_R1: jnp.ndarray,
    uv_pred: jnp.ndarray, uv_L1: jnp.ndarray,
    valid0: jnp.ndarray, valid1: jnp.ndarray,
    radius: float = 15.0,
    threshold: float = TH_HIGH,
) -> MatchResult:
    """Quad-consistent stereo-temporal matching (ORBmatcher::SearchByQuad,
    src/ORBmatcher.cc:1704-1842): a temporal match survives only if the
    SAME pairing is descriptor-consistent in all four views.  desc_R* are
    the right-view descriptors sampled at each left keypoint's disparity
    position (the role of the reference's vDescIndex L/R association).

    The quad criterion becomes one fused mask over the (N, M) matrix:
    D_quad = D_L + D_R, gated spatially, both legs under the threshold.
    """
    DL = hamming_matrix(desc_L0, desc_L1)
    DR = hamming_matrix(desc_R0, desc_R1)
    d2 = jnp.sum((uv_pred[:, None, :] - uv_L1[None, :, :]) ** 2, axis=-1)
    big = jnp.float32(1e9)
    ok = (
        valid0[:, None]
        & valid1[None, :]
        & (d2 <= radius * radius)
        & (DL <= threshold)
        & (DR <= threshold)
    )
    D = jnp.where(ok, DL + DR, big)
    top2, top2_idx = jax.lax.top_k(-D, 2)
    best = -top2[:, 0]
    second = -top2[:, 1]
    idx = top2_idx[:, 0]
    okm = valid0 & (best < big * 0.5) & (best < 0.9 * second)
    return MatchResult(idx=idx.astype(jnp.int32), dist=best, valid=okm)


def rotation_consistency(
    angle_a: jnp.ndarray,
    angle_b: jnp.ndarray,
    idx: jnp.ndarray,
    valid: jnp.ndarray,
    keep_bins: int = 3,
) -> jnp.ndarray:
    """The reference's rotation-histogram filter (ORBmatcher rotHist,
    src/ORBmatcher.cc:1792-1840): keep only matches whose angle difference
    falls in the ``keep_bins`` most popular of 30 bins."""
    drot = angle_a - angle_b[idx]
    dega = jnp.degrees(drot) % 360.0
    bins = jnp.clip((dega * (HISTO_BINS / 360.0)).astype(jnp.int32), 0, HISTO_BINS - 1)
    hist = jnp.zeros(HISTO_BINS, jnp.int32).at[bins].add(valid.astype(jnp.int32))
    top_counts, top_bins = jax.lax.top_k(hist, keep_bins)
    # secondary bins only survive at >= 10% of the max bin (ComputeThreeMaxima)
    strong = top_counts.astype(jnp.float32) >= 0.1 * top_counts[0].astype(jnp.float32)
    in_top = jnp.any(
        (bins[:, None] == top_bins[None, :]) & strong[None, :], axis=1
    )
    return valid & in_top
