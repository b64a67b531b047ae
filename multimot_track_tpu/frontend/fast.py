"""FAST-9 corner detection with grid-uniform top-k selection, pure jnp.

Batched replacement for the reference's ORBextractor keypoint stage
(src/ORBextractor.cc:1046-1137: 8-level pyramid, FAST-9 per 30px cell with
dual thresholds, octree spatial distribution).  Design deviations, per
SURVEY.md §7 "Hard parts":

* The octree ``DistributeOctTree`` is control-flow heavy; we keep its
  *intent* (spatial uniformity) with a static-shape equivalent: per-cell
  top-k candidates followed by a global top-n over candidates, preferring
  strong (>= ini_threshold) corners over weak (>= min_threshold) ones by
  score biasing.
* All 16 circle taps are expressed as rolls of the whole image -> one fused
  elementwise program over (H, W); no per-pixel control flow.

Descriptors (rBRIEF) are deliberately separate — the active reference
pipeline consumes keypoint *positions* only (flow supplies correspondence,
src/Tracking.cc:1190-1193).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (dx, dy), clockwise from 12 o'clock —
# the standard FAST-9/16 tap pattern.
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # contiguous run length for FAST-9


class Keypoints(NamedTuple):
    """Padded keypoint set in level-0 pixel coordinates."""

    uv: jnp.ndarray       # (N, 2) float32 (x, y)
    score: jnp.ndarray    # (N,) float32 corner response
    level: jnp.ndarray    # (N,) int32 pyramid level
    valid: jnp.ndarray    # (N,) bool


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9 corner response for every pixel of a (H, W) float image.

    Response = max over (bright, dark) of the sum of |tap - center| - t over
    the best contiguous arc's taps (OpenCV-like magnitude ordering).  Zero
    where the 9-contiguous test fails.  Border of 3 px is zeroed.
    """
    c = img
    taps = jnp.stack(
        [jnp.roll(img, shift=(-dy, -dx), axis=(0, 1)) for dx, dy in _CIRCLE], 0
    )  # taps[k][y, x] = img[y + dy_k, x + dx_k]
    diff = taps - c[None]
    bright = diff > threshold
    dark = diff < -threshold

    def arc_exists_and_score(flags, mag):
        # circular windows of length _ARC: window w covers taps w.._ARC-1+w
        flags2 = jnp.concatenate([flags, flags[: _ARC - 1]], axis=0).astype(jnp.float32)
        mag2 = jnp.concatenate([mag, mag[: _ARC - 1]], axis=0)
        # sliding all-true via cumulative sums
        cs = jnp.cumsum(flags2, axis=0)
        cs = jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)
        run = cs[_ARC:] - cs[:-_ARC]          # (16, H, W) count of true in window
        ok = run >= _ARC - 0.5
        csm = jnp.cumsum(mag2, axis=0)
        csm = jnp.concatenate([jnp.zeros_like(csm[:1]), csm], axis=0)
        wmag = csm[_ARC:] - csm[:-_ARC]
        wscore = jnp.where(ok, wmag, 0.0)
        return jnp.max(wscore, axis=0)

    mag = jnp.maximum(jnp.abs(diff) - threshold, 0.0)
    score = jnp.maximum(
        arc_exists_and_score(bright, mag), arc_exists_and_score(dark, mag)
    )
    # zero the 3px border (rolled taps wrap around)
    H, W = img.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inner = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return jnp.where(inner, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression."""
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= m, score, 0.0)


def _grid_topk(
    score: jnp.ndarray, cell: int, per_cell: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-cell top-k over a (H, W) score map.

    Returns (scores, flat_indices) of shape (n_cells * per_cell,).
    """
    H, W = score.shape
    ph = (-H) % cell
    pw = (-W) % cell
    s = jnp.pad(score, ((0, ph), (0, pw)))
    Hp, Wp = H + ph, W + pw
    nr, nc = Hp // cell, Wp // cell
    blocks = s.reshape(nr, cell, nc, cell).transpose(0, 2, 1, 3).reshape(nr * nc, cell * cell)
    top_s, top_i = jax.lax.top_k(blocks, per_cell)  # (ncells, per_cell)
    # convert in-block index -> global flat index in the padded image
    bi = jnp.arange(nr * nc, dtype=jnp.int32)
    by, bx = bi // nc, bi % nc
    iy = top_i // cell + (by * cell)[:, None]
    ix = top_i % cell + (bx * cell)[:, None]
    flat = iy * W + ix  # index into the UNPADDED image; padded hits have score 0
    return top_s.reshape(-1), flat.reshape(-1)


@functools.partial(
    jax.jit, static_argnames=("n_levels", "scale_factor", "n_total", "cell", "per_cell")
)
def detect_pyramid(
    img: jnp.ndarray,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    n_total: int = 4000,
    cell: int = 16,
    per_cell: int = 2,
) -> Keypoints:
    """Multi-scale FAST with uniform spatial distribution.

    Per level: resize (bilinear, like ORBextractor::ComputePyramid), score
    with the *low* threshold so weak-texture cells still yield corners, bias
    strong corners (>= threshold) by a large constant so they always win the
    global top-k — this emulates the reference's iniThFAST/minThFAST fallback
    (src/ORBextractor.cc FAST cell loop).
    """
    H, W = img.shape
    quota = _level_quotas(n_levels, scale_factor, n_total)
    all_uv, all_s, all_l, all_v = [], [], [], []
    for lvl in range(n_levels):
        scale = scale_factor ** lvl
        Hl, Wl = max(int(round(H / scale)), 16), max(int(round(W / scale)), 16)
        im_l = img if lvl == 0 else jax.image.resize(img, (Hl, Wl), "linear")
        score = nms3x3(fast_score_map(im_l, min_threshold))
        strong = fast_score_map(im_l, threshold) > 0
        biased = jnp.where(strong & (score > 0), score + 1e6, score)
        s, flat = _grid_topk(biased, cell, per_cell)
        k = quota[lvl]
        top_s, ti = jax.lax.top_k(s, min(k, s.shape[0]))
        flat_k = flat[ti]
        ys = (flat_k // Wl).astype(jnp.float32)
        xs = (flat_k % Wl).astype(jnp.float32)
        uv = jnp.stack([xs, ys], axis=-1) * scale  # back to level-0 coords
        all_uv.append(uv)
        all_s.append(jnp.where(top_s > 1e5, top_s - 1e6, top_s))
        all_l.append(jnp.full((uv.shape[0],), lvl, jnp.int32))
        all_v.append(top_s > 0)
    uv = jnp.concatenate(all_uv)
    sc = jnp.concatenate(all_s)
    lv = jnp.concatenate(all_l)
    va = jnp.concatenate(all_v)
    # pad/trim to exactly n_total
    n = uv.shape[0]
    if n < n_total:
        pad = n_total - n
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), uv.dtype)])
        sc = jnp.concatenate([sc, jnp.zeros((pad,), sc.dtype)])
        lv = jnp.concatenate([lv, jnp.zeros((pad,), lv.dtype)])
        va = jnp.concatenate([va, jnp.zeros((pad,), va.dtype)])
    else:
        uv, sc, lv, va = uv[:n_total], sc[:n_total], lv[:n_total], va[:n_total]
    return Keypoints(uv=uv, score=sc, level=lv, valid=va)


def _level_quotas(n_levels: int, scale_factor: float, n_total: int):
    """Distribute n_total across levels by inverse scale, like
    ORBextractor's mnFeaturesPerLevel computation."""
    inv = 1.0 / scale_factor
    raw = [inv ** i for i in range(n_levels)]
    s = sum(raw)
    quota = [max(16, int(round(n_total * r / s))) for r in raw]
    return quota
