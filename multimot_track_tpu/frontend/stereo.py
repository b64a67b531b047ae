"""Stereo depth: dense block-matching disparity + keypoint refinement.

The reference's stereo path (``GrabImageStereo`` src/Tracking.cc:256, stereo
Frame ctor src/Frame.cc:79 with dual-thread ORB and
``ComputeStereoMatches`` src/Frame.cc:854-1035: scanline descriptor search
+ SAD subpixel) produces per-*keypoint* depth.  The batched pipeline's frontend
consumes a dense depth image (dense object sampling, src/Frame.cc:188), so
the native design computes a *dense* disparity map instead:

  cost volume via shifted absolute differences, box-filtered (separable
  running sums — elementwise work), scanned over disparities with a running
  argmin and 3-point parabola sub-pixel refinement.  No per-pixel control
  flow; one ``lax.scan`` over the disparity axis keeps memory at a few
  (H, W) buffers.

``disparity_to_depth_raw`` emits the same uint16-style disparity*256
encoding the KITTI RGB-D loader consumes, so the whole RGB-D pipeline runs
unchanged on stereo input — the reference needs a separate driver for this
(Examples/Stereo/stereo_kitti.cc).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _box_filter(img: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Separable box sum with edge clamping via cumulative sums."""
    for axis in (0, 1):
        cs = jnp.cumsum(img, axis=axis)
        n = img.shape[axis]
        idx_hi = jnp.clip(jnp.arange(n) + radius, 0, n - 1)
        idx_lo = jnp.arange(n) - radius - 1
        hi = jnp.take(cs, idx_hi, axis=axis)
        lo = jnp.where(
            (idx_lo >= 0).reshape([-1 if a == axis else 1 for a in range(img.ndim)]),
            jnp.take(cs, jnp.clip(idx_lo, 0, n - 1), axis=axis),
            0.0,
        )
        img = hi - lo
    return img


@functools.partial(jax.jit, static_argnames=("max_disp", "radius"))
def dense_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    max_disp: int = 128,
    radius: int = 4,
    uniqueness: float = 0.95,
) -> jnp.ndarray:
    """(H, W) float32 disparity; invalid pixels get 0.

    SAD block matching with winner-takes-all + parabola subpixel + a
    uniqueness check (best must beat runner-up by the given ratio), the
    role the reference's bestDist/thOrbDist gates play in
    ComputeStereoMatches.
    """
    H, W = left.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)

    def cost_at(d):
        shifted = jnp.roll(right, d, axis=1)
        ad = jnp.abs(left - shifted)
        c = _box_filter(ad, radius)
        # invalid where the shifted image wrapped around
        return jnp.where(cols >= d, c, jnp.inf)

    def scan_body(carry, d):
        best, second, bestd = carry
        c = cost_at(d)
        is_best = c < best
        second = jnp.where(is_best, best, jnp.minimum(second, c))
        best = jnp.where(is_best, c, best)
        bestd = jnp.where(is_best, d, bestd)
        # emit the cost slice (bf16) for the later sub-pixel gather
        return (best, second, bestd), c.astype(jnp.bfloat16)

    init = (
        jnp.full((H, W), jnp.inf),
        jnp.full((H, W), jnp.inf),
        jnp.zeros((H, W), jnp.int32),
    )
    ds = jnp.arange(max_disp, dtype=jnp.int32)
    (best, second, bestd), costs = jax.lax.scan(scan_body, init, ds)
    costs = costs.astype(jnp.float32)

    # subpixel: gather cost at d-1, d, d+1 from the stacked volume
    dm = jnp.clip(bestd - 1, 0, max_disp - 1)
    dp = jnp.clip(bestd + 1, 0, max_disp - 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    c0 = costs[bestd, rows, cols]
    cm = costs[dm, rows, cols]
    cp = costs[dp, rows, cols]
    denom = cm + cp - 2.0 * c0
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (cm - cp) / denom, 0.0)
    disp = bestd.astype(jnp.float32) + jnp.clip(delta, -1.0, 1.0)

    ok = (
        jnp.isfinite(best)
        & (best <= uniqueness * second)
        & (bestd > 0)
        & (bestd < max_disp - 1)
    )
    disp = jnp.where(ok, disp, 0.0)

    # left-right consistency: re-match from the right image; disparities
    # that disagree by > 1 px are occlusions/mismatches (the role of the
    # reference's bestDist gates + the L/R agreement SearchByQuad enforces)
    def cost_at_r(d):
        shifted = jnp.roll(left, -d, axis=1)
        ad = jnp.abs(right - shifted)
        c = _box_filter(ad, radius)
        return jnp.where(cols < W - d, c, jnp.inf)

    def scan_r(carry, d):
        best_r, bestd_r = carry
        c = cost_at_r(d)
        is_b = c < best_r
        return (jnp.where(is_b, c, best_r), jnp.where(is_b, d, bestd_r)), None

    (_, bestd_r), _ = jax.lax.scan(
        scan_r, (jnp.full((H, W), jnp.inf), jnp.zeros((H, W), jnp.int32)), ds
    )
    # for left pixel x with disparity d, the right-image match at x-d must
    # carry (approximately) the same disparity
    xr = jnp.clip(cols - jnp.round(disp).astype(jnp.int32), 0, W - 1)
    d_back = jnp.take_along_axis(bestd_r, xr, axis=1).astype(jnp.float32)
    consistent = jnp.abs(d_back - disp) <= 1.0
    return jnp.where(consistent, disp, 0.0)


def disparity_to_depth_raw(disp: jnp.ndarray) -> jnp.ndarray:
    """Dense disparity -> the loader's raw png encoding (value = disp*256,
    src/Tracking.cc:447-456 consumes depth = bf/(raw/256))."""
    return jnp.where(disp > 0, disp * 256.0, 0.0)


@functools.partial(jax.jit, static_argnames=("max_disp", "radius"))
def keypoint_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    uv: jnp.ndarray,          # (N, 2) keypoints in the left image
    max_disp: int = 128,
    radius: int = 5,
):
    """Per-keypoint scanline SAD search + parabola subpixel — the direct
    analog of ComputeStereoMatches for sparse use.  Returns (disp, valid)."""
    H, W = left.shape
    xi = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    dy, dx = jnp.mgrid[-radius : radius + 1, -radius : radius + 1]
    py = jnp.clip(yi[:, None, None] + dy, 0, H - 1)          # (N, P, P)
    px_l = jnp.clip(xi[:, None, None] + dx, 0, W - 1)
    patch_l = left[py, px_l]                                  # (N, P, P)

    def cost_of(d):
        px_r = jnp.clip(px_l - d, 0, W - 1)
        patch_r = right[py, px_r]
        return jnp.sum(jnp.abs(patch_l - patch_r), axis=(1, 2))

    costs = jax.vmap(cost_of)(jnp.arange(max_disp))           # (D, N)
    best = jnp.argmin(costs, axis=0)
    c0 = jnp.take_along_axis(costs, best[None], axis=0)[0]
    cm = jnp.take_along_axis(costs, jnp.clip(best - 1, 0, max_disp - 1)[None], 0)[0]
    cp = jnp.take_along_axis(costs, jnp.clip(best + 1, 0, max_disp - 1)[None], 0)[0]
    denom = cm + cp - 2.0 * c0
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (cm - cp) / denom, 0.0)
    disp = best.astype(jnp.float32) + jnp.clip(delta, -1.0, 1.0)
    valid = (best > 0) & (best < max_disp - 1) & (xi - best >= 0)
    return disp, valid


@functools.partial(jax.jit, static_argnames=("n_kp",))
def quad_temporal_matches(
    gray_L0: jnp.ndarray, gray_R0: jnp.ndarray,
    gray_L1: jnp.ndarray, gray_R1: jnp.ndarray,
    disp0: jnp.ndarray, disp1: jnp.ndarray,
    flow0: jnp.ndarray,
    n_kp: int = 512,
    radius: float = 15.0,
):
    """Quad-consistent stereo-temporal matching, end to end on device.

    The reference's stereo frames carry a per-keypoint L/R descriptor
    association (``vDescIndex``, src/Frame.cc:854-1035) that
    ``ORBmatcher::SearchByQuad`` (src/ORBmatcher.cc:1704-1842) consumes:
    a temporal match must be descriptor-consistent in last-L, last-R,
    cur-L AND cur-R.  Batched shape: FAST on each left view; ORB descriptors
    on the left keypoints and on their disparity-shifted right positions
    (the vDescIndex association); flow predicts the temporal search
    centre; ops.matching.search_by_quad fuses the four-view criterion.

    Returns (uv0, uv1, valid): matched current positions per last-frame
    keypoint slot.
    """
    from multimot_track_tpu.frontend import fast, orb
    from multimot_track_tpu.geometry import camera as cam_g
    from multimot_track_tpu.ops import matching

    kp0 = fast.detect_pyramid(gray_L0, n_levels=4, n_total=n_kp)
    kp1 = fast.detect_pyramid(gray_L1, n_levels=4, n_total=n_kp)
    d0, in0 = cam_g.nearest_sample(disp0, kp0.uv)
    d1, in1 = cam_g.nearest_sample(disp1, kp1.uv)
    uvR0 = kp0.uv - jnp.stack([d0, jnp.zeros_like(d0)], -1)
    uvR1 = kp1.uv - jnp.stack([d1, jnp.zeros_like(d1)], -1)
    descL0, _ = orb.describe(gray_L0, kp0.uv)
    descR0, _ = orb.describe(gray_R0, uvR0)
    descL1, _ = orb.describe(gray_L1, kp1.uv)
    descR1, _ = orb.describe(gray_R1, uvR1)
    f0, _ = cam_g.nearest_sample(flow0[..., 0], kp0.uv)
    f0y, _ = cam_g.nearest_sample(flow0[..., 1], kp0.uv)
    uv_pred = kp0.uv + jnp.stack([f0, f0y], -1)
    valid0 = kp0.valid & in0 & (d0 > 0) & (uvR0[:, 0] >= 0)
    valid1 = kp1.valid & in1 & (d1 > 0) & (uvR1[:, 0] >= 0)
    res = matching.search_by_quad(
        descL0, descR0, descL1, descR1, uv_pred, kp1.uv, valid0, valid1,
        radius=radius,
    )
    return kp0.uv, kp1.uv[res.idx], res.valid
