"""Mask-free object discovery: motion segmentation from geometry alone.

The reference *requires* precomputed instance masks (its dense object
sampling is keyed off maskSEM, src/Frame.cc:188).  Its dormant gco path
(src/Tracking.cc:4445-4836) was meant to lift that requirement; this
module completes that intent with the batched MRF (ops/graphcut):

  1. sample a coarse grid with valid depth in both frames,
  2. flag dynamic candidates by 3-D scene-flow residual against the ego
     motion (the active heuristic's 0.12 m gate, Tracking.cc:1463),
  3. fit rigid-motion hypotheses from candidate neighbourhoods
     (GetMSS/GetModel role) with the ego motion as the static label,
  4. solve the multi-label MRF -> per-point motion labels,
  5. rasterise labels into a synthetic instance mask the standard
     pipeline consumes in place of ground-truth masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera, se3
from multimot_track_tpu.ops import graphcut


class DiscoveredObjects(NamedTuple):
    uv: jnp.ndarray        # (N, 2) grid points (last frame)
    uv_cur: jnp.ndarray    # (N, 2) flow-shifted positions (current frame)
    labels: jnp.ndarray    # (N,) 0 = static/ego, k >= 1 motion cluster
    valid: jnp.ndarray     # (N,)
    energy: jnp.ndarray


def _discovery_problem(
    key: jax.Array,
    depth0: jnp.ndarray,     # (H, W) metric depth, frame k-1
    depth1: jnp.ndarray,     # (H, W) metric depth, frame k
    flow: jnp.ndarray,       # (H, W, 2) flow k-1 -> k
    T_rel: jnp.ndarray,      # (4, 4) ego motion (cam_{k-1} -> cam_k)
    fx, fy, cx, cy,
    step: int = 8,
    n_max: int = 1024,
    n_hyp: int = 24,
    sf_thres: float = 0.12,
    max_depth: float = 40.0,
    sf_depth_coeff: float = 0.002,
):
    """Everything up to (but excluding) the MRF labeling: candidate
    extraction, hypothesis sampling, data costs, smoothness graph.
    Returns (c_uv0, c_uv1, D, graph, mask)."""
    H, W = depth0.shape
    gi = jnp.arange(0, H, step)
    gj = jnp.arange(0, W, step)
    yy, xx = jnp.meshgrid(gi, gj, indexing="ij")
    uv0 = jnp.stack([xx, yy], -1).reshape(-1, 2).astype(jnp.float32)
    d0 = depth0[yy, xx].reshape(-1)
    fl = flow[yy, xx].reshape(-1, 2)
    uv1 = uv0 + fl
    d1, inb = camera.nearest_sample(depth1, uv1)
    ok = (d0 > 0) & (d0 < max_depth) & inb & (d1 > 0) & (d1 < max_depth)

    X0 = camera.backproject(uv0, d0, fx, fy, cx, cy)     # last-cam frame
    X1 = camera.backproject(uv1, d1, fx, fy, cx, cy)     # cur-cam frame
    X1_pred = se3.transform(T_rel, X0)
    resid = jnp.linalg.norm(X1 - X1_pred, axis=-1)
    # depth-adaptive gate: disparity noise alone moves far points by
    # ~z^2/bf * delta_d metres, which would flood (and overflow) the
    # candidate set with far-background false positives, displacing real
    # movers in the fixed n_max slots
    dynamic = ok & (resid > sf_thres + sf_depth_coeff * d0 * d0)

    # compact dynamic candidates into n_max slots
    slots = jnp.cumsum(dynamic.astype(jnp.int32)) - 1
    tgt = jnp.where(dynamic, slots, n_max)
    n_dyn = jnp.sum(dynamic.astype(jnp.int32))
    mask = jnp.arange(n_max) < n_dyn

    def take(arr, fill=0.0):
        out = jnp.full((n_max,) + arr.shape[1:], fill, arr.dtype)
        return out.at[tgt].set(arr, mode="drop")

    c_uv0 = take(uv0)
    c_uv1 = take(uv1)
    c_X0 = take(X0)
    c_X1 = take(X1)

    graph = graphcut.build_knn_graph(c_uv1, mask, k=6)
    hyp = graphcut.sample_motion_hypotheses(key, graph, c_X0, c_X1, n_hyp=n_hyp)
    # label 0 is the ego/static motion; duplicate hypotheses are suppressed
    hyps = jnp.concatenate([T_rel[None], hyp], axis=0)
    keep = graphcut.dedupe_hypotheses(hyps)
    D = graphcut.data_costs(hyps, c_X0, c_uv1, fx, fy, cx, cy)
    D = jnp.where(keep[None, :], D, 1e9)
    return c_uv0, c_uv1, D, graph, mask


@functools.partial(jax.jit, static_argnames=("step", "n_max", "n_hyp"))
def discover_objects(
    key: jax.Array,
    depth0: jnp.ndarray,
    depth1: jnp.ndarray,
    flow: jnp.ndarray,
    T_rel: jnp.ndarray,
    fx, fy, cx, cy,
    step: int = 8,
    n_max: int = 1024,
    n_hyp: int = 24,
    sf_thres: float = 0.12,
    max_depth: float = 40.0,
    sf_depth_coeff: float = 0.002,
) -> DiscoveredObjects:
    c_uv0, c_uv1, D, graph, mask = _discovery_problem(
        key, depth0, depth1, flow, T_rel, fx, fy, cx, cy,
        step=step, n_max=n_max, n_hyp=n_hyp, sf_thres=sf_thres,
        max_depth=max_depth, sf_depth_coeff=sf_depth_coeff,
    )
    labels, energy = graphcut.segment(D, graph)
    return DiscoveredObjects(
        uv=c_uv0, uv_cur=c_uv1, labels=labels, valid=mask, energy=energy
    )


_discovery_problem_jit = functools.partial(
    jax.jit, static_argnames=("step", "n_max", "n_hyp")
)(_discovery_problem)


def discover_objects_exact(
    key: jax.Array,
    depth0, depth1, flow, T_rel, fx, fy, cx, cy,
    step: int = 8, n_max: int = 1024, n_hyp: int = 24,
    sf_thres: float = 0.12, max_depth: float = 40.0,
    sf_depth_coeff: float = 0.002,
) -> DiscoveredObjects:
    """Discovery with the EXACT native alpha-expansion labeler
    (ops/graphcut.segment_exact over native/graphcut.cc) instead of the
    on-device relaxation — the integration the reference sketched for gco
    and never finished (src/Tracking.cc:4635-4836).  The problem
    construction stays one jitted device program; only the labeling runs
    on the host, so this is the offline-quality option (the jitted
    ``discover_objects`` remains the production path)."""
    import numpy as np

    c_uv0, c_uv1, D, graph, mask = _discovery_problem_jit(
        key, depth0, depth1, flow, T_rel, fx, fy, cx, cy,
        step=step, n_max=n_max, n_hyp=n_hyp, sf_thres=sf_thres,
        max_depth=max_depth, sf_depth_coeff=sf_depth_coeff,
    )
    labels, energy = graphcut.segment_exact(np.asarray(D), graph)
    return DiscoveredObjects(
        uv=c_uv0, uv_cur=c_uv1, labels=jnp.asarray(labels), valid=mask,
        energy=jnp.asarray(energy, jnp.float32),
    )


def rasterize_labels(
    disc: DiscoveredObjects, height: int, width: int, step: int = 8
) -> jnp.ndarray:
    """Paint discovered labels into an instance-mask image (each grid point
    fills its step x step cell); label 0 (ego) stays background."""
    return rasterize_labels_at(
        disc.uv, disc.labels, disc.valid, height, width, step
    )


def rasterize_labels_at(
    uv: jnp.ndarray,        # (N, 2) positions to paint (any frame)
    labels: jnp.ndarray,    # (N,)
    valid: jnp.ndarray,     # (N,)
    height: int, width: int, step: int = 8,
) -> jnp.ndarray:
    """Rasterize labels at arbitrary positions — e.g. at the flow-shifted
    points ``uv0 + flow`` to produce the *current* frame's mask from a
    discovery run on the previous frame."""
    img = jnp.zeros((height // step + 1, width // step + 1), jnp.int32)
    xi = jnp.round(uv[:, 0] / step).astype(jnp.int32)
    yi = jnp.round(uv[:, 1] / step).astype(jnp.int32)
    lab = jnp.where(valid & (labels > 0), labels, 0)
    img = img.at[yi, xi].max(lab.astype(jnp.int32), mode="drop")
    big = jnp.repeat(jnp.repeat(img, step, axis=0), step, axis=1)
    return big[:height, :width]
