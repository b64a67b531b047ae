"""Fused per-frame refinement: TrackLocalMap + trailing-window BA chained
onto ``tracker.full_step``'s packed output as ONE additional device program.

In live serving, each blocking device->host fetch is a synchronisation
point on the host's critical path.  The unfused loop pays up to
four per steady-state frame (full_step result fetch, ctx pose fetch,
TrackLocalMap fetch, window-BA fetch — reference counterparts
src/Tracking.cc:3189 TrackLocalMap and src/LocalMapping.cc:48's
continuous local BA, which the reference hides in CPU threads).  Here the
refinement chain consumes the *device handles* of the not-yet-fetched
full_step output, applies the acceptance gates with ``jnp.where`` on
device, and returns ``concat(full_step_packed, refine_fields)`` so the
host blocks exactly once per frame.

The state-machine decisions (LOST ladder, keyframe insertion, loop
closing) stay host-side: the host reads the same gates from the fetched
vector and simply ignores the refined fields when it would have skipped
the refinement (a LOST frame's speculative refinement is discarded
wholesale, matching the unfused control flow).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from multimot_track_tpu.config import PipelineConfig
from multimot_track_tpu.geometry import se3
from multimot_track_tpu.pipeline import tracker, window_refine
from multimot_track_tpu.pipeline.keyframes import local_map_refine


@functools.lru_cache(maxsize=8)
def packed_offsets(cfg: PipelineConfig):
    """Flat-vector offset of every leaf of the packed PairResult
    (tracker.pack_pytree order), keyed by its pytree key-path string."""
    spec = tracker.light_result_spec(cfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(spec)
    offs = {}
    off = 0
    for path, leaf in leaves:
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        offs[jax.tree_util.keystr(path)] = (off, leaf.shape)
        off += n
    return offs, off


def _lookup(offs, name):
    for k, v in offs.items():
        if k.endswith(name):
            return v
    raise KeyError(name)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "use_lm", "use_win", "min_inliers"),
)
def live_refine_step(
    packed,            # full_step packed output — device handle, NOT fetched
    uv, desc, valid, z,         # current-frame keyframe-grade features
    Xw_m, desc_m, valid_m,      # stacked local map (keyframes.local_map)
    poses_rel_prev,    # (W-1, 4, 4) window poses rel. frame 0 (host-known)
    Twc0,              # (4, 4) window anchor world pose (inv of frame-0 Tcw)
    grays, depth0, flows, sems,  # window wire tensors (device-resident)
    corr,              # (4, 4) cumulative right-factor mapping the raw
    #                    device odometry chain into the recorded world
    #                    frame (identity in synchronous mode; pipelined
    #                    mode's host corrections never touch the chain)
    cfg: PipelineConfig,
    use_lm: bool,
    use_win: bool,
    min_inliers: int,
):
    """Returns ``concat(packed, T1(16), accept_lm, n_lm, poses_out(W*16),
    n_live)`` as one float32 vector (one device->host transfer).  T1 and
    poses_out are in the RECORDED world frame (corr applied)."""
    offs, _ = packed_offsets(cfg)
    off_T, _ = _lookup(offs, ".Tcw_cur")
    off_ninl, _ = _lookup(offs, ".n_static_inliers")
    cam, be = cfg.camera, cfg.backend

    T_flow = (
        jax.lax.dynamic_slice(packed, (off_T,), (16,)).reshape(4, 4) @ corr
    )
    n_inl_flow = packed[off_ninl].astype(jnp.int32)
    ok = n_inl_flow >= min_inliers

    T1 = T_flow
    accept_lm = jnp.zeros((), bool)
    n_lm = jnp.zeros((), jnp.int32)
    if use_lm:
        T_lm, n_lm, _ = local_map_refine(
            T_flow, Xw_m, desc_m, valid_m, uv, desc, valid, z,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf,
            radius=be.local_map_radius_px, thresh=be.local_map_thresh_px,
        )
        # acceptance gates of system._track_local_map, applied on device
        d = T_lm @ se3.inverse(T_flow)
        t_norm = jnp.linalg.norm(d[:3, 3])
        ang = jnp.degrees(
            jnp.arccos(jnp.clip((jnp.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
        )
        accept_lm = (
            ok
            & (n_lm >= be.local_map_min_inliers)
            & jnp.isfinite(T_lm).all()
            & (t_norm <= be.local_map_max_corr_m)
            & (ang <= be.local_map_max_rot_deg)
        )
        T1 = jnp.where(accept_lm, T_lm, T_flow)

    if use_win:
        poses_rel = jnp.concatenate(
            [poses_rel_prev, (T1 @ Twc0)[None]], axis=0
        )
        poses_out, n_live = window_refine.refine_trailing_window(
            poses_rel, grays, depth0, flows, sems, cfg
        )
    else:
        poses_out = jnp.zeros((0, 4, 4), jnp.float32)
        n_live = jnp.zeros((), jnp.int32)

    f32 = jnp.float32
    return jnp.concatenate(
        [
            packed,
            T1.astype(f32).reshape(-1),
            accept_lm.astype(f32)[None],
            n_lm.astype(f32)[None],
            poses_out.astype(f32).reshape(-1),
            n_live.astype(f32)[None],
        ]
    )


def split_refined(flat: np.ndarray, cfg: PipelineConfig, window: int):
    """Host-side inverse of ``live_refine_step``'s concat: returns
    ``(packed, T1, accept_lm, n_lm, poses_out, n_live)``."""
    _, n_packed = packed_offsets(cfg)
    flat = np.asarray(flat)
    packed = flat[:n_packed]
    off = n_packed
    T1 = flat[off : off + 16].reshape(4, 4).astype(np.float32)
    off += 16
    accept_lm = bool(flat[off] > 0.5)
    n_lm = int(flat[off + 1])
    off += 2
    poses_out = (
        flat[off : off + window * 16].reshape(window, 4, 4).astype(np.float32)
        if window
        else np.zeros((0, 4, 4), np.float32)
    )
    off += window * 16
    n_live = int(flat[off])
    return packed, T1, accept_lm, n_lm, poses_out, n_live
