"""Batched sequence tracking — the high-throughput mode.

The online mode (system.py) steps frame-by-frame like the reference.  This
mode exploits the structure SURVEY.md §2.5 points at: expressed in the
*last camera frame* (Twl = I), every pair's solves are independent, so a
whole sequence tracks as

  1. frontend over all frames (one vmapped program over stacked images),
  2. all pairs solved simultaneously (vmap over the pair axis — which is
     also the mesh's "pair" sharding axis for multi-chip),
  3. trajectory composed with an associative scan,
  4. world-frame object motions/metrics + track IDs recovered in a cheap
     host post-pass.

Differences vs the online mode (documented): object initialisation cannot
use the previous pair's motion model (that coupling is sequential), so it
is pure RANSAC — on kitti_sample this changes results marginally.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from multimot_track_tpu.config import DEFAULT_CONFIG, PipelineConfig
from multimot_track_tpu.geometry import se3
from multimot_track_tpu.pipeline import frames as F
from multimot_track_tpu.pipeline import tracker
from multimot_track_tpu.eval import metrics


from multimot_track_tpu.ops.wire import (  # noqa: F401  (re-exported API)
    _decode_flow, _decode_sem, _decode_depth,
    pack_flow12, unpack_flow12, pack_flow12_half, unpack_flow12_half,
    pack_depth12, unpack_depth12, pack_sem4, unpack_sem4,
)


@functools.partial(jax.jit, static_argnames=("cfg",))
def frontend_batch(gray_u8, depth_u16, flow_i16, sem_u8, gts, cfg: PipelineConfig):
    """Stacked images (F, H, W[, 2]) -> stacked FrameObservations.

    ``lax.map`` rather than ``vmap``: a sequential device loop of
    per-frame programs keeps the frontend's image gathers/top-k in their
    single-frame lowering; the frontend runs once per sequence chunk."""

    W = cfg.camera.width

    H = cfg.camera.height

    def one(args):
        g, d, fl, s, gt = args
        return F.build_frame_observation(
            g.astype(jnp.float32),
            _decode_depth(d, W),
            _decode_flow(fl, H, W),
            _decode_sem(s, W),
            gt,
            cfg,
        )

    return jax.lax.map(one, (gray_u8, depth_u16, flow_i16, sem_u8, gts))


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_pairs(keys, prev_obs, cur_gray_u8, cur_depth_u16, cur_sem_u8, gt_cur,
                cfg: PipelineConfig):
    """Solve a batch of pre-paired frames in last-camera coordinates.

    Every argument's leading axis is the pair batch B — this is the axis the
    device mesh shards ("pair"/"host", parallel/multihost.py); XLA partitions
    the whole frontend+solver program with no cross-pair communication.
    Returns the stacked PairResult (B, ...) with Tcw_cur = per-pair relative
    motion T_rel (frame k-1 camera -> frame k camera).
    """
    K = cfg.padding.k_obj_max
    eye = jnp.eye(4)
    ctx = tracker.initial_context(K)

    def one_pair(key, prev, cur_gray, cur_depth, cur_sem, gt):
        # anchor GT to the pair's own last-camera frame so device-side
        # object metrics compare motions in commensurate worlds
        G = se3.inverse(prev.gt.Tcw)           # Twc_gt_last
        gt_cur_rel = gt._replace(Tcw=gt.Tcw @ G)
        prev_rel = prev._replace(gt=prev.gt._replace(Tcw=eye))
        pair = F.build_pair(
            prev_rel,
            _decode_depth(cur_depth, cfg.camera.width),
            _decode_sem(cur_sem, cfg.camera.width),
            gt_cur_rel,
            cfg,
            cur_gray=cur_gray.astype(jnp.float32),
        )
        res = tracker.track_pair(key, pair, ctx, cfg)
        return res._replace(obj_label_map=jnp.zeros((0,), jnp.int32))

    return jax.vmap(one_pair)(keys, prev_obs, cur_gray_u8, cur_depth_u16,
                              cur_sem_u8, gt_cur)


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_batch(keys, obs_stack, gray_u8, depth_u16, sem_u8, gts, cfg: PipelineConfig):
    """Solve all F-1 pairs at once in last-camera coordinates.

    obs_stack: stacked FrameObservation pytree (F, ...); gray/depth/sem: the
    raw current-frame images (F, H, W) used for the correspondence handoff
    and photometric flow verification.  Thin pairing wrapper over
    ``track_pairs``.
    """
    prev = jax.tree_util.tree_map(lambda x: x[:-1], obs_stack)
    gt_cur = jax.tree_util.tree_map(lambda x: x[1:], gts)
    return track_pairs(keys, prev, gray_u8[1:], depth_u16[1:], sem_u8[1:], gt_cur, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_batch_packed(keys, obs_stack, gray_u8, depth_u16, sem_u8, gts,
                       cfg: PipelineConfig):
    """track_batch with the result packed to ONE f32 vector (one download)."""
    res = track_batch(keys, obs_stack, gray_u8, depth_u16, sem_u8, gts, cfg)
    return tracker.pack_pytree(res)


@functools.partial(jax.jit, static_argnames=("cfg",))
def stream_chunk(keys, carry_obs, gray_u8, depth_w, flow_w, sem_w, gts,
                 cfg: PipelineConfig):
    """One serving pipeline stage: C new frames in, C solved pairs out.

    ``carry_obs`` is the PREVIOUS chunk's last FrameObservation (device
    resident — the boundary frame is never re-uploaded or re-described).
    Returns (packed results (C, P), last obs) so the host keeps only
    opaque handles in flight: upload(k+1) overlaps solve(k) with no
    blocking sync until the final drain."""
    obs = frontend_batch(gray_u8, depth_w, flow_w, sem_w, gts, cfg)
    prev = jax.tree_util.tree_map(
        lambda c, o: jnp.concatenate([c[None], o[:-1]], axis=0), carry_obs, obs
    )
    res = track_pairs(keys, prev, gray_u8, depth_w, sem_w, gts, cfg)
    packed = tracker.pack_pytree(res)
    carry = jax.tree_util.tree_map(lambda o: o[-1], obs)
    return packed, carry


@functools.partial(jax.jit, static_argnames=("cfg",))
def frontend_one(gray_u8, depth_w, flow_w, sem_w, gt, cfg: PipelineConfig):
    """Single-frame frontend (chunk-0 bootstrap for the streaming mode)."""
    W, H = cfg.camera.width, cfg.camera.height
    return F.build_frame_observation(
        gray_u8.astype(jnp.float32), _decode_depth(depth_w, W),
        _decode_flow(flow_w, H, W), _decode_sem(sem_w, W), gt, cfg,
    )


def pack_frame_wire(fd, cfg: PipelineConfig = DEFAULT_CONFIG):
    """Host-side wire packing of one FrameData: the v2 serving format
    (gray8 + depth12 + half-res flow12 + sem4), 3.03 -> 1.75 MB/frame."""
    return dict(
        gray=np.clip(np.round(fd.gray), 0, 255).astype(np.uint8),
        depth=pack_depth12(np.clip(fd.depth_raw, 0, 65535).astype(np.uint16)),
        flow=pack_flow12_half(fd.flow),
        sem=pack_sem4(fd.sem_mask),
    )


def run_sequence_streaming(
    frame_list: List,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    chunk: int = 8,
    prepacked: List = None,
):
    """Serving mode: chunked pipelined tracking with async uploads.

    Per chunk of ``chunk`` pairs: pack the wire arrays (v2 codec), enqueue
    the host->device transfers, dispatch ``stream_chunk``, and move on —
    results are fetched in ONE drain after the last dispatch, so uploads,
    device compute and the final download all overlap.  Returns the same
    (Tcw trajectory, stacked PairResult, object records) as
    ``run_sequence_batched``.
    """
    K = cfg.padding.k_obj_max
    Fn = len(frame_list)
    n_pairs = Fn - 1
    if n_pairs < 1:
        raise ValueError("need at least 2 frames")
    wires = prepacked or [pack_frame_wire(fd, cfg) for fd in frame_list]
    gts = [F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K)
           for fd in frame_list]

    # bootstrap: frame 0 alone (its obs is the first chunk's carry)
    w0 = wires[0]
    carry = frontend_one(
        jnp.asarray(w0["gray"]), jnp.asarray(w0["depth"]),
        jnp.asarray(w0["flow"]), jnp.asarray(w0["sem"]),
        jax.tree_util.tree_map(jnp.asarray, gts[0]), cfg,
    )

    keys = jax.random.split(jax.random.PRNGKey(seed), n_pairs)
    handles = []
    for c0 in range(0, n_pairs, chunk):
        idx = [min(c0 + 1 + i, Fn - 1) for i in range(chunk)]  # pad w/ last
        stack = {
            k: jnp.asarray(np.stack([wires[i][k] for i in idx]))
            for k in ("gray", "depth", "flow", "sem")
        }
        gt_stack = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *[gts[i] for i in idx]
        )
        kchunk = jnp.stack(
            [keys[min(c0 + i, n_pairs - 1)] for i in range(chunk)]
        )
        packed, carry = stream_chunk(
            kchunk, carry, stack["gray"], stack["depth"], stack["flow"],
            stack["sem"], gt_stack, cfg,
        )
        handles.append(packed)

    # ---- one draining fetch ----
    spec = batch_result_spec(chunk, cfg)
    chunks = [tracker.unpack_pytree(np.asarray(h), spec) for h in handles]
    res = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *chunks)
    res = jax.tree_util.tree_map(lambda x: x[:n_pairs], res)
    return _compose_batch_outputs(res, Fn)


def batch_result_spec(n_pairs: int, cfg: PipelineConfig):
    base = tracker.light_result_spec(cfg)
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((n_pairs,) + s.shape, s.dtype), base
    )


def run_sequence_batched(
    frame_list: List,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    max_pairs_per_call: int = 16,
):
    """End-to-end batched tracking of loaded FrameData records.

    Returns (Tcw trajectory (F, 4, 4), stacked PairResult, object records).
    """
    K = cfg.padding.k_obj_max
    Fn = len(frame_list)
    grays, depths, flows, sems, gts = [], [], [], [], []
    for fd in frame_list:
        grays.append(np.clip(np.round(fd.gray), 0, 255).astype(np.uint8))
        depths.append(np.clip(fd.depth_raw, 0, 65535).astype(np.uint16))
        flows.append(pack_flow12(fd.flow))
        sems.append(pack_sem4(fd.sem_mask))
        gts.append(F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K))
    gray_u8 = jnp.asarray(np.stack(grays))
    depth_u16 = jnp.asarray(np.stack(depths))
    flow_i16 = jnp.asarray(np.stack(flows))
    sem_u8 = jnp.asarray(np.stack(sems))
    gt_stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *gts)

    obs = frontend_batch(gray_u8, depth_u16, flow_i16, sem_u8, gt_stack, cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), Fn - 1)
    # chunk long sequences: each device call handles <= max_pairs_per_call
    # pairs (device-memory peaks scale with the pair axis); one compiled program per
    # distinct chunk length (at most two: full chunks + one remainder)
    n_pairs = Fn - 1
    chunks = []
    for c0 in range(0, n_pairs, max_pairs_per_call):
        c1 = min(c0 + max_pairs_per_call, n_pairs)
        obs_c = jax.tree_util.tree_map(lambda x: x[c0:c1 + 1], obs)
        gt_c = jax.tree_util.tree_map(lambda x: x[c0:c1 + 1], gt_stack)
        packed_c = track_batch_packed(
            keys[c0:c1], obs_c, gray_u8[c0:c1 + 1], depth_u16[c0:c1 + 1],
            sem_u8[c0:c1 + 1], gt_c, cfg
        )
        chunks.append(
            tracker.unpack_pytree(packed_c, batch_result_spec(c1 - c0, cfg))
        )
    res = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *chunks)
    return _compose_batch_outputs(res, Fn)


def _compose_batch_outputs(res, Fn: int):
    """Host post-pass: compose trajectory, world-frame objects, track IDs."""
    T_rel = np.asarray(res.Tcw_cur)                     # (F-1, 4, 4)
    Tcw = [np.eye(4, dtype=np.float32)]
    for k in range(Fn - 1):
        Tcw.append((T_rel[k] @ Tcw[-1]).astype(np.float32))
    Tcw = np.stack(Tcw)

    # camera RPE identical to online mode: relative est vs relative GT
    # (already computed on device against gt pairs)
    records = []
    sem_to_track = {}
    next_id = 1
    ob = res.objects
    for k in range(Fn - 1):
        new_map = {}
        active = np.asarray(ob.active[k])
        for slot in np.flatnonzero(active):
            sem_label = int(slot) + 1
            prev_sem = int(ob.mode_last_label[k][slot])
            if prev_sem in sem_to_track and k > 0:
                tid = sem_to_track[prev_sem]
            else:
                tid = next_id
                next_id += 1
            new_map[sem_label] = tid
            # world-frame motion: vObjMod = Twc_cur P_world, with the
            # batched P expressed in last-camera coords:
            # P_world = P_lc @ Tcw_last  =>  H_w = Twc_cur @ P_lc @ Tcw_last
            P_lc = np.asarray(ob.H[k][slot])  # inverse(T_rel) @ P_lc from device
            # device already computed H = inverse(Tcw_cur=T_rel) @ P_lc (in
            # last-cam world); convert to the composed world frame:
            H_lc = P_lc                         # relative-world motion
            H_w = np.linalg.inv(Tcw[k]) @ H_lc @ Tcw[k]
            records.append(
                dict(
                    frame=k + 1,
                    track_id=tid,
                    sem_label=sem_label,
                    H=H_w.astype(np.float32),
                    speed_est=float(ob.speed_est[k][slot]),
                    speed_gt=float(ob.speed_gt[k][slot]),
                    t_rpe_rel=float(ob.t_rpe_rel[k][slot]),
                    r_rpe_rel=float(ob.r_rpe_rel[k][slot]),
                    has_gt=bool(ob.has_gt[k][slot]),
                )
            )
        sem_to_track = new_map
    return Tcw, res, records
