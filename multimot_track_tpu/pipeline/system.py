"""System facade: host-side orchestration of the per-pair device program.

Replaces the reference's ``System``/``Tracking`` thread machinery
(src/System.cc:34-116, src/Tracking.cc:951-2499) with a simple sequential
host loop around one jitted pair step plus pure-host bookkeeping:

* persistent object track IDs (the reference's ``nModLabel`` relabelling,
  src/Tracking.cc:1556-1635) — small-integer logic, kept on host;
* metric accumulators mirroring the reference ``Map`` evaluation stores
  (``vvCamMotErr_*``, ``vvObjMotErr_*``, ``vmCameraPose_main``,
  include/Map.h:69-90);
* trajectory output in TUM / KITTI formats (src/System.cc:494-664).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from multimot_track_tpu.config import DEFAULT_CONFIG, PipelineConfig
from multimot_track_tpu.pipeline import frames as F
from multimot_track_tpu.pipeline import tracker
from multimot_track_tpu.io.kitti import FrameData


import functools


class _StageCtx:
    """Tiny stage timer: appends elapsed wall seconds to acc[name]."""

    __slots__ = ("acc", "name", "t0")

    def __init__(self, acc, name):
        self.acc, self.name = acc, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.acc.setdefault(self.name, []).append(
            time.perf_counter() - self.t0
        )
        return False


def _stage_host_copy(*arrs):
    """Start device->host copies NOW (non-blocking) so the later blocking
    ``np.asarray``/``device_get`` finds the bytes already on the host.

    ``copy_to_host_async`` staged at dispatch time lets the transfer run
    behind the device work, so the later fetch only waits for bytes that
    are already on their way.  Safe no-op on arrays without the method
    and on non-arrays."""
    for a in arrs:
        fn = getattr(a, "copy_to_host_async", None)
        if fn is not None:
            try:
                fn()
            except Exception:
                pass


@functools.partial(jax.jit, static_argnames=("width",))
def _describe_frame_device(gray_u8, depth_w, bf, width):
    """Keyframe-grade frame description as one fused program: FAST
    pyramid + ORB descriptors + disparity->depth + per-keypoint depth.
    Returns (uv, desc, valid, z)."""
    from multimot_track_tpu.frontend import fast, orb
    from multimot_track_tpu.geometry import camera as cam_g
    from multimot_track_tpu.ops import wire

    g = gray_u8.astype(jnp.float32)
    kp = fast.detect_pyramid(g, n_levels=4, n_total=1024)
    desc, _ = orb.describe(g, kp.uv)
    depth = cam_g.disparity_png_to_depth(wire._decode_depth(depth_w, width), bf)
    z, _ = cam_g.nearest_sample(depth, kp.uv)
    valid = kp.valid & (z > 0) & (z < 60.0)
    # zero-disparity pixels carry +inf depth; keep them invalid AND finite
    # so downstream pose@point matmuls never manufacture NaN rows
    z = jnp.where(jnp.isfinite(z), z, 0.0)
    return kp.uv, desc, valid, z


@jax.jit
def _keyframe_payload(uv, desc, valid, z, Twc, fx, fy, cx, cy):
    """Keyframe-capture fetch packing: world points computed on device,
    descriptors bit-packed (256 int8 signs -> 32 bytes), everything else
    in one f32 buffer — two compact transfers instead of four full-size
    ones (the link round trips dominate keyframe-cadence frames)."""
    from multimot_track_tpu.geometry import camera as cam_g

    Xc = cam_g.backproject(uv, z, fx, fy, cx, cy)
    Xw = (Twc[:3, :3] @ Xc.T).T + Twc[:3, 3]
    bits = jnp.packbits(desc > 0, axis=-1)
    f32 = jnp.concatenate(
        [uv.reshape(-1), Xw.reshape(-1), valid.astype(jnp.float32)]
    ).astype(jnp.float32)
    return bits, f32


@dataclasses.dataclass
class ObjectRecord:
    frame: int
    track_id: int
    sem_label: int
    H: np.ndarray              # (4, 4) world-frame motion
    speed_est: float
    speed_gt: float
    t_rpe: float
    r_rpe: float
    t_rpe_rel: float
    r_rpe_rel: float
    speed_err_rel: float
    # centroid-anchored translation error — lever-free (eval/metrics.py
    # ObjMotionErr.t_rel_centred); the E-metric t_rpe_rel above couples a
    # rotation error through the |world origin - object| distance
    t_rpe_centred: float
    n_points: int
    n_inliers: int
    centre3d: np.ndarray
    bbox: np.ndarray
    has_gt: bool
    # camera-independent decomposition for post-hoc (refined/loop-corrected)
    # metric recomputation: P_lc maps last-camera coords of an object point
    # to its current-camera position (pure measurement, no world anchoring);
    # centre_pre_lc is the solved members' centroid in last-camera coords
    P_lc: np.ndarray = None
    centre_pre_lc: np.ndarray = None


@dataclasses.dataclass
class MapState:
    """Evaluation stores (reference Map, include/Map.h:69-90)."""

    camera_poses: List[np.ndarray] = dataclasses.field(default_factory=list)  # Twc, vmCameraPose_main
    # pre-refinement (online frame-to-frame) trajectory, for comparison —
    # the reference's vmCameraPose_orb/main split has the same purpose
    camera_poses_raw: List[np.ndarray] = dataclasses.field(default_factory=list)
    gt_poses: List[np.ndarray] = dataclasses.field(default_factory=list)       # Twc ground truth
    # per-frame GT object camera-frame poses {id: L_c (4,4)} (vObjPose_gt)
    gt_objs: List[dict] = dataclasses.field(default_factory=list)
    timestamps: List[float] = dataclasses.field(default_factory=list)
    cam_rpe_abs: List[np.ndarray] = dataclasses.field(default_factory=list)   # vvCamMotErr_1
    cam_rpe_rel: List[np.ndarray] = dataclasses.field(default_factory=list)   # vvCamMotErr_2
    obj_records: List[ObjectRecord] = dataclasses.field(default_factory=list)
    tot_obj_num: List[int] = dataclasses.field(default_factory=list)          # vTotObjNum
    flow_hists: List[np.ndarray] = dataclasses.field(default_factory=list)
    frame_times: List[float] = dataclasses.field(default_factory=list)
    # accepted loop closures: (frame, matched keyframe frame, sim3 inliers)
    loop_events: List[tuple] = dataclasses.field(default_factory=list)


class MultiMotSystem:
    """End-to-end RGB-D multi-motion tracking (reference System::TrackRGBD).

    Failure handling mirrors the reference's tracking-state machine
    (include/Tracking.h:154-160 + fallback ladder src/Tracking.cc:992-1011):
    a pair whose ego solve keeps too few inliers is marked LOST; the pose
    falls back to the constant-velocity model, and tracking re-anchors on
    the next well-constrained pair.  A LOST streak longer than
    ``max_lost_frames`` triggers a reset (Tracking.cc:1164-1173 resets when
    lost soon after initialisation).
    """

    STATE_OK = "OK"
    STATE_LOST = "LOST"

    def __init__(self, cfg: PipelineConfig = DEFAULT_CONFIG, seed: int = 0,
                 min_inliers: int = 10, max_lost_frames: int = 5,
                 enable_keyframes: bool = True, keyframe_gap: int = 5,
                 enable_loop_closing: bool = True, loop_min_matches: int = 40,
                 loop_min_kf_separation: int = 3, loop_consistency: int = 3,
                 discover_objects: bool = False,
                 pipelined: bool = False):
        self.cfg = cfg
        # one-frame-latency serving: track_rgbd returns frame k-1's result
        # while frame k's device programs run; the blocking fetch overlaps
        # the next frame's compute (call flush() at sequence end).  The
        # device odometry chain runs uncorrected; host refinements ride a
        # cumulative right-factor (self._corr) into the refine program and
        # the recorded trajectory.
        self.pipelined = pipelined
        if pipelined and not cfg.backend.fused_refine:
            raise ValueError("pipelined mode requires backend.fused_refine")
        self._pending = None
        self._flush_buffer: List = []  # results drained by auto-flush, not yet returned
        self._kf_async = None          # deferred keyframe-cadence bundle
        self._last_kf_index = None
        self._corr = np.eye(4, dtype=np.float32)
        self.key = jax.random.PRNGKey(seed)
        self.map = MapState()
        self._last_obs: Optional[F.FrameObservation] = None
        self._ctx: Optional[tracker.TrackContext] = None
        self._frame_idx = 0
        # persistent track-id assignment (nModLabel)
        self._sem_to_track: Dict[int, int] = {}
        self._next_track_id = 1
        self.state = self.STATE_OK
        self.min_inliers = min_inliers
        self.max_lost_frames = max_lost_frames
        self._lost_streak = 0
        self._velocity = np.eye(4, dtype=np.float32)  # mVelocity analog
        # host mirror of ctx.Tcw_last (invariant: equals the final
        # result.Tcw_cur of the previous frame) — avoids a per-frame
        # device fetch of the context pose in the live loop
        self._Tcw_last_h = np.eye(4, dtype=np.float32)
        self.n_joint_refines = 0   # joint ego+object window BA invocations
        self._result_spec = None
        self._feat_cache = None   # (frame_idx, features) — one extraction/frame
        self._dev_images = None   # (frame_idx, gray_dev, depth_dev) handles
        self._win: List[dict] = []   # trailing window device tensors
        # mask-free mode: per-pair motion segmentation (pipeline/motion_seg)
        # synthesizes the instance masks the pipeline would otherwise read
        # from semantic/ (the reference hard-requires those files,
        # Examples/RGB-D/rgbd_tum.cc:316).  Unmasked movers contaminate the
        # static set, so the scene-flow reclassification pass is required
        # (SolverConfig.sf_cam_gate) — enable it if the caller didn't.
        self.discover_objects = discover_objects
        if discover_objects and cfg.solver.sf_cam_gate == 0.0:
            self.cfg = cfg = cfg.replace(
                solver=dataclasses.replace(cfg.solver, sf_cam_gate=0.35)
            )
        # keyframe store (on by default, like the reference's always-running
        # LocalMapping/LoopClosing threads, src/System.cc:92-97): place
        # recognition + relocalization on LOST + loop closing per keyframe
        self.enable_keyframes = enable_keyframes
        self.enable_loop_closing = enable_loop_closing and enable_keyframes
        self.loop_min_matches = loop_min_matches
        self.loop_min_kf_separation = loop_min_kf_separation
        # consecutive keyframe detections that must agree on one candidate
        # region before a loop is accepted (the reference's consistency
        # groups, src/LoopClosing.cc:105-230); 1 = single-shot
        self.loop_consistency = loop_consistency
        self._loop_history = []
        # per-stage wall-time accumulator (seconds, list per stage name):
        # the live-loop breakdown the reference gets from its per-thread
        # timers (Examples/RGB-D/rgbd_tum.cc:158-203 times TrackRGBD as
        # one block; ours splits dispatch/fetch/backend rungs).  Always
        # on — two perf_counter calls per stage.
        self.stage_times: Dict[str, List[float]] = {}
        if enable_keyframes:
            from multimot_track_tpu.pipeline.keyframes import KeyframeStore

            self.keyframes = KeyframeStore(
                capacity=cfg.backend.kf_capacity, min_gap=keyframe_gap
            )
        else:
            self.keyframes = None

    # ------------------------------------------------------------------
    def _stage(self, name: str):
        """``with self._stage("loop_ladder"):`` — accumulate wall time."""
        return _StageCtx(self.stage_times, name)

    def stage_report(self) -> Dict[str, Dict[str, float]]:
        """Aggregate stage_times: total seconds, call count, mean ms."""
        return {
            k: {
                "total_s": round(float(np.sum(v)), 3),
                "n": len(v),
                "mean_ms": round(1e3 * float(np.mean(v)), 2),
            }
            for k, v in sorted(
                self.stage_times.items(),
                key=lambda kv: -float(np.sum(kv[1])),
            )
        }

    # ------------------------------------------------------------------
    def reset(self):
        self.__init__(
            self.cfg,
            min_inliers=self.min_inliers,
            max_lost_frames=self.max_lost_frames,
            enable_keyframes=self.enable_keyframes,
            keyframe_gap=self.keyframes.min_gap if self.keyframes else 5,
            enable_loop_closing=self.enable_loop_closing,
            loop_min_matches=self.loop_min_matches,
            loop_min_kf_separation=self.loop_min_kf_separation,
            loop_consistency=self.loop_consistency,
            discover_objects=self.discover_objects,
            pipelined=self.pipelined,
        )

    # ------------------------------------------------------------------
    def save_checkpoint(self, path):
        """Serialize resumable state (the reference's unimplemented map
        save/load TODO, include/System.h:117-119)."""
        import pickle

        self.flush()

        ctx = jax.tree_util.tree_map(np.asarray, self._ctx) if self._ctx else None
        obs = jax.tree_util.tree_map(np.asarray, self._last_obs) if self._last_obs else None
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "frame_idx": self._frame_idx,
                    "ctx": ctx,
                    "last_obs": obs,
                    "map": self.map,
                    "sem_to_track": self._sem_to_track,
                    "next_track_id": self._next_track_id,
                    "state": self.state,
                    "velocity": self._velocity,
                    # backend state: keyframe map (local-map tracking, reloc,
                    # loop closing) and the trailing window's tensors — a
                    # resumed run must track identically to an unbroken one
                    "corr": self._corr,
                    "keyframes": self.keyframes.frames if self.keyframes else None,
                    "win": [
                        {k: (v if k == "row" else np.asarray(v)) for k, v in w.items()}
                        for w in self._win
                    ],
                },
                f,
            )

    def load_checkpoint(self, path):
        import pickle

        with open(path, "rb") as f:
            d = pickle.load(f)
        self._frame_idx = d["frame_idx"]
        self._ctx = (
            jax.tree_util.tree_map(jnp.asarray, d["ctx"]) if d["ctx"] is not None else None
        )
        self._last_obs = (
            jax.tree_util.tree_map(jnp.asarray, d["last_obs"])
            if d["last_obs"] is not None
            else None
        )
        self.map = d["map"]
        self._sem_to_track = d["sem_to_track"]
        self._next_track_id = d["next_track_id"]
        self.state = d["state"]
        self._velocity = d["velocity"]
        self._corr = d.get("corr", np.eye(4, dtype=np.float32))
        self._pending = None
        if d.get("keyframes") is not None and self.keyframes is not None:
            self.keyframes.frames = d["keyframes"]
            self.keyframes._version += 1
            self.keyframes._struct_version += 1
        self._win = [
            {k: (v if k == "row" else jnp.asarray(v)) for k, v in w.items()}
            for w in d.get("win", [])
        ]
        self._feat_cache = None
        self._Tcw_last_h = (
            np.asarray(self._ctx.Tcw_last, np.float32)
            if self._ctx is not None
            else np.eye(4, dtype=np.float32)
        )

    @staticmethod
    def _compact_images(fd: FrameData):
        """Host-side wire-v2 packing for the upload (ops/wire: gray8 +
        12-bit disparity + half-res 12-bit flow + 4-bit labels, 3.7 ->
        1.75 MB/frame)."""
        from multimot_track_tpu.ops import wire

        gray = np.clip(np.nan_to_num(np.round(fd.gray)), 0, 255).astype(np.uint8)
        depth = wire.pack_depth12(
            np.clip(np.nan_to_num(fd.depth_raw), 0, 65535).astype(np.uint16)
        )
        # NaN/inf flow (corrupt .flo) maps to 0 = "no correspondence"
        flow = wire.pack_flow12_half(fd.flow)
        sem = wire.pack_sem4(np.clip(fd.sem_mask, 0, 15))
        return gray, depth, flow, sem

    def upload(self, fd: FrameData):
        """Pack + enqueue the host->device transfers for one frame.

        Call from a prefetch thread while the previous frame is being
        tracked: the transfers then overlap the current frame's blocked
        fetch (``run_sequence`` does this; the reference's driver loads
        the next frame's files the same overlapped way it could not —
        its loop is fully serial, Examples/RGB-D/rgbd_tum.cc:115-189)."""
        gray, depth, flow, sem = self._compact_images(fd)
        return (
            jnp.asarray(gray), jnp.asarray(depth),
            jnp.asarray(flow), jnp.asarray(sem),
        )

    def track_rgbd(self, fd: FrameData, uploaded=None) -> Optional[tracker.PairResult]:
        """Feed one frame; returns the PairResult once a pair exists.

        ``uploaded`` — optional device handles from :meth:`upload`."""
        t0 = time.perf_counter()
        cfg = self.cfg
        K = cfg.padding.k_obj_max
        gt = F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K)
        # device handles (uploaded once; full_step and the window refiner
        # share the buffers — no duplicate transfers)
        if uploaded is not None:
            gray, depth, flow, sem = uploaded
        else:
            with self._stage("upload"):
                gray, depth, flow, sem = self.upload(fd)
        self._dev_images = (self._frame_idx, gray, depth)
        # discovery consumes the PREVIOUS frame's window entry and the
        # current velocity estimate: pipelined mode must drain the pending
        # frame first (losing the overlap on discovery runs)
        if self.discover_objects and self._pending is not None:
            self.flush(_buffer=True)  # result returned below via the buffer
        # discovery needs a velocity estimate (frame >= 2): with T_rel = I
        # the whole scene fails the ego-consistency gate and everything
        # would be flagged dynamic
        if self.discover_objects and self._win and self._frame_idx >= 2:
            sem = self._discover_mask(
                depth, jax.random.fold_in(self.key, 100_000 + self._frame_idx)
            )
        if self._last_obs is None:
            # StereoInitialization (src/Tracking.cc:2502): first pose = I
            self._ctx = tracker.initial_context(K)
            self.map.camera_poses.append(np.eye(4, dtype=np.float32))
            self.map.camera_poses_raw.append(np.eye(4, dtype=np.float32))
            self.map.gt_poses.append(np.asarray(fd.pose_gt, np.float32))
            self.map.gt_objs.append(
                {
                    int(i): np.asarray(L, np.float32)
                    for i, L in zip(fd.obj_ids_gt, fd.obj_poses_gt)
                }
                if fd.obj_ids_gt is not None
                else {}
            )
            self.map.timestamps.append(fd.timestamp)
            self._last_obs = tracker.first_step(
                gray, depth, flow, sem, gt, cfg,
                noise_key=jax.random.fold_in(self.key, 0),
            )
            self._push_window(gray, depth, flow, sem, 0)
            self._frame_idx += 1
            self.map.frame_times.append(time.perf_counter() - t0)
            return None

        step_key = jax.random.fold_in(self.key, self._frame_idx)
        with self._stage("dispatch_pair"):
            packed, new_ctx, obs = tracker.full_step(
                step_key, self._last_obs, gray, depth, flow, sem, gt,
                self._ctx, cfg
            )
        if self._result_spec is None:
            self._result_spec = tracker.light_result_spec(cfg)

        if self.enable_keyframes:
            with self._stage("features"):
                feats = self._frame_features(fd)
        else:
            feats = None
        pend = {
            "packed": packed, "new_ctx": new_ctx, "fd": fd, "key": step_key,
            "frame_idx": self._frame_idx,
            "gray": gray, "depth": depth, "flow": flow, "sem": sem,
            "feats": feats,
            "corr": None,  # captured in _dispatch_refine, AFTER the pending drain
            "refine_handle": None, "use_lm": False, "use_win": False,
            "win_after": None, "Twc0_h": None,
        }
        # the device odometry chain advances at DISPATCH time; host-side
        # corrections never touch it (they enter the refine program as the
        # cumulative right-factor ``corr`` and the recorded trajectory)
        self._ctx = new_ctx
        self._last_obs = obs
        self._frame_idx += 1

        if self.pipelined:
            # one-frame-latency serving: the blocking fetch of the PREVIOUS
            # frame's packed result overlaps THIS frame's device compute —
            # the role of the reference's LocalMapping/LoopClosing threads
            # (src/System.cc:92-97), recovered without shared-state locks
            result_prev = None
            if self._pending is not None:
                result_prev = self._process_frame(self._pending)
                self._pending = None
            elif self._flush_buffer:
                # a frame drained by an auto-flush (summary()/savers/
                # discovery) whose result was never returned to the caller
                result_prev = self._flush_buffer.pop(0)
            self._dispatch_refine(pend)
            # stage the result's device->host copy now: by the next call's
            # drain the bytes are host-side and the fetch costs ~0 RTT
            _stage_host_copy(
                pend["refine_handle"] if pend["refine_handle"] is not None
                else pend["packed"]
            )
            self._pending = pend
            self.map.frame_times.append(time.perf_counter() - t0)
            return result_prev

        self._dispatch_refine(pend)
        result = self._process_frame(pend)
        self.map.frame_times.append(time.perf_counter() - t0)
        return result

    def flush(self, _buffer: bool = False):
        """Drain the pipelined mode's in-flight frame (call at sequence
        end).  No-op in synchronous mode.  Returns the drained result.

        ``_buffer`` (internal): ``summary()``, ``ego_ate()``, the
        ``save_trajectory_*`` methods and discovery auto-flush with
        _buffer=True — their caller never sees the drained result, so it
        is buffered and returned by the NEXT ``track_rgbd`` call.  A
        caller invoking public ``flush()`` RECEIVES the result, so it
        must not also be buffered (it would be returned twice)."""
        if self._pending is not None:
            result = self._process_frame(self._pending)
            self._pending = None
            if _buffer and result is not None:
                self._flush_buffer.append(result)
            if self._kf_async is not None:
                self._consume_kf_async(None)
            return result
        if self._kf_async is not None:
            self._consume_kf_async(None)
        return None

    def _dispatch_refine(self, pend):
        """Build + dispatch the fused refinement program for a frame whose
        full_step is already in flight.  Requires the trajectory rows of
        all PREVIOUS frames to exist (pipelined mode processes the pending
        frame first)."""
        cfg = self.cfg
        be = cfg.backend
        fd = pend["fd"]
        # capture the correction factor HERE — in pipelined mode this runs
        # after the previous frame drained, so every frame chains from
        # corr_after_{j-1}.  Capturing at pend construction would chain from
        # j-2, splitting corrections into interleaved even/odd parity chains
        # (a reloc/loop correction would then reach only alternate frames).
        # The raw device chain is unaffected by when corr is sampled.
        pend["corr"] = self._corr.copy()
        gray, depth, flow, sem = (
            pend["gray"], pend["depth"], pend["flow"], pend["sem"]
        )
        if not be.fused_refine:
            return
        use_lm = bool(
            be.track_local_map
            and self.keyframes is not None
            and self.keyframes.frames
        )
        win_after = None
        if be.window_refine or be.joint_window_refine or self.discover_objects:
            # the frame's trajectory row equals its frame index (one row
            # per frame) — len(camera_poses) would lag in pipelined mode
            win_after = (
                self._win
                + [{"gray": gray, "depth": depth, "flow": flow, "sem": sem,
                    "row": pend["frame_idx"]}]
            )[-be.window_size:]
        use_win = bool(
            be.window_refine
            and win_after is not None
            and len(win_after) == be.window_size
        )
        pend.update(use_lm=use_lm, use_win=use_win, win_after=win_after)
        if not (use_lm or use_win):
            return
        from multimot_track_tpu.pipeline import live_refine

        zf = jnp.zeros((), jnp.float32)
        if use_lm:
            uv_c, desc_c, valid_c, z_c = (
                pend["feats"]
                if pend["feats"] is not None
                else self._frame_features(fd)
            )
            Xw_m, desc_m, valid_m = self.keyframes.local_map(
                n_kf=be.local_map_kfs
            )
        else:
            uv_c = desc_c = valid_c = z_c = zf
            Xw_m = desc_m = valid_m = zf
        if use_win:
            rows_prev = [w["row"] for w in win_after[:-1]]
            Twc0_h = np.asarray(self.map.camera_poses[rows_prev[0]], np.float32)
            poses_rel_prev = np.stack(
                [
                    np.linalg.inv(self.map.camera_poses[r]).astype(np.float32)
                    @ Twc0_h
                    for r in rows_prev
                ]
            )
            grays_w = jnp.stack([w["gray"] for w in win_after])
            flows_w = jnp.stack([w["flow"] for w in win_after[:-1]])
            sems_w = jnp.stack([w["sem"] for w in win_after])
            depth0_w = win_after[0]["depth"]
        else:
            poses_rel_prev = np.zeros((0, 4, 4), np.float32)
            Twc0_h = np.eye(4, dtype=np.float32)
            grays_w = flows_w = sems_w = depth0_w = zf
        pend["Twc0_h"] = Twc0_h
        pend["refine_handle"] = live_refine.live_refine_step(
            pend["packed"], uv_c, desc_c, valid_c, z_c,
            Xw_m, desc_m, valid_m,
            jnp.asarray(poses_rel_prev), jnp.asarray(Twc0_h),
            grays_w, depth0_w, flows_w, sems_w,
            jnp.asarray(pend["corr"]),
            cfg, use_lm, use_win, self.min_inliers,
        )

    def _process_frame(self, pend):
        """Fetch one frame's (solve + refinements) and run every host-side
        decision: state machine, refinement acceptance, recording, keyframe
        cadence work.  ONE blocking device->host transfer."""
        cfg = self.cfg
        be = cfg.backend
        K = cfg.padding.k_obj_max
        fd = pend["fd"]
        frame_idx = pend["frame_idx"]
        # deferred keyframe-cadence bundle from the PREVIOUS keyframe
        # frame: buffers are ready, the fetch costs transfer only; its
        # retroactive corrections update pend["corr"]/anchors in place
        if self._kf_async is not None:
            with self._stage("kf_consume"):
                self._consume_kf_async(pend)
        corr = pend["corr"]
        use_lm, use_win = pend["use_lm"], pend["use_win"]
        win_after, Twc0_h = pend["win_after"], pend["Twc0_h"]
        new_ctx = pend["new_ctx"]
        fused = be.fused_refine

        # exactly one device->host transfer for the whole frame result
        with self._stage("fetch_result"):
            if pend["refine_handle"] is not None:
                from multimot_track_tpu.pipeline import live_refine

                packed_h, T1, accept_lm, _n_lm, poses_out, n_live = (
                    live_refine.split_refined(
                        np.asarray(pend["refine_handle"]), cfg,
                        window=len(win_after) if use_win else 0,
                    )
                )
                result = tracker.unpack_pytree(packed_h, self._result_spec)
            else:
                result = tracker.unpack_pytree(
                    pend["packed"], self._result_spec
                )

        # the pose of the device odometry chain, and its correction into
        # the recorded world frame (identity in synchronous mode — the
        # chain is corrected in place there)
        Tcw_dev_flow = np.asarray(result.Tcw_cur, np.float32)
        result = result._replace(
            Tcw_cur=(Tcw_dev_flow @ corr).astype(np.float32)
        )

        # --- tracking-state machine + constant-velocity fallback ---
        Tcw_last = self._Tcw_last_h
        flow_ok = int(result.n_static_inliers) >= self.min_inliers
        if not flow_ok:
            self.state = self.STATE_LOST
            self._lost_streak += 1
            Tcw_fallback = self._velocity @ Tcw_last
            # relocalization attempt against stored keyframes (descriptor
            # place recognition -> RANSAC PnP), reference's LOST ladder
            with self._stage("relocalize"):
                T_reloc = self._try_relocalize(pend["feats"], pend["key"])
            if T_reloc is not None:
                Tcw_fallback = T_reloc
                self.state = self.STATE_OK
                self._lost_streak = 0
            result = result._replace(Tcw_cur=Tcw_fallback)
            if self._lost_streak > self.max_lost_frames:
                # reference: full reset when lost persists (Tracking.cc:1164)
                self._sem_to_track.clear()
                self._lost_streak = 0
        else:
            self.state = self.STATE_OK
            self._lost_streak = 0
            self._velocity = np.asarray(result.Tcw_cur) @ np.linalg.inv(Tcw_last)

        # the frame the device's object motions H were anchored on, and the
        # "online" trajectory sample before any map-based refinement
        Tcw_online = np.asarray(result.Tcw_cur)

        def _fix_ctx(**kw):
            # synchronous mode corrects the device chain in place; the
            # pipelined chain stays raw (corrections ride ``corr``)
            nonlocal new_ctx
            if not self.pipelined:
                new_ctx = new_ctx._replace(
                    **{k: jnp.asarray(v) for k, v in kw.items()}
                )

        if fused:
            # apply the device-gated refinements fetched with the result
            # (device evaluated the acceptance tests; the host honours
            # them, and discards everything on a LOST/reloc-rescued frame
            # whose refinements were speculative)
            if flow_ok and use_lm and accept_lm:
                result = result._replace(Tcw_cur=T1)
                self._velocity = (T1 @ np.linalg.inv(Tcw_last)).astype(
                    np.float32
                )
                _fix_ctx(Tcw_last=T1, T_velocity=self._velocity)
            with self._stage("record"):
                self._record(result, fd, Tcw_online=Tcw_online,
                             frame_idx=frame_idx)
                self._push_window(
                    pend["gray"], pend["depth"], pend["flow"], pend["sem"],
                    len(self.map.camera_poses) - 1,
                )
            if (
                flow_ok
                and use_win
                and n_live >= be.min_window_tracks
                and np.isfinite(poses_out).all()
            ):
                Tcw0_abs = np.linalg.inv(Twc0_h).astype(np.float32)
                rows = [w["row"] for w in win_after]
                for f, r in enumerate(rows):
                    Tcw_new = (poses_out[f] @ Tcw0_abs).astype(np.float32)
                    self.map.camera_poses[r] = np.linalg.inv(Tcw_new).astype(
                        np.float32
                    )
                refined_last = (poses_out[-1] @ Tcw0_abs).astype(np.float32)
                result = result._replace(Tcw_cur=refined_last)
                _fix_ctx(Tcw_last=refined_last)
                if len(self.map.camera_poses) >= 2:
                    # Tcw_cur @ Twc_prev (camera_poses stores Twc)
                    self._velocity = (
                        refined_last @ self.map.camera_poses[-2]
                    ).astype(np.float32)
                    _fix_ctx(T_velocity=self._velocity)
        else:
            # TrackLocalMap rung (src/Tracking.cc:3189): let the accumulated
            # keyframe map refine the per-pair flow pose before it is recorded
            use_lm_sync = bool(
                be.track_local_map
                and self.keyframes is not None
                and self.keyframes.frames
            )
            if use_lm_sync and self.state == self.STATE_OK:
                with self._stage("local_map"):
                    T_lm = self._track_local_map(
                        Tcw_online, pend["feats"], fd
                    )
                if T_lm is not None:
                    result = result._replace(Tcw_cur=T_lm)
                    self._velocity = (T_lm @ np.linalg.inv(Tcw_last)).astype(np.float32)
                    _fix_ctx(Tcw_last=T_lm, T_velocity=self._velocity)

            with self._stage("record"):
                self._record(result, fd, Tcw_online=Tcw_online,
                             frame_idx=frame_idx)
                self._push_window(
                    pend["gray"], pend["depth"], pend["flow"], pend["sem"],
                    len(self.map.camera_poses) - 1,
                )
            if cfg.backend.window_refine and self.state == self.STATE_OK:
                with self._stage("window_refine"):
                    refined_last = self._refine_window()
                if refined_last is not None:
                    result = result._replace(Tcw_cur=refined_last)
                    _fix_ctx(Tcw_last=refined_last)
                    if len(self.map.camera_poses) >= 2:
                        # Tcw_cur @ Twc_prev (camera_poses stores Twc)
                        self._velocity = (
                            refined_last @ self.map.camera_poses[-2]
                        ).astype(np.float32)
                        _fix_ctx(T_velocity=self._velocity)
        if (
            self.enable_keyframes
            and self.state == self.STATE_OK
            and self.pipelined
            and be.async_keyframes
        ):
            # async keyframe cadence: dispatch everything now, consume at
            # the next drain (fetches then cost transfer only)
            with self._stage("kf_dispatch"):
                self._dispatch_kf_cadence(
                    pend, np.asarray(result.Tcw_cur), frame_idx
                )
        elif self.enable_keyframes and self.state == self.STATE_OK:
            # after _record so the keyframe's trajectory row exists; a
            # successful loop closure rewrites the recorded trajectory
            with self._stage("keyframe_add"):
                added = self._maybe_add_keyframe(
                    fd, np.asarray(result.Tcw_cur), pend["feats"], frame_idx
                )
            if added and cfg.backend.joint_window_refine:
                # joint ego+object windowed BA at keyframe cadence (the
                # LocalBundleAdjustment rung, extended with object motions)
                with self._stage("joint_ba"):
                    joint_last = self._refine_joint_window()
                if joint_last is not None:
                    result = result._replace(Tcw_cur=joint_last)
                    _fix_ctx(Tcw_last=joint_last)
                    if len(self.map.camera_poses) >= 2:
                        self._velocity = (
                            joint_last @ self.map.camera_poses[-2]
                        ).astype(np.float32)
                        _fix_ctx(T_velocity=self._velocity)
            if added and self.enable_loop_closing:
                with self._stage("loop_ladder"):
                    corrected_last = self._maybe_close_loop(
                        pend["key"], frame_idx
                    )
                if corrected_last is not None:
                    result = result._replace(Tcw_cur=corrected_last)
                    _fix_ctx(
                        Tcw_last=corrected_last, T_velocity=self._velocity
                    )
        if self.state == self.STATE_LOST:
            if self.pipelined and np.isfinite(Tcw_dev_flow).all():
                # mid-pipeline LOST: frame k is already in flight on the raw
                # device chain, so NEVER rebase the chain here (that would
                # anchor frame k+1 on a pose one frame old and leave frame
                # k's stale corr uncorrected).  Apply the fallback/reloc
                # pose as the cumulative right-factor instead: the in-flight
                # frame's recorded pose becomes
                # dev_rel_motion(k-1 -> k) @ Tcw_fallback — the correction
                # reaches every subsequent frame, no motion is dropped.
                self._corr = (
                    np.linalg.inv(Tcw_dev_flow) @ np.asarray(result.Tcw_cur)
                ).astype(np.float32)
            else:
                # the device chain anchored on a diverged (synchronous mode)
                # or non-finite (pipelined; corr algebra impossible) pose:
                # rebuild the context from the fallback.  The velocity
                # anchor is the last RECORDED pose, not the chain's
                # diverged one.  In the pipelined non-finite case this
                # drops the one in-flight inter-frame motion (frame k+1
                # re-anchors on frame k-1's corrected pose) — unavoidable
                # without flushing, and the chain was unusable anyway.
                self._ctx = tracker.next_context(
                    result,
                    self._ctx._replace(Tcw_last=jnp.asarray(Tcw_last)),
                    K,
                )
                self._corr = np.eye(4, dtype=np.float32)
        elif not self.pipelined:
            self._ctx = new_ctx
            self._corr = np.eye(4, dtype=np.float32)
        else:
            # cumulative right-factor mapping the raw device chain into
            # the recorded (refined/corrected) world frame:
            # T_recorded = T_device @ corr
            self._corr = (
                np.linalg.inv(Tcw_dev_flow) @ np.asarray(result.Tcw_cur)
            ).astype(np.float32)
        self._Tcw_last_h = np.asarray(result.Tcw_cur, np.float32)
        return result

    # ------------------------------------------------------------------
    def _describe_frame(self, fd: FrameData):
        """FAST + ORB + depth on a frame (keyframe/reloc/local-map
        features) — ONE fused device dispatch, reusing the buffers
        ``track_rgbd`` already uploaded when available (no second upload
        of the same frame)."""
        if self._dev_images is not None and self._dev_images[0] == self._frame_idx:
            gray, depth = self._dev_images[1], self._dev_images[2]
        else:
            from multimot_track_tpu.ops import wire

            gray = jnp.asarray(
                np.clip(np.nan_to_num(np.round(fd.gray)), 0, 255).astype(np.uint8)
            )
            depth = jnp.asarray(
                wire.pack_depth12(
                    np.clip(np.nan_to_num(fd.depth_raw), 0, 65535).astype(np.uint16)
                )
            )
        return _describe_frame_device(
            gray, depth, self.cfg.camera.bf, self.cfg.camera.width
        )

    @staticmethod
    def _split_payload(f32: np.ndarray, n: int):
        """Decode the _keyframe_payload f32 buffer: (uv (n,2), Xw (n,3),
        valid (n,)) — the ONE place that knows the slice layout."""
        return (
            f32[: 2 * n].reshape(n, 2),
            f32[2 * n : 5 * n].reshape(n, 3),
            f32[5 * n :] > 0.5,
        )

    def _frame_features(self, fd: FrameData):
        """Per-frame cache around ``_describe_frame``: local-map tracking,
        keyframe capture and relocalization all need the same features —
        extract once per frame."""
        if self._feat_cache is not None and self._feat_cache[0] == self._frame_idx:
            return self._feat_cache[1]
        feats = self._describe_frame(fd)
        self._feat_cache = (self._frame_idx, feats)
        return feats

    def _track_local_map(self, Tcw_init: np.ndarray, feats=None, fd=None):
        """Refine the flow pose against the local map (TrackLocalMap,
        src/Tracking.cc:3189).  Returns the refined Tcw or None when the
        refinement fails the acceptance gates (too few inliers, or a
        correction so large it contradicts the flow solve — the map points
        carry z^2-growing stereo-depth noise, so the flow pose stays the
        anchor and the map is only allowed to nudge it)."""
        be, cam = self.cfg.backend, self.cfg.camera
        uv, desc, valid, z = (
            feats if feats is not None else self._frame_features(fd)
        )
        T, n_inl, _ = self.keyframes.track_local_map(
            Tcw_init, uv, desc, valid, z,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf,
            n_kf=be.local_map_kfs,
            radius=be.local_map_radius_px,
            thresh=be.local_map_thresh_px,
        )
        if n_inl < be.local_map_min_inliers:
            return None
        d = T @ np.linalg.inv(Tcw_init)
        if not np.isfinite(T).all():
            return None
        if np.linalg.norm(d[:3, 3]) > be.local_map_max_corr_m:
            return None
        ang = np.degrees(
            np.arccos(np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
        )
        if ang > be.local_map_max_rot_deg:
            return None
        return T.astype(np.float32)

    # ------------------------------------------------------------------
    # Async keyframe cadence (pipelined mode, BackendConfig.async_keyframes):
    # all keyframe-cadence device work is dispatched at the keyframe frame
    # and consumed ONE FRAME LATER, when the buffers are ready — fetches
    # cost transfer only.  Retroactive corrections ride the cumulative
    # right-factor exactly like the per-frame refinements.

    def _dispatch_kf_cadence(self, pend, Tcw_cur: np.ndarray, frame_idx: int):
        from multimot_track_tpu.pipeline.keyframes import (
            _adjacent_match_counts, _batched_match_counts,
        )

        cam, be = self.cfg.camera, self.cfg.backend
        last = self._last_kf_index
        if self.keyframes.frames:
            last = max(
                last if last is not None else -10**9,
                self.keyframes.frames[-1].index,
            )
        if last is not None and frame_idx - last < self.keyframes.min_gap:
            return
        feats = (
            pend["feats"] if pend["feats"] is not None
            else self._frame_features(pend["fd"])
        )
        uv, desc, valid, z = feats
        Twc = np.linalg.inv(Tcw_cur).astype(np.float32)
        bits_h, f32_h = _keyframe_payload(
            uv, desc, valid, z, jnp.asarray(Twc),
            cam.fx, cam.fy, cam.cx, cam.cy,
        )
        n = int(desc.shape[0])
        # device-side views of the payload feed the fuse scan — no fetch
        uv_dev, Xw_dev, valid_dev = self._split_payload(f32_h, n)
        fuse_handle, fuse_prevs = self.keyframes.dispatch_fuse(
            jnp.asarray(np.asarray(Tcw_cur, np.float32)), desc, uv_dev,
            valid_dev, Xw_dev,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        )
        sim_handle = adj_handle = None
        # dense descriptor scoring against the whole stack: bounded by the
        # store capacity (64 kf x 1024 x 1024 x 256b ~ 17 G MAC, <1 ms on
        # the device), so the BoW two-stage dispatch the sync path switches
        # to above bow_threshold is unnecessary here — its win is
        # host/dispatch overhead, which this path defers off the critical
        # path anyway
        stacked = self.keyframes._stacked_descriptors()
        if stacked is not None:
            sim_handle = _batched_match_counts(desc, valid, *stacked)
            adj_handle = _adjacent_match_counts(*stacked)
        joint = None
        if be.joint_window_refine:
            joint = self._refine_joint_window(dispatch_only=True)
        _stage_host_copy(
            bits_h, f32_h, fuse_handle, sim_handle, adj_handle,
            joint[0] if joint is not None else None,
        )
        self._kf_async = dict(
            frame_idx=frame_idx,
            Tcw=np.asarray(Tcw_cur, np.float32).copy(),
            bits=bits_h, f32=f32_h, n=n,
            fuse=fuse_handle, fuse_prevs=fuse_prevs,
            sim=sim_handle, adj=adj_handle,
            n_old=len(self.keyframes.frames),
            # score index -> keyframe OBJECT (store membership can churn
            # between dispatch and consume: eviction, redundancy culling)
            frames_ref=list(self.keyframes.frames),
            joint=joint, key=pend["key"],
        )
        self._last_kf_index = frame_idx

    def _apply_right_factor(self, D: np.ndarray, pend, first_row: int):
        """Fold a retroactive Tcw right-factor correction (rows >=
        ``first_row`` move as Tcw @ D) into the recorded trajectory, the
        pipelined correction chain, and the in-flight frame's anchors."""
        D = D.astype(np.float32)
        Dinv = np.linalg.inv(D).astype(np.float32)
        for r in range(first_row, len(self.map.camera_poses)):
            # camera_poses stores Twc; Tcw @ D  ==  inv(D) @ Twc
            self.map.camera_poses[r] = (
                Dinv @ self.map.camera_poses[r]
            ).astype(np.float32)
        self._corr = (self._corr @ D).astype(np.float32)
        self._Tcw_last_h = (self._Tcw_last_h @ D).astype(np.float32)
        if pend is not None:
            if pend.get("corr") is not None:
                pend["corr"] = (pend["corr"] @ D).astype(np.float32)
            if pend.get("Twc0_h") is not None:
                pend["Twc0_h"] = (Dinv @ pend["Twc0_h"]).astype(np.float32)

    def _consume_kf_async(self, pend):
        """Fetch + apply one deferred keyframe-cadence bundle (see
        :meth:`_dispatch_kf_cadence`).  ``pend`` is the frame currently
        being drained (None at flush)."""
        from multimot_track_tpu.pipeline.keyframes import Keyframe

        a, self._kf_async = self._kf_async, None
        cam, be = self.cfg.camera, self.cfg.backend
        names = [k for k in ("bits", "f32", "fuse", "sim", "adj")
                 if a[k] is not None]
        handles = [a[k] for k in names]
        if a["joint"] is not None:
            names.append("joint")
            handles.append(a["joint"][0])
        fetched = dict(zip(names, jax.device_get(handles)))

        n = a["n"]
        f32 = np.asarray(fetched["f32"])
        bits = np.asarray(fetched["bits"])
        uv_h, Xw_h, valid_h = self._split_payload(f32, n)
        kf = Keyframe(
            index=a["frame_idx"], Tcw=a["Tcw"],
            uv=uv_h.astype(np.float32),
            desc=np.unpackbits(bits, axis=-1).astype(np.int8) * 2 - 1,
            valid=valid_h,
            Xw=Xw_h.astype(np.float32),
        )
        added = self.keyframes.maybe_add(kf)
        if not added:
            return
        K_old = a["n_old"]
        if "fuse" in fetched and a["fuse_prevs"]:
            self.keyframes.apply_fuse(
                np.asarray(fetched["fuse"]), a["fuse_prevs"],
                self.keyframes.frames[-1],
            )
        # the dispatch-time covisibility counts index PAIRS of the
        # dispatch-time store; any membership churn since (capacity
        # eviction in maybe_add) shifts the adjacency and would cull on
        # the wrong weights — skip this cadence's cull instead (rare, and
        # the next keyframe's counts catch up)
        aligned = (
            len(self.keyframes.frames) == K_old + 1
            and all(
                self.keyframes.frames[i] is a["frames_ref"][i]
                for i in range(K_old)
            )
        )
        if aligned and "adj" in fetched and "sim" in fetched and K_old >= 1:
            sim = np.asarray(fetched["sim"])
            counts = np.concatenate(
                [np.asarray(fetched["adj"])[: max(K_old - 1, 0)],
                 sim[K_old - 1 : K_old]]
            )
            self.keyframes.cull_redundant(counts=counts)
        if "joint" in fetched:
            # object-measurement commit only (see _joint_window_apply)
            self._joint_window_apply(
                a["joint"][1], np.asarray(fetched["joint"]),
                commit_poses=False,
            )
        if self.enable_loop_closing and "sim" in fetched and K_old >= 2:
            # scores vs the pre-add stack minus its newest entry == the
            # sync path's exclude_last=2 (which also skips the new kf)
            scores = np.asarray(fetched["sim"])[: K_old - 1]
            cand = -1
            if scores.size and int(scores.max()) >= self.loop_min_matches:
                try:   # membership may have churned since dispatch
                    cand = self.keyframes.frames.index(
                        a["frames_ref"][int(scores.argmax())]
                    )
                except ValueError:
                    cand = -1
            if cand < 0:
                self._note_loop_candidate(None)
            else:
                # separation + consistency + acceptance all live inside
                # _maybe_close_loop (it notes the candidate history)
                old_last = np.linalg.inv(
                    self.map.camera_poses[-1]
                ).astype(np.float32)
                corrected_last = self._maybe_close_loop(
                    a["key"], a["frame_idx"], cand=cand
                )
                if corrected_last is not None:
                    D = (
                        np.linalg.inv(old_last) @ corrected_last
                    ).astype(np.float32)
                    # the ladder already rewrote every row; only the
                    # chain/anchors still need the fold
                    self._apply_right_factor(
                        D, pend,
                        first_row=len(self.map.camera_poses),
                    )

    def _maybe_add_keyframe(
        self, fd: FrameData, Tcw: np.ndarray, feats=None, frame_idx=None
    ) -> bool:
        from multimot_track_tpu.pipeline.keyframes import Keyframe

        if frame_idx is None:
            frame_idx = self._frame_idx
        if self.keyframes.frames and (
            frame_idx - self.keyframes.frames[-1].index
            < self.keyframes.min_gap
        ):
            return False
        cam = self.cfg.camera
        uv, desc, valid, z = (
            feats if feats is not None else self._frame_features(fd)
        )
        Twc = np.linalg.inv(Tcw).astype(np.float32)
        bits, f32 = _keyframe_payload(
            uv, desc, valid, z, jnp.asarray(Twc),
            cam.fx, cam.fy, cam.cx, cam.cy,
        )
        bits = np.asarray(bits)
        f32 = np.asarray(f32)
        n = bits.shape[0]
        uv_h, Xw_h, valid_h = self._split_payload(f32, n)
        desc_h = (
            np.unpackbits(bits, axis=-1).astype(np.int8) * 2 - 1
        )
        added = self.keyframes.maybe_add(
            Keyframe(
                index=frame_idx,
                Tcw=Tcw.astype(np.float32),
                uv=uv_h.astype(np.float32),
                desc=desc_h,
                valid=valid_h,
                Xw=Xw_h.astype(np.float32),
            )
        )
        if added:
            # each keyframe's trajectory row IS its frame index (one
            # camera_poses row per frame), so no parallel bookkeeping;
            # the LocalMapping maintenance pass runs here at keyframe
            # cadence: duplicate-landmark fusion + found-ratio culling
            # (SearchInNeighbors/Fuse + MapPointCulling), then
            # KeyFrameCulling (all covisibilities = one device dispatch)
            self.keyframes.fuse_and_cull(
                cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height
            )
            self.keyframes.cull_redundant()
        return added

    def _discover_mask(self, depth_u16_cur, key):
        """Synthesize the current frame's instance mask from motion alone
        (pipeline/motion_seg): discovery runs on the previous frame's grid
        with the constant-velocity ego prediction, and the labels are
        rasterized at their flow-shifted (current-frame) positions."""
        from multimot_track_tpu.geometry import camera as cam_g
        from multimot_track_tpu.ops import wire
        from multimot_track_tpu.pipeline import motion_seg

        cam = self.cfg.camera
        prev = self._win[-1]
        depth0 = cam_g.disparity_png_to_depth(
            wire._decode_depth(prev["depth"], cam.width), cam.bf
        )
        depth1 = cam_g.disparity_png_to_depth(
            wire._decode_depth(depth_u16_cur, cam.width), cam.bf
        )
        flow0 = wire._decode_flow(prev["flow"], cam.height, cam.width)
        disc = motion_seg.discover_objects(
            key, depth0, depth1, flow0, jnp.asarray(self._velocity),
            cam.fx, cam.fy, cam.cx, cam.cy,
        )
        # the MRF may split one object across several motion clusters
        # (fragmented hypotheses); instances = connected components of the
        # dynamic raster, largest K-1 kept (labels must fit the pipeline's
        # K slots, cf. the loader's <4 clamp, io/kitti.load_mask_txt)
        raster = np.asarray(
            motion_seg.rasterize_labels_at(
                disc.uv_cur, disc.labels, disc.valid, cam.height, cam.width,
                step=8,
            )
        )
        from scipy import ndimage

        # dilate one 8px cell so near-adjacent fragments merge
        binary = ndimage.binary_dilation(raster > 0, np.ones((17, 17), bool))
        comp, n_comp = ndimage.label(binary)
        comp = np.where(raster > 0, comp, 0)   # undo the dilation
        mask = np.zeros_like(raster)
        if n_comp:
            sizes = ndimage.sum_labels(raster > 0, comp, range(1, n_comp + 1))
            order = np.argsort(sizes)[::-1][: self.cfg.padding.k_obj_max - 1]
            for new_id, c in enumerate(order, start=1):
                # each discovered grid point paints an 8x8 cell; distant
                # objects are small, so gate loosely and let the tracker's
                # min_obj_points filter make the final call
                if sizes[c] < 640:
                    continue
                mask[comp == c + 1] = new_id
        # wire-packed like every other mask entering the pipeline (the
        # window buffer stacks sem tensors, so formats must agree)
        return jnp.asarray(wire.pack_sem4(np.clip(mask, 0, 15)))

    def _push_window(self, gray, depth, flow, sem, traj_row: int):
        """Keep the trailing window's device tensors for the refiner (and
        the mask-free discovery, which needs the previous frame)."""
        if not (
            self.cfg.backend.window_refine
            or self.cfg.backend.joint_window_refine
            or self.discover_objects
        ):
            return
        self._win.append(
            {"gray": gray, "depth": depth, "flow": flow, "sem": sem, "row": traj_row}
        )
        if len(self._win) > self.cfg.backend.window_size:
            self._win.pop(0)

    def _refine_window(self) -> Optional[np.ndarray]:
        """Trailing-window BA over the buffered frames (LocalMapping role).

        Rewrites the refined rows of ``map.camera_poses`` (anchored at the
        window's first frame) and returns the refined current Tcw."""
        from multimot_track_tpu.pipeline import window_refine

        be = self.cfg.backend
        if len(self._win) < be.window_size:
            return None
        rows = [w["row"] for w in self._win]
        Tcw_abs = [
            np.linalg.inv(self.map.camera_poses[r]).astype(np.float32) for r in rows
        ]
        Twc0 = np.linalg.inv(Tcw_abs[0]).astype(np.float32)
        poses_rel = np.stack([T @ Twc0 for T in Tcw_abs])
        flows = jnp.stack([w["flow"] for w in self._win[:-1]])
        sems = jnp.stack([w["sem"] for w in self._win])
        grays = jnp.stack([w["gray"] for w in self._win])
        poses_out, n_live = window_refine.refine_trailing_window(
            jnp.asarray(poses_rel),
            grays, self._win[0]["depth"], flows, sems, self.cfg,
        )
        if int(n_live) < be.min_window_tracks:
            return None
        poses_out = np.asarray(poses_out)
        if not np.isfinite(poses_out).all():
            return None
        for f, r in enumerate(rows):
            Tcw_new = (poses_out[f] @ Tcw_abs[0]).astype(np.float32)
            self.map.camera_poses[r] = np.linalg.inv(Tcw_new).astype(np.float32)
        return (poses_out[-1] @ Tcw_abs[0]).astype(np.float32)

    def _refine_joint_window(self, dispatch_only: bool = False):
        """Joint ego + multi-object BA over the trailing window at keyframe
        cadence (reference LocalBundleAdjustment, src/Optimizer.cc:3341,
        extended with per-pair object motions under a constant-motion
        prior — the BASELINE "sliding-window multi-object BA" target).

        ``dispatch_only=True`` (async keyframe cadence) returns
        (device handle, context) without fetching; pair with
        :meth:`_joint_window_apply`.

        Rewrites the window's trajectory rows AND the window records'
        camera-independent object measurements (P_lc), so the refined
        object metrics (``refined_obj_metrics``) evaluate the jointly
        optimized motions.  Returns the refined current Tcw, or None when
        the window has no objects / fails the acceptance gates."""
        from multimot_track_tpu.pipeline import window_refine

        be = self.cfg.backend
        K = self.cfg.padding.k_obj_max
        if len(self._win) < be.window_size:
            return None
        rows = [w["row"] for w in self._win]
        # LOST gaps break the pair <-> stored-flow alignment
        if any(rows[i + 1] - rows[i] != 1 for i in range(len(rows) - 1)):
            return None
        Wn = len(rows)
        Tcw_abs = [
            np.linalg.inv(self.map.camera_poses[r]).astype(np.float32) for r in rows
        ]
        Twc0 = np.linalg.inv(Tcw_abs[0]).astype(np.float32)
        poses_rel = np.stack([T @ Twc0 for T in Tcw_abs])

        # per-pair object motion init from the records' P_lc measurement,
        # re-anchored into window-relative world coordinates
        H_init = np.tile(np.eye(4, dtype=np.float32), (Wn - 1, K, 1, 1))
        H_valid = np.zeros((Wn - 1, K), bool)
        rec_idx = {
            (rec.frame, rec.sem_label): i
            for i, rec in enumerate(self.map.obj_records)
        }
        used = {}
        for f in range(Wn - 1):
            for k in range(K):
                i = rec_idx.get((rows[f + 1], k + 1))
                if i is None or self.map.obj_records[i].P_lc is None:
                    continue
                H_init[f, k] = (
                    np.linalg.inv(poses_rel[f + 1])
                    @ self.map.obj_records[i].P_lc
                    @ poses_rel[f]
                )
                H_valid[f, k] = True
                used[(f, k)] = i
        if not used:
            return None    # ego-only windows are the per-frame refiner's job
        self.n_joint_refines += 1

        poses_out, motions_out, _ = window_refine.refine_joint_window(
            jnp.asarray(poses_rel), jnp.asarray(H_init), jnp.asarray(H_valid),
            jnp.stack([w["gray"] for w in self._win]),
            jnp.stack([w["depth"] for w in self._win]),
            jnp.stack([w["flow"] for w in self._win[:-1]]),
            jnp.stack([w["sem"] for w in self._win]),
            self.cfg,
        )
        # one fetch for both outputs (each np.asarray is a blocking sync)
        handle = jnp.concatenate([poses_out.reshape(-1), motions_out.reshape(-1)])
        jctx = dict(rows=rows, poses_rel=poses_rel, Tcw0_abs=Tcw_abs[0],
                    used=used, Wn=Wn, K=K)
        if dispatch_only:
            return handle, jctx
        return self._joint_window_apply(jctx, np.asarray(handle))

    def _joint_window_apply(self, jctx, both,
                            commit_poses: bool = True) -> Optional[np.ndarray]:
        """Gates + commits of a fetched joint-window result (see
        :meth:`_refine_joint_window`); returns the refined Tcw of the
        window's LAST row or None when rejected.

        ``commit_poses=False`` (async cadence): only the OBJECT
        measurements (P_lc) are committed.  The ego rows are refreshed by
        the per-frame window refiner every frame anyway (the joint BA's
        measured ego impact is neutral — its value is the object
        refinement, r3 notes in BackendConfig), and a deferred ego commit
        would fight the in-flight frame's own retroactive row writes."""
        be = self.cfg.backend
        Wn, K = jctx["Wn"], jctx["K"]
        rows, poses_rel = jctx["rows"], jctx["poses_rel"]
        Tcw0_abs = jctx["Tcw0_abs"]
        poses_out = both[: Wn * 16].reshape(Wn, 4, 4)
        motions_out = both[Wn * 16 :].reshape(Wn - 1, K, 4, 4)
        if not (np.isfinite(poses_out).all() and np.isfinite(motions_out).all()):
            return None
        for f in range(Wn):
            d = poses_out[f] @ np.linalg.inv(poses_rel[f])
            if np.linalg.norm(d[:3, 3]) > be.joint_max_corr_m:
                return None

        # commit: trajectory rows + refined object measurements
        if commit_poses:
            for f, r in enumerate(rows):
                Tcw_new = (poses_out[f] @ Tcw0_abs).astype(np.float32)
                self.map.camera_poses[r] = np.linalg.inv(Tcw_new).astype(
                    np.float32
                )
        for (f, k), i in jctx["used"].items():
            P_new = (
                poses_out[f + 1]
                @ motions_out[f, k]
                @ np.linalg.inv(poses_out[f])
            )
            self.map.obj_records[i].P_lc = P_new.astype(np.float32)
        return (poses_out[-1] @ Tcw0_abs).astype(np.float32)

    def _maybe_close_loop(self, key, frame_idx=None,
                          cand=None) -> Optional[np.ndarray]:
        """Loop detection + Sim3 verification + pose-graph correction on the
        newest keyframe (the reference's LoopClosing::Run cycle,
        src/LoopClosing.cc:58-647, run synchronously at keyframe cadence).
        ``cand`` — precomputed candidate index (async cadence path).

        Returns the corrected current Tcw when a loop is accepted."""
        import jax.numpy as jnp

        kf = self.keyframes.frames[-1]
        if cand is None:
            cand = self.keyframes.detect_loop(
                jnp.asarray(kf.desc), jnp.asarray(kf.valid),
                min_matches=self.loop_min_matches,
            )
        if cand is None:
            self._note_loop_candidate(None)
            return None
        # temporal guard: candidates too close in time are not loops
        if len(self.keyframes.frames) - 1 - cand < self.loop_min_kf_separation:
            self._note_loop_candidate(None)
            return None
        # consecutive-detection consistency (the reference's consistency
        # groups, LoopClosing::DetectLoop src/LoopClosing.cc:105-230): a
        # genuine revisit produces the same candidate REGION across
        # several consecutive keyframes; repetitive-texture false
        # positives fire at scattered places.  Measured: on a 240-frame
        # straight avenue with self-similar procedural texture, single-
        # shot acceptance produced 10 false closures and 39 m of ATE.
        if not self._note_loop_candidate(self.keyframes.frames[cand].index):
            return None
        cam = self.cfg.camera
        traj_Tcw = np.stack(
            [np.linalg.inv(p).astype(np.float32) for p in self.map.camera_poses]
        )
        corrected, n_inl = self.keyframes.close_loop(
            key, kf, cand, traj_Tcw,
            [k.index for k in self.keyframes.frames],
            cam.fx, cam.fy, cam.cx, cam.cy,
        )
        if n_inl == 0:
            return None
        corrected = np.array(corrected)   # writable copy (solver output is
        #                                   a read-only device-backed array)
        self.map.camera_poses = [
            np.linalg.inv(T).astype(np.float32) for T in corrected
        ]
        # keyframe poses follow their trajectory rows, and the stored world
        # points are re-anchored with them (CorrectLoop's keyframe + map
        # point update, src/LoopClosing.cc:460-520) — otherwise reloc and
        # local-map tracking would keep serving the pre-correction frame
        self.keyframes.correct_poses(
            [corrected[k.index] for k in self.keyframes.frames]
        )
        be = self.cfg.backend
        if be.global_ba_on_loop:
            # full global BA over the keyframe graph, seeded by the
            # pose-graph result (the reference's essential-graph-then-GBA
            # two-step, src/LoopClosing.cc:404-647)
            kf_rows = [k.index for k in self.keyframes.frames]
            old_Tcw_kf = [corrected[r].copy() for r in kf_rows]
            gba = self.keyframes.global_ba(
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                loop_pair=(cand, len(self.keyframes.frames) - 1),
                max_obs=be.global_ba_max_obs, iters=be.global_ba_iters,
                max_corr_m=be.global_ba_max_corr_m,
            )
            if gba is not None:
                new_Tcw_kf, _stats = gba
                # non-keyframe rows follow their anchor keyframe: the
                # relative pose frame->keyframe is a measurement the GBA
                # did not touch (the reference corrects non-KF frames the
                # same way via their reference keyframe)
                anchor = 0
                for r in range(corrected.shape[0]):
                    while (
                        anchor + 1 < len(kf_rows) and kf_rows[anchor + 1] <= r
                    ):
                        anchor += 1
                    corrected[r] = (
                        corrected[r]
                        @ np.linalg.inv(old_Tcw_kf[anchor])
                        @ new_Tcw_kf[anchor]
                    ).astype(np.float32)
                self.map.camera_poses = [
                    np.linalg.inv(T).astype(np.float32) for T in corrected
                ]
        if len(corrected) >= 2:
            self._velocity = (
                corrected[-1] @ np.linalg.inv(corrected[-2])
            ).astype(np.float32)
        self.map.loop_events.append(
            (
                self._frame_idx if frame_idx is None else frame_idx,
                self.keyframes.frames[cand].index,
                n_inl,
            )
        )
        self._loop_history.clear()   # accepted: don't re-trigger on this revisit
        return corrected[-1]

    def _note_loop_candidate(self, cand_frame) -> bool:
        """Track per-keyframe loop candidates; True when at least
        ``loop_consistency`` of the newest loop_consistency+1 detections
        agree on one candidate region (one missed detection is tolerated —
        texture aliasing can blank a single revisit keyframe; scattered
        false positives still never line up).  The region allowance scales
        with the keyframe gap because a genuine revisit's candidates
        advance with the ego."""
        self._loop_history.append(cand_frame)
        need = self.loop_consistency
        if need <= 1:
            return cand_frame is not None
        if cand_frame is None:
            return False
        gap = self.keyframes.min_gap if self.keyframes else 5
        # entries in the recent window that agree with the CURRENT
        # candidate's region — a lone scattered (false) candidate earlier
        # in the window neither helps nor blocks a genuine cluster
        close = [
            x for x in self._loop_history[-(need + 1):]
            if x is not None and abs(x - cand_frame) <= (need + 1) * gap
        ]
        if len(close) < need:
            return False
        # NOTE: history is cleared by _maybe_close_loop only after an
        # ACCEPTED closure — a downstream Sim3/drift-gate rejection keeps
        # the accumulated revisit evidence so the next keyframe can retry
        return True

    def _try_relocalize(self, feats, key):
        if not self.enable_keyframes or not (self.keyframes and self.keyframes.frames):
            return None
        if feats is None:
            return None
        cam = self.cfg.camera
        uv, desc, valid, _ = feats
        return self.keyframes.relocalize(
            key, desc, uv, valid, cam.fx, cam.fy, cam.cx, cam.cy
        )

    # ------------------------------------------------------------------
    def _record(self, r: tracker.PairResult, fd: FrameData, Tcw_online=None,
                frame_idx=None):
        """``Tcw_online`` — the device solve's pose before local-map
        refinement; it anchors the raw trajectory and the P_lc
        decomposition (the device computed H with THIS pose, so unmixing
        H into a camera-independent measurement must use it too)."""
        if frame_idx is None:
            frame_idx = self._frame_idx
        m = self.map
        if Tcw_online is None:
            Tcw_online = np.asarray(r.Tcw_cur)
        Twc = np.linalg.inv(np.asarray(r.Tcw_cur))
        m.camera_poses.append(Twc.astype(np.float32))
        m.camera_poses_raw.append(np.linalg.inv(Tcw_online).astype(np.float32))
        m.gt_poses.append(np.asarray(fd.pose_gt, np.float32))
        m.timestamps.append(fd.timestamp)
        m.cam_rpe_abs.append(np.asarray([float(r.cam_t_rpe), float(r.cam_r_rpe)]))
        m.cam_rpe_rel.append(np.asarray([float(r.cam_t_rpe_rel), float(r.cam_r_rpe_rel)]))
        m.flow_hists.append(np.asarray(r.flow_hist))
        m.gt_objs.append(
            {
                int(i): np.asarray(L, np.float32)
                for i, L in zip(fd.obj_ids_gt, fd.obj_poses_gt)
            }
            if fd.obj_ids_gt is not None
            else {}
        )
        ob = r.objects
        # camera-pose factors for the camera-independent P_lc decomposition
        # (the DEVICE pose, not the local-map-refined one: H was solved
        # on-device anchored on Tcw_online)
        Tcw_cur_used = Tcw_online
        Twc_cur_used = np.linalg.inv(Tcw_cur_used)
        Twc_last_used = (
            m.camera_poses[-2] if len(m.camera_poses) >= 2 else np.eye(4, dtype=np.float32)
        )
        Tcw_last_used = np.linalg.inv(Twc_last_used)
        seen = np.asarray(ob.seen)
        active = np.asarray(ob.active)
        m.tot_obj_num.append(int(seen.sum()))

        # persistent ID association (src/Tracking.cc:1556-1635)
        new_map: Dict[int, int] = {}
        mode = np.asarray(ob.mode_last_label)
        for slot in range(len(active)):
            if not active[slot]:
                continue
            sem_label = slot + 1
            prev_sem = int(mode[slot])
            if prev_sem in self._sem_to_track and frame_idx > 1:
                tid = self._sem_to_track[prev_sem]
            else:
                tid = self._next_track_id
                self._next_track_id += 1
            new_map[sem_label] = tid
            m.obj_records.append(
                ObjectRecord(
                    frame=frame_idx,
                    track_id=tid,
                    sem_label=sem_label,
                    H=np.asarray(ob.H[slot]),
                    speed_est=float(ob.speed_est[slot]),
                    speed_gt=float(ob.speed_gt[slot]),
                    t_rpe=float(ob.t_rpe[slot]),
                    r_rpe=float(ob.r_rpe[slot]),
                    t_rpe_rel=float(ob.t_rpe_rel[slot]),
                    r_rpe_rel=float(ob.r_rpe_rel[slot]),
                    speed_err_rel=float(ob.speed_err_rel[slot]),
                    t_rpe_centred=float(ob.t_rpe_centred[slot]),
                    n_points=int(ob.n_points[slot]),
                    n_inliers=int(ob.n_inliers[slot]),
                    centre3d=np.asarray(ob.centre3d[slot]),
                    bbox=np.asarray(ob.bbox[slot]),
                    P_lc=(
                        Tcw_cur_used @ np.asarray(ob.H[slot]) @ Twc_last_used
                    ).astype(np.float32),
                    centre_pre_lc=(
                        Tcw_last_used[:3, :3] @ np.asarray(ob.centre_pre[slot])
                        + Tcw_last_used[:3, 3]
                    ).astype(np.float32),
                    has_gt=bool(ob.has_gt[slot]),
                )
            )
        self._sem_to_track = new_map

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        self.flush()
        m = self.map
        cam = np.asarray(m.cam_rpe_rel) if m.cam_rpe_rel else np.zeros((0, 2))
        # GT-free sequences produce non-finite relative errors (division by
        # a zero GT displacement); report None instead of NaN
        cam = cam[np.isfinite(cam).all(axis=1)] if len(cam) else cam
        objs = [o for o in m.obj_records if o.has_gt]
        return {
            "n_frames": self._frame_idx,
            "cam_t_rpe_rel_mean": float(cam[:, 0].mean()) if len(cam) else None,
            "cam_r_rpe_rel_mean": float(cam[:, 1].mean()) if len(cam) else None,
            # nan-aware: a rare non-finite record (degenerate GT pair or a
            # diverged padded solve) must not poison the aggregates; the
            # count is surfaced separately
            "obj_t_rpe_rel_mean": float(np.nanmean([o.t_rpe_rel for o in objs])) if objs else None,
            "obj_r_rpe_rel_mean": float(np.nanmean([o.r_rpe_rel for o in objs])) if objs else None,
            "obj_speed_err_rel_mean": float(np.nanmean([o.speed_err_rel for o in objs])) if objs else None,
            "obj_nonfinite_records": int(sum(
                not np.isfinite(o.t_rpe_rel) for o in objs
            )),
            "n_obj_estimates": len(m.obj_records),
            "n_loop_closures": len(m.loop_events),
            "ego_ate_rmse_m": self.ate(),
            "ego_ate_rmse_raw_m": self.ate(raw=True),
            "cam_t_rpe_refined_mean": self.refined_pair_rpe(),
            "obj_t_rpe_refined_mean": self.refined_obj_metrics()[0],
            "mean_frame_time_s": float(np.mean(m.frame_times)) if m.frame_times else None,
            "median_frame_time_s": float(np.median(m.frame_times)) if m.frame_times else None,
        }

    def ate(self, raw: bool = False):
        """Ego ATE-RMSE vs ground truth after rigid alignment (BASELINE
        metric alongside the per-frame RPE).  ``raw=True`` evaluates the
        online frame-to-frame trajectory before backend refinement."""
        self.flush()
        import jax.numpy as jnp

        from multimot_track_tpu.eval.metrics import absolute_trajectory_error

        m = self.map
        poses = m.camera_poses_raw if raw else m.camera_poses
        if len(poses) < 2 or len(m.gt_poses) != len(poses):
            return None
        # disk GT is camera-to-world relative to its own origin; normalise
        # both trajectories to start at identity
        est = np.stack(poses)
        gt = np.stack(m.gt_poses)
        gt0_inv = np.linalg.inv(gt[0])
        gt = np.einsum("ij,njk->nik", gt0_inv, gt)
        rmse, _ = absolute_trajectory_error(jnp.asarray(est), jnp.asarray(gt))
        return float(rmse)

    def refined_pair_rpe(self):
        """Per-pair camera t-RPE recomputed from the refined trajectory
        (None when refinement never ran or GT is missing)."""
        from multimot_track_tpu.eval import metrics as M

        m = self.map
        if len(m.camera_poses) < 2 or len(m.gt_poses) != len(m.camera_poses):
            return None
        out = []
        for k in range(len(m.camera_poses) - 1):
            Tcw_c = np.linalg.inv(m.camera_poses[k + 1])
            Tcw_l = np.linalg.inv(m.camera_poses[k])
            g_c = np.linalg.inv(m.gt_poses[k + 1])
            g_l = np.linalg.inv(m.gt_poses[k])
            r = M.camera_rpe(
                jnp.asarray(Tcw_c), jnp.asarray(Tcw_l),
                jnp.asarray(g_c), jnp.asarray(g_l),
            )
            out.append(float(r.t_rel))
        out = [v for v in out if np.isfinite(v)]
        return float(np.mean(out)) if out else None

    def refined_obj_metrics(self):
        """Object t-RPE / speed error recomputed against the FINAL (window-
        refined, loop-corrected) trajectory from each record's camera-
        independent measurement P_lc: H = Twc_cur P_lc Tcw_last.  The
        device-side numbers use the online pose of their moment; after the
        backend rewrites the trajectory this is the consistent evaluation
        (and the honest one for the 'with backend' PARITY row)."""
        from multimot_track_tpu.eval import metrics as M

        m = self.map
        t_rels, sp_errs = [], []
        for rec in m.obj_records:
            if not rec.has_gt or rec.P_lc is None:
                continue
            f = rec.frame
            if f < 1 or f >= len(m.camera_poses) or f >= len(m.gt_objs):
                continue
            gl, gc = m.gt_objs[f - 1], m.gt_objs[f]
            oid = rec.sem_label
            if oid not in gl or oid not in gc:
                continue
            Twc_l = m.camera_poses[f - 1]
            Twc_c = m.camera_poses[f]
            H = Twc_c @ rec.P_lc @ np.linalg.inv(Twc_l)
            L_w_p = m.gt_poses[f - 1] @ gl[oid]
            L_w_c = m.gt_poses[f] @ gc[oid]
            H_gt = L_w_c @ np.linalg.inv(L_w_p)
            cpre_w = Twc_l[:3, :3] @ rec.centre_pre_lc + Twc_l[:3, 3]
            e = M.object_motion_error(
                jnp.asarray(H.astype(np.float32)),
                jnp.asarray(H_gt.astype(np.float32)),
                jnp.asarray(cpre_w.astype(np.float32)),
                jnp.asarray(L_w_p[:3, 3].astype(np.float32)),
                jnp.asarray(L_w_c[:3, 3].astype(np.float32)),
            )
            if np.isfinite(float(e.t_rel)):
                t_rels.append(float(e.t_rel))
                sp_errs.append(float(e.speed_err_rel))
        if not t_rels:
            return None, None
        return float(np.mean(t_rels)), float(np.mean(sp_errs))

    # ------------------------------------------------------------------
    def save_trajectory_kitti(self, path):
        """3x4 row-major Twc per line (src/System.cc:600-664)."""
        self.flush()
        with open(path, "w") as f:
            for T in self.map.camera_poses:
                f.write(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1)) + "\n")

    def save_trajectory_tum(self, path):
        """timestamp tx ty tz qx qy qz qw (src/System.cc:494-561)."""
        self.flush()
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for ts, T in zip(self.map.timestamps, self.map.camera_poses):
                q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x y z w
                t = T[:3, 3]
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_results(self, out_dir):
        """Object-motion + camera results dump (System::SaveResults analog)."""
        import pathlib

        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.save_trajectory_kitti(out / "camera_pose.txt")
        # per-frame / per-object error dump (reference SaveResults writes
        # the Map error stores similarly, src/System.cc:326-492)
        with open(out / "metrics.txt", "w") as f:
            s = self.summary()
            for k, v in s.items():
                f.write(f"# {k}: {v}\n")
            for i, r in enumerate(self.map.cam_rpe_rel):
                f.write(f"cam_rpe {i + 1} {r[0]:.6f} {r[1]:.6f}\n")
            for o in self.map.obj_records:
                f.write(
                    f"obj_rpe {o.frame} {o.track_id} {o.t_rpe_rel:.6f} "
                    f"{o.r_rpe_rel:.6f} {o.speed_err_rel:.6f}\n"
                )
        with open(out / "object_motion.txt", "w") as f:
            for o in self.map.obj_records:
                f.write(
                    f"{o.frame} {o.track_id} {o.sem_label} "
                    + " ".join(f"{v:.9e}" for v in o.H[:3].reshape(-1))
                    + f" {o.speed_est:.4f}\n"
                )


def run_sequence(seq, cfg: PipelineConfig = DEFAULT_CONFIG, n_frames: Optional[int] = None,
                 verbose: bool = False):
    """Drive a KittiSequence end-to-end (reference rgbd_mmt main loop).

    Frame i+1 is loaded, packed and its transfers enqueued on a prefetch
    thread while frame i is being tracked — the wire upload overlaps the
    solve."""
    from concurrent.futures import ThreadPoolExecutor

    sys_ = MultiMotSystem(cfg)
    n = len(seq) if n_frames is None else min(n_frames, len(seq))
    pool = ThreadPoolExecutor(1)

    def prep(i):
        fd = seq.load_frame(i)
        return fd, sys_.upload(fd)

    fut = pool.submit(prep, 0)
    for i in range(n):
        fd, handles = fut.result()
        if i + 1 < n:
            fut = pool.submit(prep, i + 1)
        r = sys_.track_rgbd(fd, uploaded=handles)
        if verbose and r is not None:
            print(
                f"frame {i}: cam RPE t={float(r.cam_t_rpe_rel)*100:.4f}% "
                f"R={float(r.cam_r_rpe_rel):.4f}deg/m "
                f"inliers={int(r.n_static_inliers)}/{int(r.n_static)} "
                f"objects={int(np.asarray(r.objects.active).sum())}"
            )
    return sys_
