"""Keyframe store, place recognition, relocalization, loop closing.

Covers the roles of the reference's KeyFrame/KeyFrameDatabase/LoopClosing
stack (src/KeyFrame.cc, src/KeyFrameDatabase.cc:DetectLoopCandidates /
DetectRelocalizationCandidates, src/LoopClosing.cc): a fixed-capacity
array-of-struct keyframe buffer; place recognition by *direct descriptor
matching* (one bf16 matmul against every stored keyframe — at keyframe
scale this outperforms an inverted BoW index and needs no vocabulary
file, cf. the reference's seconds-long ORBvoc.txt load, src/System.cc:67);
relocalization via depth-free RANSAC PnP (the reference's EPnP path,
src/Tracking.cc:3614-3776); loop correction via Sim3 alignment + pose
graph (LoopClosing::ComputeSim3/CorrectLoop).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multimot_track_tpu.geometry import camera as cam_g
from multimot_track_tpu.geometry import se3
from multimot_track_tpu.ops import matching
from multimot_track_tpu.solvers import pnp, pose_graph, sim3
from multimot_track_tpu.solvers.ransac import _count_inliers, _gn_refine_stereo


@functools.partial(jax.jit, static_argnames=("gn_iters", "rounds"))
def local_map_refine(
    T_init: jnp.ndarray,        # (4, 4) Tcw init (the flow-BA pose)
    Xw: jnp.ndarray,            # (M, 3) local map points, world frame
    desc_map: jnp.ndarray,      # (M, 256)
    valid_map: jnp.ndarray,     # (M,)
    uv_cur: jnp.ndarray,        # (N, 2) current-frame keypoints
    desc_cur: jnp.ndarray,      # (N, 256)
    valid_cur: jnp.ndarray,     # (N,)
    z_cur: jnp.ndarray,         # (N,) measured depth of current keypoints
    fx, fy, cx, cy, width, height, bf,
    radius: float = 12.0,
    thresh: float = 3.0,
    gn_iters: int = 8,
    rounds: int = 2,
    depth_weight_z0: float = 15.0,
):
    """Pose refinement against the accumulated local map
    (Tracking::TrackLocalMap, src/Tracking.cc:3189: SearchLocalPoints'
    projection-guided matching -> PoseOptimization on the matches).

    Projects every map point with the init pose, matches descriptors
    within ``radius`` px of the prediction, then alternates weighted
    Gauss-Newton with inlier re-classification (the reference's 4-round
    PoseOptimization outlier gating, src/Optimizer.cc:3263-3305).

    Returns (T_refined, n_inliers, n_matches)."""
    y = se3.transform(T_init, Xw)
    uv_pred = cam_g.project(y, fx, fy, cx, cy)
    in_view = (
        (y[..., 2] > 0.5)
        & (uv_pred[..., 0] >= 0) & (uv_pred[..., 0] < width)
        & (uv_pred[..., 1] >= 0) & (uv_pred[..., 1] < height)
    )
    res = matching.match_projected(
        desc_map, uv_pred, valid_map & in_view,
        desc_cur, uv_cur, valid_cur, radius=radius,
    )
    # Uniqueness: the stacked keyframes carry duplicate copies of the same
    # physical landmark (multiple detection levels / keyframes), and
    # several copies can match ONE current keypoint — stacking GN weight
    # and inflating the inlier count the acceptance gate reads.  The
    # reference associates each current keypoint to at most one map point
    # (SearchLocalPoints); match that: keep the best-distance copy per
    # current keypoint (index as tie-break; identical copies tie exactly).
    M = res.idx.shape[0]
    key = jnp.where(res.valid, res.dist, 1e6) * (M + 1.0) + jnp.arange(M, dtype=jnp.float32)
    best_key = jnp.full((uv_cur.shape[0],), 1e12, jnp.float32).at[res.idx].min(key)
    matched = res.valid & (key <= best_key[res.idx])
    uv_obs = uv_cur[res.idx]
    z_obs = z_cur[res.idx]
    has_depth = matched & (z_obs > 0.25)
    disp_obs = bf / jnp.maximum(z_obs, 0.25)
    # per-point depth-variance weight on the disparity row (sigma_z ~ z^2,
    # the same model as SolverConfig.cam_depth_weight_z0 for the ego edges)
    w_disp = has_depth.astype(jnp.float32) / (
        1.0 + (z_obs / depth_weight_z0) ** 2
    )
    T = T_init

    def huber_w(T):
        """IRLS Huber weights at delta = thresh over ALL matches — the
        first optimization round must see every match (the init may sit
        outside the inlier gate; the reference's PoseOptimization also
        starts on all edges and chi2-gates only BETWEEN rounds,
        src/Optimizer.cc:3263-3305)."""
        y = se3.transform(T, Xw)
        r = jnp.linalg.norm(cam_g.project(y, fx, fy, cx, cy) - uv_obs, axis=-1)
        w = jnp.minimum(1.0, thresh / jnp.maximum(r, 1e-6))
        return matched.astype(jnp.float32) * w * (y[..., 2] > 0)

    for _ in range(rounds):
        T = _gn_refine_stereo(
            T, Xw, uv_obs, disp_obs, huber_w(T), w_disp, gn_iters, fx, fy, cx, cy, bf
        )
    inl, n = _count_inliers(T, Xw, uv_obs, matched, thresh, fx, fy, cx, cy)
    for _ in range(rounds):
        T = _gn_refine_stereo(
            T, Xw, uv_obs, disp_obs, inl.astype(jnp.float32), w_disp,
            gn_iters, fx, fy, cx, cy, bf,
        )
        inl, n = _count_inliers(T, Xw, uv_obs, matched, thresh, fx, fy, cx, cy)
    return T, n, jnp.sum(matched.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("width", "height"))
def _fuse_scan(
    Tcw_new, desc_new, uv_new, valid_new, Xw_new,       # the new keyframe
    Xw_prev, desc_prev, valid_prev,                     # stacked prev (L, N, ...)
    fx, fy, cx, cy, width, height,
    radius: float = 6.0,
    rel3d: float = 0.02,
):
    """Duplicate-landmark detection of ``L`` previous keyframes against the
    new one, all in ONE dispatch (the ORBmatcher::Fuse projection pass,
    src/ORBmatcher.cc, driven from SearchInNeighbors,
    src/LocalMapping.cc:458).  A previous point that projects into the new
    view, matches a new descriptor within ``radius`` px AND whose stored
    3-D position agrees to ``rel3d * z`` is the same landmark.

    Returns ONE packed (3, L, N) int32 array — [dup, in_view, new_idx] —
    so the caller fetches a single buffer (each device->host transfer is
    a full round trip through the serving link)."""

    def one(Xw_l, desc_l, valid_l):
        y = se3.transform(Tcw_new, Xw_l)
        uv_pred = cam_g.project(y, fx, fy, cx, cy)
        in_view = (
            valid_l & (y[..., 2] > 0.5)
            & (uv_pred[..., 0] >= 0) & (uv_pred[..., 0] < width)
            & (uv_pred[..., 1] >= 0) & (uv_pred[..., 1] < height)
        )
        res = matching.match_projected(
            desc_l, uv_pred, in_view, desc_new, uv_new, valid_new,
            radius=radius,
        )
        d3 = jnp.linalg.norm(Xw_new[res.idx] - Xw_l, axis=-1)
        dup = res.valid & (d3 < rel3d * jnp.maximum(y[..., 2], 0.5))
        return dup, in_view, res.idx

    dup, in_view, idx = jax.vmap(one)(Xw_prev, desc_prev, valid_prev)
    return jnp.stack(
        [dup.astype(jnp.int32), in_view.astype(jnp.int32), idx]
    )


@jax.jit
def _batched_match_counts(desc_q, valid_q, desc_stack, valid_stack):
    """(K,) mutual-match counts of one query against a keyframe stack —
    the whole KeyFrameDatabase scoring pass as one program."""

    def one(desc_kf, valid_kf):
        res = matching.match_descriptors(desc_q, desc_kf, valid_q, valid_kf)
        return jnp.sum(res.valid.astype(jnp.int32))

    return jax.vmap(one)(desc_stack, valid_stack)


@jax.jit
def _adjacent_match_counts(desc_stack, valid_stack):
    """(K-1,) covisibility weights of consecutive keyframe pairs in one
    dispatch (KeyFrame::UpdateConnections for the temporal chain)."""

    def one(da, va, db, vb):
        res = matching.match_descriptors(da, db, va, vb, threshold=50.0)
        return jnp.sum(res.valid.astype(jnp.int32))

    return jax.vmap(one)(
        desc_stack[:-1], valid_stack[:-1], desc_stack[1:], valid_stack[1:]
    )


@dataclasses.dataclass
class Keyframe:
    index: int                 # frame index in the sequence
    Tcw: np.ndarray            # (4, 4)
    uv: np.ndarray             # (N, 2) keypoints
    desc: np.ndarray           # (N, 256) int8 sign-form descriptors
    valid: np.ndarray          # (N,)
    Xw: np.ndarray             # (N, 3) world points (from depth at capture)
    # map-point lifecycle (MapPoint::IncreaseVisible/IncreaseFound + SetBadFlag,
    # src/MapPoint.cc).  ``valid`` stays the FEATURE mask (descriptors exist;
    # place recognition and covisibility use every feature, exactly as the
    # reference's BoW vectors outlive map-point culling); ``live`` is the
    # map-POINT mask that fusion/culling clears — only 3-D consumers
    # (local map, reloc PnP, Sim3) are restricted to live points.
    seen: np.ndarray = None    # (N,) int32 — times projected into a new KF
    found: np.ndarray = None   # (N,) int32 — times re-matched there
    live: np.ndarray = None    # (N,) bool — not fused away / not culled
    bad: np.ndarray = None     # (N,) bool — culled (geometry untrustworthy);
    #                            fused points stay geometry-valid for
    #                            Sim3/reloc, they are merely redundant

    def __post_init__(self):
        if self.seen is None:
            self.seen = np.ones(self.valid.shape[0], np.int32)
        if self.found is None:
            self.found = np.ones(self.valid.shape[0], np.int32)
        if self.live is None:
            self.live = self.valid.copy()
        if self.bad is None:
            self.bad = np.zeros(self.valid.shape[0], bool)


class KeyframeStore:
    """Host-side list of device-friendly keyframe arrays (the functional
    replacement for the mutex-guarded KeyFrame pointer graph)."""

    def __init__(self, capacity: int = 64, min_gap: int = 5,
                 bow_threshold: int = 48, bow_shortlist: int = 8):
        self.capacity = capacity
        self.min_gap = min_gap
        self.frames: List[Keyframe] = []
        self._version = 0            # bumped on any mutation; keys the caches
        # bumped only when frame MEMBERSHIP changes (add/evict/cull):
        # descriptor stacks depend on membership alone, and re-uploading
        # megabytes of descriptors because a lifecycle bit flipped was the
        # dominant hidden keyframe-cadence serving cost
        self._struct_version = 0
        self._local_cache = None     # local_map arrays, keyed on version
        self._stack_cache = None     # descriptor stack, keyed on version
        # BoW-scale retrieval (ops/bow, the DBoW2/KeyFrameDatabase role):
        # above `bow_threshold` stored keyframes, place recognition runs a
        # TF-IDF signature matvec first and exact descriptor matching only
        # on the `bow_shortlist` best candidates — sub-linear in exact work
        self.bow_threshold = bow_threshold
        self.bow_shortlist = bow_shortlist
        self._voc = None             # trained lazily at the threshold
        self._sigs: dict = {}        # id(kf) -> (V,) signature
        # host-array -> device-array cache: keyframe payloads (desc, Xw,
        # valid) upload ONCE and are stacked/concatenated on device.  The
        # host array is retained alongside the device copy so its id()
        # cannot be recycled while the cache entry lives.
        self._dev_arrays: dict = {}

    def _dev(self, arr: np.ndarray) -> jnp.ndarray:
        e = self._dev_arrays.get(id(arr))
        if e is not None and e[0] is arr:
            return e[1]
        dev = jnp.asarray(arr)
        self._dev_arrays[id(arr)] = (arr, dev)
        if len(self._dev_arrays) > 4 * max(len(self.frames), 8) + 16:
            keep = set()
            for kf in self.frames:
                keep.update((id(kf.desc), id(kf.Xw), id(kf.valid)))
            self._dev_arrays = {
                k: v for k, v in self._dev_arrays.items() if k in keep
            }
            self._dev_arrays[id(arr)] = (arr, dev)
        return dev

    def maybe_add(self, kf: Keyframe) -> bool:
        if self.frames and kf.index - self.frames[-1].index < self.min_gap:
            return False
        self.frames.append(kf)
        if len(self.frames) > self.capacity:
            self._evict_skeleton()
        self._version += 1
        self._struct_version += 1
        return True

    def _evict_skeleton(self):
        """Capacity eviction that preserves loop anchors: instead of
        dropping the OLDEST keyframe (FIFO would silently evict the
        revisit anchor of any loop longer than ~min_gap*capacity frames,
        making closure structurally impossible), drop the keyframe whose
        removal least widens the temporal coverage — the middle of the
        densest (index-space) triple.  Old map regions stay represented at
        progressively coarser sampling (a covisibility-sparse skeleton:
        the bounded-memory equivalent of the reference's unbounded Map,
        /root/reference/src/Map.cc, include/Map.h:43-90).  The first
        keyframe (map origin) and the newest quarter (the live local-map
        window) are never evicted."""
        n = len(self.frames)
        protect_tail = max(2, self.capacity // 4)
        lo, hi = 1, n - protect_tail  # candidate victims: frames[lo:hi]
        if hi <= lo:
            self.frames.pop(0)
            return
        idx = [kf.index for kf in self.frames]
        victim = min(
            range(lo, hi), key=lambda i: idx[i + 1] - idx[i - 1]
        )
        self.frames.pop(victim)

    def correct_poses(self, new_Tcw: List[np.ndarray]):
        """Rewrite every keyframe pose after a trajectory correction (loop
        closure), re-anchoring the stored world points: the points were
        back-projected through the OLD pose, so they must move with the
        keyframe or relocalization/local-map tracking would keep serving
        the pre-correction world frame (LoopClosing::CorrectLoop moves the
        map points with their reference keyframes the same way,
        src/LoopClosing.cc:460-520)."""
        assert len(new_Tcw) == len(self.frames)
        for kf, Tcw_new in zip(self.frames, new_Tcw):
            Xc = (kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3]
            Twc_new = np.linalg.inv(Tcw_new)
            kf.Xw = ((Twc_new[:3, :3] @ Xc.T).T + Twc_new[:3, 3]).astype(np.float32)
            kf.Tcw = Tcw_new.astype(np.float32)
        self._version += 1

    # ------------------------------------------------------------------
    def local_map(self, n_kf: int = 3, max_depth: float = 35.0):
        """Stacked (Xw, desc, valid) of the newest ``n_kf`` keyframes — the
        local map for TrackLocalMap-style refinement (the covisible set: on
        a vehicle trajectory the newest keyframes ARE the covisibility
        neighbours, KeyFrame::GetBestCovisibilityKeyFrames' role).  Points
        are gated to ``max_depth`` in their own keyframe's camera (stereo
        depth error grows ~z^2 — the same gate relocalize uses).  Device
        arrays are cached until the store mutates."""
        sig = (self._version, n_kf, max_depth)
        if self._local_cache is not None and self._local_cache[0] == sig:
            return self._local_cache[1]
        kfs = self.frames[-n_kf:]
        # per-keyframe payloads stay device-cached (_dev); only the small
        # combined mask re-uploads when a lifecycle bit flips — the
        # megabyte-scale Xw/desc re-upload per keyframe was a dominant
        # keyframe-cadence serving cost through the link
        Xw = jnp.concatenate([self._dev(kf.Xw) for kf in kfs], axis=0)
        desc = jnp.concatenate([self._dev(kf.desc) for kf in kfs], axis=0)
        valid = []
        for kf in kfs:
            z = ((kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3])[:, 2]
            valid.append(kf.valid & kf.live & (z > 0) & (z < max_depth))
        valid = jnp.asarray(np.concatenate(valid, axis=0))
        arrays = (Xw, desc, valid)
        self._local_cache = (sig, arrays)
        return arrays

    def track_local_map(
        self,
        Tcw_init: np.ndarray,
        uv_cur, desc_cur, valid_cur, z_cur,
        fx, fy, cx, cy, width, height, bf,
        n_kf: int = 3,
        radius: float = 12.0,
        thresh: float = 3.0,
        max_depth: float = 35.0,
    ) -> Tuple[np.ndarray, int, int]:
        """TrackLocalMap (src/Tracking.cc:3189): refine ``Tcw_init``
        against the local map.  Returns (T, n_inliers, n_matches); the
        caller applies its acceptance gates."""
        Xw, desc_m, valid_m = self.local_map(n_kf=n_kf, max_depth=max_depth)
        T, n_inl, n_match = local_map_refine(
            jnp.asarray(Tcw_init), Xw, desc_m, valid_m,
            uv_cur, desc_cur, valid_cur, z_cur,
            fx, fy, cx, cy, width, height, bf,
            radius=radius, thresh=thresh,
        )
        return np.asarray(T), int(n_inl), int(n_match)

    # ------------------------------------------------------------------
    def _stacked_descriptors(self):
        """(K_pad, N, 256) device-resident descriptor stack of the whole
        store, padded to the next power of two along K (bounds the number
        of distinct compiled shapes) with zero-valid rows; cached until the
        store mutates.  Requires homogeneous keypoint counts (the system
        always extracts a fixed n_total)."""
        sig = self._struct_version
        if self._stack_cache is not None and self._stack_cache[0] == sig:
            return self._stack_cache[1]
        K = len(self.frames)
        if K == 0 or len({kf.desc.shape[0] for kf in self.frames}) != 1:
            return None
        K_pad = 1 << (K - 1).bit_length()
        # stack device-cached per-keyframe descriptors (each uploads once,
        # at capture); padding rows are device zeros — no host re-upload
        pad_d = jnp.zeros(self.frames[0].desc.shape, self.frames[0].desc.dtype)
        pad_v = jnp.zeros(self.frames[0].valid.shape, bool)
        desc = jnp.stack(
            [self._dev(kf.desc) for kf in self.frames]
            + [pad_d] * (K_pad - K)
        )
        valid = jnp.stack(
            [self._dev(kf.valid) for kf in self.frames]
            + [pad_v] * (K_pad - K)
        )
        arrays = (desc, valid)
        self._stack_cache = (sig, arrays)
        return arrays

    def _bow_signature(self, desc, valid) -> np.ndarray:
        from multimot_track_tpu.ops import bow

        if self._voc is None:
            # train once from the store's early descriptors (DBoW2 trains
            # its vocabulary offline; on-the-fly from the live scene works
            # because retrieval only ranks within this same scene)
            train = np.concatenate([kf.desc for kf in self.frames[:8]], axis=0)
            tval = np.concatenate([kf.valid for kf in self.frames[:8]], axis=0)
            self._voc = bow.train_vocabulary(
                jax.random.PRNGKey(0), jnp.asarray(train), jnp.asarray(tval)
            )
        return np.asarray(bow.signature(self._voc, desc, valid))

    def _bow_scores(self, desc, valid, K: int) -> np.ndarray:
        """Two-stage retrieval (KeyFrameDatabase::DetectLoopCandidates at
        DBoW2 scale): TF-IDF signature matvec over ALL keyframes, exact
        descriptor match-counts only on the best ``bow_shortlist``."""
        from multimot_track_tpu.ops import bow

        q = self._bow_signature(desc, valid)
        sigs = []
        for kf in self.frames[:K]:
            s = self._sigs.get(id(kf))
            if s is None:
                s = self._bow_signature(jnp.asarray(kf.desc), jnp.asarray(kf.valid))
                self._sigs[id(kf)] = s
            sigs.append(s)
        sim = np.asarray(bow.retrieve(jnp.asarray(q), jnp.asarray(np.stack(sigs))))
        short = np.argsort(sim)[::-1][: self.bow_shortlist]
        scores = np.zeros(K, np.int32)
        for k in short:
            kf = self.frames[int(k)]
            res = matching.match_descriptors(
                desc, jnp.asarray(kf.desc), valid, jnp.asarray(kf.valid)
            )
            scores[int(k)] = int(jnp.sum(res.valid))
        return scores

    def similarity_scores(
        self, desc: jnp.ndarray, valid: jnp.ndarray, exclude_last: int = 2
    ) -> np.ndarray:
        """Match count against every stored keyframe (place recognition).

        Small stores: all keyframes scored in ONE device dispatch (a
        vmapped matmul over the cached descriptor stack).  Above
        ``bow_threshold`` keyframes: BoW two-stage retrieval (``ops/bow``,
        the DBoW2 inverted-index role) — exact scores only for the
        signature shortlist, zeros elsewhere."""
        K = len(self.frames) - exclude_last
        if K <= 0:
            return np.zeros(max(K, 0), np.int32)
        if len(self.frames) > self.bow_threshold:
            return self._bow_scores(desc, valid, K)
        stacked = self._stacked_descriptors()
        if stacked is None:   # heterogeneous store (test-built): slow path
            scores = np.zeros(K, np.int32)
            for k, kf in enumerate(self.frames[:K]):
                res = matching.match_descriptors(
                    desc, jnp.asarray(kf.desc), valid, jnp.asarray(kf.valid)
                )
                scores[k] = int(jnp.sum(res.valid))
            return scores
        counts = _batched_match_counts(desc, valid, *stacked)
        return np.asarray(counts[:K])

    def detect_loop(
        self, desc: jnp.ndarray, valid: jnp.ndarray, min_matches: int = 40
    ) -> Optional[int]:
        """Best loop candidate index into ``frames`` (DetectLoopCandidates)."""
        if len(self.frames) <= 3:
            return None
        scores = self.similarity_scores(desc, valid)
        if scores.size == 0 or scores.max() < min_matches:
            return None
        return int(scores.argmax())

    # ------------------------------------------------------------------
    def covisibility(self, i: int, j: int, threshold: float = 50.0) -> int:
        """Shared-observation count between stored keyframes i and j — the
        covisibility-graph weight (KeyFrame::UpdateConnections)."""
        a, b = self.frames[i], self.frames[j]
        res = matching.match_descriptors(
            jnp.asarray(a.desc), jnp.asarray(b.desc),
            jnp.asarray(a.valid), jnp.asarray(b.valid),
            threshold=threshold,
        )
        return int(jnp.sum(res.valid))

    def fuse_and_cull(
        self,
        fx, fy, cx, cy, width, height,
        n_prev: int = 4,
        radius: float = 6.0,
        rel3d: float = 0.02,
        cull_min_seen: int = 3,
        cull_ratio: float = 0.25,
    ) -> Tuple[int, int]:
        """Map-point lifecycle at keyframe cadence: duplicate-landmark
        fusion + bad-point culling (LocalMapping::SearchInNeighbors ->
        ORBmatcher::Fuse, src/LocalMapping.cc:458, and MapPointCulling,
        src/LocalMapping.cc:173).

        The newest keyframe is matched against the previous ``n_prev``
        (one batched device dispatch).  A previous copy of a landmark the
        new keyframe re-observes is invalidated — the store keeps exactly
        one live copy, the newest measurement — and its found-count is
        credited to the survivor (the reference keeps the most-observed
        copy; on a forward-moving rig the newest view has the smallest
        depth variance, so newest == best here).  Points repeatedly
        projected into new keyframes but never re-found decay and are
        culled at the reference's 0.25 found-ratio.

        Returns (n_fused, n_culled)."""
        if len(self.frames) < 2:
            return 0, 0
        new = self.frames[-1]
        prevs = self.frames[max(0, len(self.frames) - 1 - n_prev):-1]
        if len({kf.desc.shape[0] for kf in prevs} | {new.desc.shape[0]}) != 1:
            return 0, 0    # heterogeneous store (test-built): skip
        packed = np.asarray(_fuse_scan(
            jnp.asarray(new.Tcw), self._dev(new.desc), jnp.asarray(new.uv),
            self._dev(new.valid), self._dev(new.Xw),
            jnp.stack([self._dev(kf.Xw) for kf in prevs]),
            jnp.stack([self._dev(kf.desc) for kf in prevs]),
            jnp.asarray(np.stack([kf.valid & kf.live for kf in prevs])),
            fx, fy, cx, cy, width, height, radius, rel3d,
        ))
        return self.apply_fuse(packed, prevs, new,
                               cull_min_seen=cull_min_seen,
                               cull_ratio=cull_ratio)

    def dispatch_fuse(self, Tcw_new, desc_new, uv_new, valid_new, Xw_new,
                      fx, fy, cx, cy, width, height,
                      n_prev: int = 4, radius: float = 6.0,
                      rel3d: float = 0.02):
        """Async half of :meth:`fuse_and_cull`: dispatch the fuse scan of a
        NOT-YET-ADDED keyframe's device arrays against the newest stored
        keyframes; returns (device handle, prevs list) — fetch later and
        feed :meth:`apply_fuse` (the new keyframe must be added first)."""
        prevs = self.frames[-n_prev:]
        if not prevs or len(
            {kf.desc.shape[0] for kf in prevs} | {int(desc_new.shape[0])}
        ) != 1:
            return None, []
        handle = _fuse_scan(
            Tcw_new, desc_new, uv_new, valid_new, Xw_new,
            jnp.stack([self._dev(kf.Xw) for kf in prevs]),
            jnp.stack([self._dev(kf.desc) for kf in prevs]),
            jnp.asarray(np.stack([kf.valid & kf.live for kf in prevs])),
            fx, fy, cx, cy, width, height, radius, rel3d,
        )
        return handle, prevs

    def apply_fuse(self, packed, prevs, new,
                   cull_min_seen: int = 3, cull_ratio: float = 0.25):
        """Host bookkeeping of a fetched fuse scan (see fuse_and_cull)."""
        dup = packed[0].astype(bool)
        in_view = packed[1].astype(bool)
        idx = packed[2]
        n_fused = n_culled = 0
        for l, kf in enumerate(prevs):
            d, v, ix = dup[l], in_view[l], idx[l]
            kf.seen = kf.seen + v.astype(np.int32)
            kf.found = kf.found + d.astype(np.int32)
            # fusion: newest copy survives, inherits the observation count
            np.add.at(new.found, ix[d], kf.found[d])
            kf.live = kf.live & ~d
            n_fused += int(d.sum())
            # culling: often visible, rarely re-found (found-ratio < 0.25)
            cull = (
                kf.live
                & (kf.seen >= cull_min_seen)
                & (kf.found < cull_ratio * kf.seen)
            )
            kf.live = kf.live & ~cull
            kf.bad = kf.bad | cull
            n_culled += int(cull.sum())
        if n_fused or n_culled:
            self._version += 1
        return n_fused, n_culled

    def n_live_points(self) -> int:
        """Total live map points across the store (lifecycle observability)."""
        return int(sum((kf.valid & kf.live).sum() for kf in self.frames))

    def cull_redundant(self, overlap: float = 0.9, counts=None) -> int:
        """Drop keyframes ~fully covisible with both neighbours
        (LocalMapping::KeyFrameCulling's 90% redundancy rule).  Returns the
        number culled.

        All adjacent covisibility weights are computed in ONE device
        dispatch over the cached descriptor stack; culling is one marking
        pass that never removes two adjacent keyframes in the same sweep
        (so the weights stay valid without re-matching after each pop —
        the next sweep sees the new adjacency)."""
        K = len(self.frames)
        if K < 3:
            return 0
        if counts is not None:          # async path: precomputed weights
            c = np.asarray(counts)[: K - 1]
        else:
            stacked = self._stacked_descriptors()
            if stacked is not None:
                c = np.asarray(_adjacent_match_counts(*stacked)[: K - 1])
            else:  # heterogeneous store (test-built): per-pair fallback
                c = np.asarray([self.covisibility(k, k + 1) for k in range(K - 1)])
        drop = []
        k = 1
        while k < K - 1:
            n_own = max(int(self.frames[k].valid.sum()), 1)
            if c[k - 1] > overlap * n_own and c[k] > overlap * n_own:
                drop.append(k)
                k += 2   # keep the neighbour: its weights just changed
            else:
                k += 1
        for k in reversed(drop):
            self.frames.pop(k)
        if drop:
            self._version += 1
            self._struct_version += 1
        return len(drop)

    def triangulate_between(
        self, i: int, j: int, fx, fy, cx, cy, max_reproj_px: float = 2.0
    ):
        """Create new world points from descriptor matches between two
        keyframes (LocalMapping::CreateNewMapPoints' role).  Returns
        (Xw (N, 3), valid (N,)) aligned with keyframe i's keypoint slots."""
        from multimot_track_tpu.solvers.initializer import triangulate
        from multimot_track_tpu.geometry import camera as cam_g

        a, b = self.frames[i], self.frames[j]
        res = matching.match_descriptors(
            jnp.asarray(a.desc), jnp.asarray(b.desc),
            jnp.asarray(a.valid), jnp.asarray(b.valid),
        )
        Kmat = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        P1 = Kmat @ a.Tcw[:3]
        P2 = Kmat @ b.Tcw[:3]
        uv_b = b.uv[np.asarray(res.idx)]
        X = np.asarray(
            triangulate(jnp.asarray(P1), jnp.asarray(P2),
                        jnp.asarray(a.uv), jnp.asarray(uv_b.astype(np.float32)))
        )
        # cheirality + reprojection gates
        Xc1 = (a.Tcw[:3, :3] @ X.T).T + a.Tcw[:3, 3]
        Xc2 = (b.Tcw[:3, :3] @ X.T).T + b.Tcw[:3, 3]
        uv1_hat = np.asarray(cam_g.project(jnp.asarray(Xc1), fx, fy, cx, cy))
        err = np.linalg.norm(uv1_hat - a.uv, axis=-1)
        ok = (
            np.asarray(res.valid)
            & (Xc1[:, 2] > 0)
            & (Xc2[:, 2] > 0)
            & np.isfinite(X).all(1)
            & (err < max_reproj_px)
        )
        return X.astype(np.float32), ok

    # ------------------------------------------------------------------
    def relocalize(
        self,
        key: jax.Array,
        desc: jnp.ndarray,
        uv: jnp.ndarray,
        valid: jnp.ndarray,
        fx, fy, cx, cy,
        min_inliers: int = 15,
        max_depth: float = 35.0,
    ) -> Optional[np.ndarray]:
        """Recover a camera pose from descriptors alone
        (Tracking::Relocalization ladder: candidates -> PnP RANSAC).

        Matched map points are gated to ``max_depth`` metres in the
        keyframe's own camera: stereo-disparity depth error grows as
        z^2/bf, and far points measured 200+ px of reprojection error on
        real frames — they poison the PnP hypothesis set (measured:
        1.24 m reloc error ungated vs 0.38 m gated on kitti_sample)."""
        if not self.frames:
            return None
        scores = self.similarity_scores(desc, valid, exclude_last=0)
        order = np.argsort(scores)[::-1][:3]
        for k in order:
            kf = self.frames[int(k)]
            res = matching.match_descriptors(
                desc, jnp.asarray(kf.desc), valid, jnp.asarray(kf.valid)
            )
            Xw = jnp.asarray(kf.Xw)[res.idx]
            Xc_kf = (kf.Tcw[:3, :3] @ np.asarray(Xw).T).T + kf.Tcw[:3, 3]
            z = jnp.asarray(Xc_kf[:, 2])
            good = jnp.asarray(~kf.bad)[res.idx]
            ok = res.valid & good & (z > 0) & (z < max_depth)
            sol = pnp.ransac_pnp(
                key, Xw, uv, ok, fx, fy, cx, cy,
            )
            if int(sol.n_inliers) >= min_inliers:
                return np.asarray(sol.T)
            if int(jnp.sum(ok)) < int(jnp.sum(res.valid & good)):
                # near set too thin for PnP: retry without the depth gate
                # (an ungated pose beats the LOST velocity fallback) —
                # but never with geometry-bad points (mono marks
                # untriangulated slots bad; their Xw is meaningless)
                sol = pnp.ransac_pnp(key, Xw, uv, res.valid & good, fx, fy, cx, cy)
                if int(sol.n_inliers) >= min_inliers:
                    return np.asarray(sol.T)
        return None

    # ------------------------------------------------------------------
    def close_loop(
        self,
        key: jax.Array,
        cur: Keyframe,
        cand_idx: int,
        trajectory: np.ndarray,     # (M, 4, 4) Tcw of ALL frames so far
        kf_to_traj: List[int],      # trajectory row of each stored keyframe
        fx, fy, cx, cy,
        fix_scale: bool = True,
        info: Optional[dict] = None,
        max_corr_frac: float = 0.2,
    ) -> Tuple[np.ndarray, int]:
        """Sim3-verify the loop and correct the trajectory with a pose-graph
        solve (ComputeSim3 + CorrectLoop/OptimizeEssentialGraph).

        ``fix_scale=False`` is the monocular mode (the reference solves a
        full Sim3 there, src/LoopClosing.cc:233 mbFixScale): the Sim3
        scale measures the accumulated monocular scale drift around the
        loop; it is distributed geometrically along the loop segment's
        relative translations before the SE(3) pose-graph solve (the role
        of the reference's Sim3 essential graph).  ``info`` (optional dict)
        receives {"scale": s, "row_scale": (M,) per-row cumulative scale
        correction} for the caller's map re-anchoring.

        Returns (corrected trajectory, n_inliers); n_inliers 0 => rejected.
        """
        kf = self.frames[cand_idx]
        res = matching.match_descriptors(
            jnp.asarray(cur.desc), jnp.asarray(kf.desc),
            jnp.asarray(cur.valid), jnp.asarray(kf.valid),
        )
        # camera-frame points on both sides for Sim3 (RGB-D: scale fixed)
        Xc_cur = (cur.Tcw[:3, :3] @ cur.Xw.T).T + cur.Tcw[:3, 3]
        Xc_kf_full = (kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3]
        Xc_kf = Xc_kf_full[np.asarray(res.idx)]
        # both endpoints need trustworthy 3-D (mono marks untriangulated
        # points bad; RGB-D bad stays empty until culling)
        good = jnp.asarray(~kf.bad)[res.idx] & jnp.asarray(~cur.bad)
        s3 = sim3.ransac_sim3(
            key, jnp.asarray(Xc_cur), jnp.asarray(Xc_kf.astype(np.float32)),
            res.valid & good, fx, fy, cx, cy, fix_scale=fix_scale,
        )
        n = int(s3.n_inliers)
        if n < 20:
            return trajectory, 0
        M = trajectory.shape[0]
        i_old_row = kf_to_traj[cand_idx]
        row_scale = np.ones(M, np.float64)
        s = float(s3.scale) if not fix_scale else 1.0
        if not fix_scale and np.isfinite(s) and 0.2 < s < 5.0:
            # distribute the drift: step i in (i_old, M-1] gets its
            # relative translation scaled by s^(1/n_steps) so the
            # cumulative correction at the loop frame equals s
            n_steps = max(M - 1 - i_old_row, 1)
            gamma = s ** (1.0 / n_steps)
            rels = [
                trajectory[i] @ np.linalg.inv(trajectory[i - 1])
                for i in range(1, M)
            ]
            trajectory = trajectory.copy()
            c = 1.0
            for i in range(1, M):
                if i > i_old_row:
                    c *= gamma
                    rels[i - 1] = rels[i - 1].copy()
                    rels[i - 1][:3, 3] *= gamma
                row_scale[i] = c
                trajectory[i] = (rels[i - 1] @ trajectory[i - 1]).astype(
                    np.float32
                )
        if info is not None:
            info["scale"] = s
            info["row_scale"] = row_scale
        # loop edge: measured relative pose between cur and the old
        # keyframe (scale folded out by the drift distribution above)
        T_rel = np.eye(4, dtype=np.float32)
        T_rel[:3, :3] = np.asarray(s3.R)
        T_rel[:3, 3] = np.asarray(s3.t)
        ij_odo, Z_odo = pose_graph.odometry_edges(jnp.asarray(trajectory))
        i_cur = M - 1
        i_old = kf_to_traj[cand_idx]
        ij = jnp.concatenate(
            [ij_odo, jnp.asarray([[i_cur, i_old]], jnp.int32)], axis=0
        )
        # Z loop = Tcw_cur_corrected relative: T_rel maps cur-cam -> kf-cam;
        # constraint T_i T_j^-1 = T_rel^-1 (cur expressed w.r.t. old)
        Z = jnp.concatenate(
            [Z_odo, jnp.linalg.inv(jnp.asarray(T_rel))[None]], axis=0
        )
        w = jnp.concatenate([jnp.ones(M - 1), jnp.asarray([float(n)])])
        # exact dense GN at keyframe scale; matrix-free CG (O(E) memory)
        # once the trajectory outgrows the dense normal system
        solve = (
            pose_graph.optimize_pose_graph
            if M <= 256
            else pose_graph.optimize_pose_graph_cg
        )
        out = solve(jnp.asarray(trajectory), ij, Z, w)
        corrected = np.asarray(out.poses)
        # drift-plausibility gate: the correction a genuine loop applies
        # is bounded by the odometry drift accumulated around the loop —
        # a correction comparable to the PATH LENGTH itself means the
        # candidate was a repetitive-texture false positive whose Sim3
        # happened to verify (measured on the self-similar avenue scene:
        # false loops implied 20-100 m corrections over similar paths)
        pos = np.stack([np.linalg.inv(T)[:3, 3] for T in trajectory])
        path = float(
            np.sum(np.linalg.norm(np.diff(pos[i_old_row:], axis=0), axis=-1))
        )
        corr_mag = float(np.linalg.norm(
            np.linalg.inv(corrected[-1])[:3, 3] - pos[-1]
        ))
        if corr_mag > max(1.0, max_corr_frac * path):
            if info is not None:
                info["rejected_implausible"] = corr_mag
            return trajectory, 0
        return corrected, n

    # ------------------------------------------------------------------
    def global_ba(
        self,
        fx, fy, cx, cy, bf,
        loop_pair: Optional[Tuple[int, int]] = None,
        max_obs: int = 6,
        iters: int = 25,
        match_radius_px: float = 20.0,
        rel3d: float = 0.05,
        max_corr_m: float = 2.0,
    ) -> Optional[Tuple[List[np.ndarray], dict]]:
        """Full global bundle adjustment over the keyframe graph — the
        post-loop rung the reference runs in a background thread
        (LoopClosing::RunGlobalBundleAdjustment, src/LoopClosing.cc:647 ->
        Optimizer::GlobalBundleAdjustemnt, src/Optimizer.cc:41).

        Landmark identity is built by descriptor matching between
        consecutive keyframes (+ the accepted ``loop_pair``) with
        reprojection and 3-D agreement gates, chained transitively
        (union-find); chains observed by >= 2 keyframes become landmark
        variables.  All keyframe poses (gauge: the oldest fixed) and
        landmarks are then jointly optimized by
        ``solvers.global_ba.solve_global_ba`` (dense-reduced Schur).
        Call AFTER the pose-graph correction + ``correct_poses`` — the
        loop constraint enters as the loop pair's shared landmarks.

        Returns (new_Tcw per stored keyframe, stats) and updates the
        store's poses/points in place; None when rejected (too few
        keyframes/landmarks, no improvement, or an implausibly large
        correction)."""
        from multimot_track_tpu.solvers.global_ba import (
            GlobalBAParams, solve_global_ba,
        )

        K = len(self.frames)
        if K < 3:
            return None
        pairs = [(i, i + 1) for i in range(K - 1)]
        if loop_pair is not None and abs(loop_pair[0] - loop_pair[1]) > 1:
            pairs.append(tuple(loop_pair))

        # --- correspondence graph over (keyframe, point) nodes ---
        offsets = np.cumsum([0] + [kf.uv.shape[0] for kf in self.frames])
        parent = np.arange(offsets[-1])

        def find(a):
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:
                parent[a], a = root, parent[a]
            return root

        n_edges = 0
        for i, j in pairs:
            a, b = self.frames[i], self.frames[j]
            res = matching.match_descriptors(
                self._dev(a.desc), self._dev(b.desc),
                jnp.asarray(a.valid & ~a.bad), jnp.asarray(b.valid & ~b.bad),
            )
            idx = np.asarray(res.idx)
            ok = np.asarray(res.valid)
            # geometric gates (host): reprojection of a's point into b's
            # view near b's keypoint, and 3-D agreement of the two stored
            # world points (loose — drift remains after the pose graph)
            Xb = (b.Tcw[:3, :3] @ a.Xw.T).T + b.Tcw[:3, 3]
            z = np.maximum(Xb[:, 2], 1e-3)
            u = fx * Xb[:, 0] / z + cx
            v = fy * Xb[:, 1] / z + cy
            duv = np.hypot(u - b.uv[idx][:, 0], v - b.uv[idx][:, 1])
            d3 = np.linalg.norm(a.Xw - b.Xw[idx], axis=-1)
            ok = (
                ok & (Xb[:, 2] > 0.5) & (duv < match_radius_px)
                & (d3 < np.maximum(rel3d * z, 0.3))
            )
            for p in np.nonzero(ok)[0]:
                ra, rb = find(offsets[i] + p), find(offsets[j] + idx[p])
                if ra != rb:
                    parent[rb] = ra
                    n_edges += 1
        if n_edges < 50:
            return None

        # --- chains -> padded observation tables ---
        groups: dict = {}
        for k, kf in enumerate(self.frames):
            good = np.nonzero(kf.valid & ~kf.bad)[0]
            for p in good:
                groups.setdefault(find(offsets[k] + p), []).append((k, int(p)))
        chains = [m for m in groups.values()
                  if len({k for k, _ in m}) >= 2]
        if len(chains) < 50:
            return None
        L = len(chains)
        L_pad = ((L + 1023) // 1024) * 1024
        obs_kf = np.zeros((L_pad, max_obs), np.int32)
        obs_uv = np.zeros((L_pad, max_obs, 2), np.float32)
        obs_disp = np.full((L_pad, max_obs), bf / 20.0, np.float32)
        obs_w = np.zeros((L_pad, max_obs), np.float32)
        X0 = np.zeros((L_pad, 3), np.float32)
        X0[:, 2] = 20.0
        for l, members in enumerate(chains):
            members = members[:max_obs]
            acc = np.zeros(3)
            for o, (k, p) in enumerate(members):
                kf = self.frames[k]
                obs_kf[l, o] = k
                obs_uv[l, o] = kf.uv[p]
                zc = ((kf.Tcw[:3, :3] @ kf.Xw[p]) + kf.Tcw[:3, 3])[2]
                obs_disp[l, o] = bf / max(zc, 0.5)
                obs_w[l, o] = 1.0
                acc += kf.Xw[p]
            X0[l] = acc / len(members)

        poses0 = np.stack([kf.Tcw for kf in self.frames]).astype(np.float32)
        out = solve_global_ba(
            jnp.asarray(poses0), jnp.asarray(X0), jnp.asarray(obs_kf),
            jnp.asarray(obs_uv), jnp.asarray(obs_disp), jnp.asarray(obs_w),
            fx, fy, cx, cy, bf, params=GlobalBAParams(iters=iters),
        )
        T_new = np.asarray(out.poses)
        X_opt = np.asarray(out.X)
        chi2_init, chi2 = float(out.chi2_init), float(out.chi2)
        if not np.isfinite(T_new).all() or not np.isfinite(chi2):
            return None
        if chi2 > chi2_init:
            return None
        corr = max(
            float(np.linalg.norm((T_new[k] @ np.linalg.inv(poses0[k]))[:3, 3]))
            for k in range(K)
        )
        if corr > max_corr_m:
            return None
        # relative-pose preservation: GBA must REFINE, not restructure —
        # adjacent odometry is the most reliable constraint in the system,
        # and a solution that rewrites it wholesale means the landmark
        # chains were wrong (aliased/repetitive texture can produce
        # descriptor chains that pass the loose 3-D gate yet correspond to
        # different physical points; minimizing their reprojection then
        # warps the trajectory)
        rel_changes = []
        for k in range(K - 1):
            rel_old = poses0[k + 1] @ np.linalg.inv(poses0[k])
            rel_new = T_new[k + 1] @ np.linalg.inv(T_new[k])
            rel_changes.append(
                float(np.linalg.norm((rel_new @ np.linalg.inv(rel_old))[:3, 3]))
            )
        if rel_changes and (
            np.median(rel_changes) > 0.10 or max(rel_changes) > 0.5
        ):
            return None

        # --- write back: poses move, unmatched points ride along (their
        # camera-frame geometry is a per-keyframe measurement), chain
        # members take the jointly optimized landmark position ---
        for k, kf in enumerate(self.frames):
            Xc = (kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3]
            Twc_new = np.linalg.inv(T_new[k])
            kf.Xw = ((Twc_new[:3, :3] @ Xc.T).T + Twc_new[:3, 3]).astype(
                np.float32
            )
            kf.Tcw = T_new[k].astype(np.float32)
        for l, members in enumerate(chains):
            for k, p in members[:max_obs]:
                self.frames[k].Xw[p] = X_opt[l]
        self._version += 1
        stats = {
            "n_landmarks": L, "n_edges": n_edges,
            "chi2_init": chi2_init, "chi2": chi2, "max_corr_m": corr,
        }
        return [kf.Tcw.copy() for kf in self.frames], stats
