"""The per-frame-pair multi-motion tracking step — one jitted device program.

This is the batched equivalent of the reference's multi-motion phase of
``Tracking::Track()`` (src/Tracking.cc:1179-2253): ego flow-BA, sparse scene
flow, per-object grouping/static-dynamic classification, per-object
RANSAC + flow-BA motion estimation, and online GT evaluation.

Design (SURVEY.md §2.5, §7): objects are a *batch axis*.  Instead of the
reference's sequential per-object loop, every possible semantic label slot
l in 1..K is solved simultaneously under ``vmap`` with per-label membership
masks over the full padded point set — no gathers, no dynamic shapes, and
an inactive label costs only masked lanes.  The whole step (camera RANSAC +
LM, K object RANSACs + LMs, segmentation, metrics) compiles to a single
XLA program per configuration.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.config import PipelineConfig
from multimot_track_tpu.eval import metrics
from multimot_track_tpu.geometry import camera, se3
from multimot_track_tpu.pipeline.frames import PairInputs
from multimot_track_tpu.solvers import ransac
from multimot_track_tpu.solvers.flow_ba import FlowBAParams, solve_flow_ba_auto


class TrackContext(NamedTuple):
    """State carried from the previous pair (host-managed)."""

    Tcw_last: jnp.ndarray          # (4, 4) estimated pose of the last frame
    H_prev_by_label: jnp.ndarray   # (K+1, 4, 4) last frame's world-frame object
    #                                 motion indexed by semantic label (0 unused)
    H_prev_valid: jnp.ndarray      # (K+1,) bool
    T_velocity: jnp.ndarray        # (4, 4) constant-velocity model (mVelocity,
    #                                 Tracking.cc:1311-1316): Tcw_last @ inv(prev)
    velocity_valid: jnp.ndarray    # () bool


def initial_context(k_obj_max: int) -> TrackContext:
    eye = jnp.eye(4)
    return TrackContext(
        Tcw_last=eye,
        H_prev_by_label=jnp.tile(eye, (k_obj_max + 1, 1, 1)),
        H_prev_valid=jnp.zeros(k_obj_max + 1, bool),
        T_velocity=eye,
        velocity_valid=jnp.asarray(False),
    )


class ObjectOutputs(NamedTuple):
    """Per-semantic-label-slot outputs; slot l corresponds to label l+1."""

    seen: jnp.ndarray        # group passed boundary+size filters (vTotObjNum)
    is_static: jnp.ndarray   # classified static by scene flow
    active: jnp.ndarray      # solved as a dynamic object
    n_points: jnp.ndarray    # member count
    mode_last_label: jnp.ndarray  # most frequent last-frame label (association)
    H: jnp.ndarray           # (K, 4, 4) world-frame motion (vObjMod)
    n_inliers: jnp.ndarray   # flow-BA inlier count
    centre3d: jnp.ndarray    # (K, 3) current world centroid (vObjCentre3D)
    centre_pre: jnp.ndarray  # (K, 3) last-frame world centroid of the solved
    #                          members (the speed metric's lever arm)
    bbox: jnp.ndarray        # (K, 4) x_min, y_min, x_max, y_max (+-1 extended)
    speed_est: jnp.ndarray   # km/h
    speed_gt: jnp.ndarray
    t_rpe: jnp.ndarray
    r_rpe: jnp.ndarray
    t_rpe_rel: jnp.ndarray
    r_rpe_rel: jnp.ndarray
    speed_err_rel: jnp.ndarray
    t_rpe_centred: jnp.ndarray   # lever-free translation error (metrics.py)
    has_gt: jnp.ndarray


class PairResult(NamedTuple):
    Tcw_cur: jnp.ndarray
    cam_t_rpe: jnp.ndarray
    cam_r_rpe: jnp.ndarray
    cam_t_rpe_rel: jnp.ndarray
    cam_r_rpe_rel: jnp.ndarray
    n_static: jnp.ndarray
    n_static_inliers: jnp.ndarray
    flow_hist: jnp.ndarray          # (20,) static flow-error histogram
    seg_confusion: metrics.SegConfusion  # tot/fp/fn/nd (coer out-params)
    objects: ObjectOutputs
    obj_label_map: jnp.ndarray      # (No,) per-point labels: -2 unprocessed,
    #                                  -1 outlier, 0 static, l>=1 object slot+1


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_pair(
    key: jax.Array,
    pair: PairInputs,
    ctx: TrackContext,
    cfg: PipelineConfig,
) -> PairResult:
    cam = cfg.camera
    sol = cfg.solver
    seg = cfg.segmentation
    K = cfg.padding.k_obj_max
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    k_ego, k_obj = jax.random.split(key)
    Twl = se3.inverse(ctx.Tcw_last)

    # ---------------- ego-motion: verified points, RANSAC/MM init, --------
    # ---------------- symmetric forward+backward flow-BA ------------------
    # photometric gate: drop correspondences whose flow fails verification
    # (ops/photometric); fall back to the full set when too few survive
    st_phot = pair.st_valid & (pair.st_zncc > sol.zncc_min)
    n_phot = jnp.sum(st_phot.astype(jnp.int32))
    st_solve = jnp.where(n_phot >= sol.min_gated_static, st_phot, pair.st_valid)

    Xw_st = se3.transform(Twl, camera.backproject(pair.st_uv, pair.st_depth, fx, fy, cx, cy))
    xyz_cur_st = camera.backproject(pair.st_cur_uv, pair.st_cur_depth, fx, fy, cx, cy)
    st_pnp_valid = st_solve & (pair.st_cur_depth > 0)
    rr = ransac.ransac_rigid_pose(
        k_ego, Xw_st, pair.st_cur_uv, xyz_cur_st, st_pnp_valid,
        fx, fy, cx, cy,
        thresh=sol.ransac_reproj_px, iters=sol.ransac_iters,
        refine_iters=sol.refine_gn_iters,
    )
    # motion-model init alternative: keep whichever of {RANSAC, propagated
    # constant-velocity pose} has more inliers (GetInitModelCam,
    # src/Tracking.cc:4227-4322)
    MM_cam = ctx.T_velocity @ ctx.Tcw_last
    _, n_mm_cam = ransac._count_inliers(
        MM_cam, Xw_st, pair.st_cur_uv, st_pnp_valid, sol.ransac_reproj_px,
        fx, fy, cx, cy,
    )
    use_mm_cam = ctx.velocity_valid & (n_mm_cam > rr.n_inliers)
    T_init_cam = jnp.where(use_mm_cam, MM_cam, rr.T)
    if sol.cam_init_consensus_px > 0:
        # consensus pre-gate (see SolverConfig.cam_init_consensus_px):
        # drop points far from the init pose before the LM — the
        # fixed-set equivalent of the reference's per-round outlier
        # exclusion (Optimizer.cc:539-565)
        inl0, n0 = ransac._count_inliers(
            T_init_cam, Xw_st, pair.st_cur_uv, st_solve,
            sol.cam_init_consensus_px, fx, fy, cx, cy,
        )
        st_solve = jnp.where(n0 >= sol.min_gated_static, st_solve & inl0,
                             st_solve)

    cam_params = FlowBAParams(
        reproj_info=sol.reproj_info,
        prior_info=sol.cam_flow_prior_info,
        rp_thres=sol.cam_rp_thres,
        iters=sol.cam_lm_iters,
        tau=sol.lm_tau,
    )

    def solve_cam_sym(subset, T_init):
        """Forward flow-BA + (optionally) a backward solve anchored on the
        CURRENT frame's depth, se3-averaged.  The symmetrisation cancels
        first-order per-frame depth bias (the reference's dormant
        PoseOptimizationForBack idea, src/Optimizer.cc:2889, done as two
        Schur solves + averaging)."""
        z0 = sol.cam_depth_weight_z0
        w_fwd = 1.0 / (1.0 + (pair.st_depth / z0) ** 2) if z0 > 0 else None
        res_f = solve_flow_ba_auto(
            T_init, Twl, pair.st_uv, pair.st_flow, pair.st_depth, subset,
            fx, fy, cx, cy, params=cam_params,
            point_weight=w_fwd,
        )
        if not sol.symmetric_cam:
            return res_f.T, res_f
        rel_f = res_f.T @ se3.inverse(ctx.Tcw_last)        # last cam -> cur cam
        bwd_sub = subset & (pair.st_cur_depth > 0)
        w_bwd = (
            1.0 / (1.0 + (jnp.maximum(pair.st_cur_depth, 0.0) / z0) ** 2)
            if z0 > 0 else None
        )
        bwd_res = solve_flow_ba_auto(
            se3.inverse(rel_f), jnp.eye(4, dtype=res_f.T.dtype),
            pair.st_cur_uv, -pair.st_flow, pair.st_cur_depth, bwd_sub,
            fx, fy, cx, cy, params=cam_params,
            point_weight=w_bwd,
        )
        rel_b = se3.inverse(bwd_res.T)                     # last cam -> cur cam
        xi = 0.5 * (se3.log_se3(rel_f) + se3.log_se3(rel_b))
        ok_b = (bwd_res.n_inliers >= 10) & jnp.all(jnp.isfinite(xi))
        T = se3.exp_se3(jnp.where(ok_b, xi, se3.log_se3(rel_f))) @ ctx.Tcw_last
        return T, res_f

    T_sym, cam_res = solve_cam_sym(st_solve, T_init_cam)
    if sol.sf_cam_gate > 0.0:
        # scene-flow reclassification: points that genuinely MOVE pass the
        # photometric gate (their flow is correct — for the object); drop
        # them by 3-D scene flow under the first solve and re-solve.  The
        # mask-free mode depends on this (unmasked movers otherwise bias
        # the ego solve, tools/diag_flow_quality.py).
        Xw_cur_s = se3.transform(se3.inverse(T_sym), xyz_cur_st)
        d3 = Xw_cur_s - Xw_st
        sfm = jnp.sqrt(d3[:, 0] ** 2 + d3[:, 2] ** 2)
        gate = sol.sf_cam_gate + sol.sf_cam_depth_coeff * pair.st_depth ** 2
        keep = st_solve & jnp.where(pair.st_cur_depth > 0, sfm < gate, True)
        n_keep = jnp.sum(keep.astype(jnp.int32))
        T_re, cam_res_re = solve_cam_sym(keep, T_sym)
        use_re = n_keep >= sol.min_gated_static
        T_sym = jnp.where(use_re, T_re, T_sym)
        cam_res = jax.tree_util.tree_map(
            lambda a, b: jnp.where(use_re, a, b), cam_res_re, cam_res
        )
        st_solve = jnp.where(use_re, keep, st_solve)
    n_st = jnp.sum(st_solve.astype(jnp.int32))
    Tcw_cur = jnp.where(n_st >= 3, T_sym, ctx.Tcw_last)
    Twc_cur = se3.inverse(Tcw_cur)

    cam_rpe = metrics.camera_rpe(Tcw_cur, ctx.Tcw_last, pair.gt_cur.Tcw, pair.gt_last.Tcw)

    # static flow-error histogram vs GT correspondence (src/Tracking.cc:1203-1283)
    Xc_gt = se3.transform(pair.gt_cur.Tcw, Xw_st)
    uv_gt = camera.project(Xc_gt, fx, fy, cx, cy)
    flow_err = jnp.linalg.norm(pair.st_cur_uv - uv_gt, axis=-1)
    flow_hist = metrics.flow_error_histogram(flow_err, pair.st_valid)

    # ---------------- sparse scene flow (GetSceneFlowObj) ----------------
    Xp_w = se3.transform(Twl, camera.backproject(pair.ob_uv, pair.ob_depth, fx, fy, cx, cy))
    Xc_w = se3.transform(Twc_cur, camera.backproject(pair.ob_cur_uv, pair.ob_cur_depth, fx, fy, cx, cy))
    flow3 = Xc_w - Xp_w
    pt_ok = pair.ob_valid & (pair.ob_cur_label > 0) & (pair.ob_label_last > 0)

    # ---------------- grouping + static/dynamic (Tracking.cc:1392-1529) ----
    labels = jnp.arange(1, K + 1, dtype=jnp.int32)               # slots
    member = pt_ok[None, :] & (pair.ob_cur_label[None, :] == labels[:, None])  # (K, No)
    mf = member.astype(jnp.float32)
    count = jnp.sum(mf, axis=1)
    u, v = pair.ob_cur_uv[:, 0], pair.ob_cur_uv[:, 1]
    H_img, W_img = cam.height, cam.width
    on_boundary = (
        (v < seg.boundary_margin_v)
        | (v > H_img - seg.boundary_margin_v)
        | (u < seg.boundary_margin_u)
        | (u > W_img - seg.boundary_margin_u)
    )
    bnd_frac = jnp.sum(mf * on_boundary[None, :], axis=1) / jnp.maximum(count, 1.0)
    sf_norm = jnp.sqrt(flow3[:, 0] ** 2 + flow3[:, 2] ** 2)
    sf_frac = jnp.sum(mf * (sf_norm < seg.sf_thres)[None, :], axis=1) / jnp.maximum(count, 1.0)
    depth_mean = jnp.sum(mf * pair.ob_cur_depth[None, :], axis=1) / jnp.maximum(count, 1.0)

    not_boundary = bnd_frac <= seg.boundary_frac
    big_enough = count > seg.min_obj_points
    seen = not_boundary & big_enough                 # survives to ObjId (vTotObjNum)
    is_static = seen & (sf_frac > seg.sf_percent)
    near_enough = depth_mean <= seg.max_obj_depth
    active = seen & ~is_static & near_enough         # ObjIdNew: gets a motion solve

    # association: most frequent last-frame label among members
    last_onehot = (pair.ob_label_last[None, :] == labels[:, None]).astype(jnp.float32)
    cross = jnp.einsum("kn,ln->kl", mf, last_onehot)   # (K cur, K last)
    mode_last = jnp.where(count > 0, labels[jnp.argmax(cross, axis=1)], 0)

    # ---------------- per-object init + flow-BA (vmapped over K) ----------
    xyz_cur_ob = camera.backproject(pair.ob_cur_uv, pair.ob_cur_depth, fx, fy, cx, cy)
    obj_params = FlowBAParams(
        reproj_info=sol.reproj_info,
        prior_info=sol.obj_flow_prior_info,
        rp_thres=sol.obj_rp_thres,
        iters=sol.obj_lm_iters,
        tau=sol.lm_tau,
    )

    # photometric evidence for the object points: last-frame patch vs the
    # patch at the flow-shifted current position (the E-candidate gate)
    from multimot_track_tpu.ops import photometric

    r_patch = sol.zncc_patch_radius
    s_ob = photometric.zncc(
        pair.ob_patch,
        photometric.extract_patches(pair.cur_gray, pair.ob_cur_uv, r_patch),
    )

    # compact each label's members into fixed per-object slots: the solvers
    # then run over n_per_obj_max points instead of the full padded set
    M = cfg.padding.n_per_obj_max

    def compact_label(memb):
        slots = jnp.cumsum(memb.astype(jnp.int32)) - 1
        tgt = jnp.where(memb, slots, M)
        n = jnp.sum(memb.astype(jnp.int32))
        mask = jnp.arange(M) < n

        def take(arr, fill=0.0):
            out = jnp.full((M,) + arr.shape[1:], fill, arr.dtype)
            return out.at[tgt].set(arr, mode="drop")

        return (
            take(pair.ob_uv), take(pair.ob_flow), take(pair.ob_depth),
            take(pair.ob_cur_uv), take(Xp_w), take(xyz_cur_ob), mask,
            take(pair.ob_patch), take(s_ob, fill=-1.0),
        )

    (c_uv, c_flow, c_depth, c_cur_uv, c_Xp, c_xyz, c_mask,
     c_patch, c_s) = jax.vmap(compact_label)(member)

    def solve_one(k_rng, uv_o, flow_o, depth_o, cur_uv_o, Xp_o, xyz_o, memb,
                  patch_o, s_o, mode_lab):
        H_prev = ctx.H_prev_by_label[mode_lab]
        has_prev = ctx.H_prev_valid[mode_lab]
        MM = Tcw_cur @ H_prev

        M_pts = uv_o.shape[0]
        S_r = sol.obj_ransac_score_pts
        r_sub = (
            slice(0, (M_pts // S_r) * S_r, M_pts // S_r)
            if 0 < S_r < M_pts else slice(None)
        )

        def solve_chain(kk):
            """The full init -> solve -> reclassify chain for one RANSAC
            stream (the reference path: GetInitModelObj + flow-BA +
            per-round outlier levels, Optimizer.cc:2296-2360).  Hypothesis
            sampling+scoring runs on a strided member subsample
            (SolverConfig.obj_ransac_score_pts); the winner's inlier set
            is recomputed over ALL members."""
            rrk = ransac.ransac_rigid_pose(
                kk, Xp_o[r_sub], cur_uv_o[r_sub], xyz_o[r_sub], memb[r_sub],
                fx, fy, cx, cy,
                thresh=sol.obj_ransac_reproj_px, iters=sol.obj_ransac_iters,
                refine_iters=sol.refine_gn_iters,
            )
            if r_sub != slice(None):
                inl_f, n_f = ransac._count_inliers(
                    rrk.T, Xp_o, cur_uv_o, memb, sol.obj_ransac_reproj_px,
                    fx, fy, cx, cy,
                )
                rrk = ransac.RansacResult(T=rrk.T, inliers=inl_f, n_inliers=n_f)
            # motion-model alternative (GetInitModelObj, Tracking.cc:4377-4436)
            inl_mm, n_mm = ransac._count_inliers(
                MM, Xp_o, cur_uv_o, memb, sol.obj_ransac_reproj_px,
                fx, fy, cx, cy
            )
            use_mm = has_prev & (n_mm >= rrk.n_inliers) & sol.obj_motion_model_init
            T_init = jnp.where(use_mm, MM, rrk.T)
            subset = jnp.where(use_mm, inl_mm, rrk.inliers)
            n_subset = jnp.sum(subset.astype(jnp.int32))
            res = solve_flow_ba_auto(
                T_init, Twl, uv_o, flow_o, depth_o, subset,
                fx, fy, cx, cy, params=obj_params,
            )
            for _ in range(sol.obj_reclassify_rounds):
                regate = memb & (res.chi2 <= sol.obj_rp_thres)
                n_re = jnp.sum(regate.astype(jnp.int32))
                res2 = solve_flow_ba_auto(
                    res.T, Twl, uv_o, flow_o, depth_o, regate,
                    fx, fy, cx, cy, params=obj_params,
                )
                res = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(n_re >= 10, a, b), res2, res
                )
            return res.T, res.n_inliers, subset, n_subset

        if sol.obj_ensemble:
            # seed ensemble: the RANSAC init is the dominant variance of
            # the object solve (measured 3-11% RPE spread across streams,
            # tools/diag_obj.py); run S independent streams and pick the
            # solution whose projected members BOTH photometrically
            # register against the last frame and agree with the measured
            # stereo 3-D within the depth-noise band — two witnesses the
            # flow objective does not optimise directly
            kks = jax.random.split(k_rng, sol.obj_ensemble_seeds)
            T_s, n_s, sub_s, nsub_s = jax.vmap(solve_chain)(kks)

            S_c = sol.obj_consensus_pts
            c_sub = (
                slice(0, (M_pts // S_c) * S_c, M_pts // S_c)
                if 0 < S_c < M_pts else slice(None)
            )
            Xp_c, xyz_c = Xp_o[c_sub], xyz_o[c_sub]
            patch_c, memb_c, depth_c = patch_o[c_sub], memb[c_sub], depth_o[c_sub]

            def consensus(P):
                # witness proportion on a strided member subsample
                # (SolverConfig.obj_consensus_pts) — the dominant device
                # cost before subsampling was this patch gather
                Xc = se3.transform(P, Xp_c)
                uvp = camera.project(Xc, fx, fy, cx, cy)
                pc = photometric.extract_patches(pair.cur_gray, uvp, r_patch)
                sp = photometric.zncc(patch_c, pc)
                d3 = jnp.linalg.norm(Xc - xyz_c, axis=-1)
                gate = 0.1 + 0.002 * depth_c ** 2
                ok = (
                    (sp > sol.obj_consensus_zncc) & (d3 < gate)
                    & memb_c & (depth_c > 0)
                )
                return jnp.sum(ok.astype(jnp.int32))

            scores = jax.vmap(consensus)(T_s)
            best = jnp.argmax(scores)
            best_T = T_s[best]
            best_n = n_s[best]
            subset = sub_s[best]
            n_subset = nsub_s[best]
        else:
            best_T, best_n, subset, n_subset = solve_chain(k_rng)

        P = jnp.where(n_subset >= 3, best_T, jnp.eye(4, dtype=best_T.dtype))
        H_world = se3.inverse(Tcw_cur) @ P                  # vObjMod (Tracking.cc:2129)
        sw = subset.astype(jnp.float32)
        centre_pre = jnp.sum(Xp_o * sw[:, None], axis=0) / jnp.maximum(jnp.sum(sw), 1.0)
        return H_world, best_n, centre_pre

    keys = jax.random.split(k_obj, K)
    K_s = cfg.padding.k_obj_solve or K
    if 0 < K_s < K:
        # solve only the top-K_s most-populated ACTIVE labels: slot
        # capacity (association, ids, lifespans) stays K while the
        # expensive vmapped ensemble runs at batch K_s.  Labels left out
        # are demoted to inactive (the reference similarly drops objects
        # rather than degrade the solve, src/Tracking.cc:1447-1529);
        # empty/inactive slots would solve to identity anyway, so
        # K_s >= concurrent active movers is lossless.
        rank = jnp.where(active, count, -1)
        top_idx = jax.lax.top_k(rank, K_s)[1]
        sel = lambda a: a[top_idx]
        H_s, n_s, cpre_s = jax.vmap(solve_one)(
            sel(keys), sel(c_uv), sel(c_flow), sel(c_depth), sel(c_cur_uv),
            sel(c_Xp), sel(c_xyz), sel(c_mask), sel(c_patch), sel(c_s),
            sel(mode_last),
        )
        eyeK = jnp.tile(jnp.eye(4, dtype=H_s.dtype), (K, 1, 1))
        H_world = eyeK.at[top_idx].set(H_s)
        n_inl = jnp.zeros((K,), n_s.dtype).at[top_idx].set(n_s)
        centre_pre = jnp.zeros((K, 3), cpre_s.dtype).at[top_idx].set(cpre_s)
        solved = jnp.zeros((K,), bool).at[top_idx].set(True)
        active = active & solved
    else:
        H_world, n_inl, centre_pre = jax.vmap(solve_one)(
            keys, c_uv, c_flow, c_depth, c_cur_uv, c_Xp, c_xyz, c_mask,
            c_patch, c_s, mode_last
        )

    # current-frame world centroid + bbox over all members (Tracking.cc:1694-1902)
    centre3d = jnp.einsum("kn,ni->ki", mf, Xc_w) / jnp.maximum(count[:, None], 1.0)
    big = 1e9
    u_min = jnp.min(jnp.where(member, u[None, :], big), axis=1) - 1.0
    u_max = jnp.max(jnp.where(member, u[None, :], -big), axis=1) + 1.0
    v_min = jnp.min(jnp.where(member, v[None, :], big), axis=1) - 1.0
    v_max = jnp.max(jnp.where(member, v[None, :], -big), axis=1) + 1.0
    bbox = jnp.stack([u_min, v_min, u_max, v_max], axis=-1)

    # ---------------- GT object motion + metrics (Tracking.cc:1663-2248) ---
    Twc_gt_last = se3.inverse(pair.gt_last.Tcw)
    Twc_gt_cur = se3.inverse(pair.gt_cur.Tcw)

    def gt_lookup(tab, Twc_gt, lab):
        hit = tab.obj_valid & (tab.obj_ids == lab)
        idx = jnp.argmax(hit)
        L = tab.obj_L[idx]
        return jnp.any(hit), Twc_gt @ L

    def obj_metrics(lab, Hw, cpre):
        ok_p, L_w_p = gt_lookup(pair.gt_last, Twc_gt_last, lab)
        ok_c, L_w_c = gt_lookup(pair.gt_cur, Twc_gt_cur, lab)
        H_gt = L_w_c @ se3.inverse(L_w_p)
        m = metrics.object_motion_error(Hw, H_gt, cpre, L_w_p[:3, 3], L_w_c[:3, 3])
        return ok_p & ok_c, m

    has_gt, om = jax.vmap(obj_metrics)(labels, H_world, centre_pre)

    # ---------------- per-point label map (vObjLabel semantics) ------------
    # -2 unprocessed, -1 outlier, 0 static background, k>=1 object slot
    lab_map = jnp.full(pair.ob_valid.shape, -2, jnp.int32)
    lab_map = jnp.where(pair.ob_valid & ~pt_ok, -1, lab_map)
    slot_of_label = jnp.zeros(K + 1, jnp.int32)
    slot_of_label = slot_of_label.at[1:].set(
        jnp.where(active, labels, jnp.where(is_static, 0, -1))
    )
    lab_map = jnp.where(pt_ok, slot_of_label[pair.ob_cur_label], lab_map)

    # GT-dynamic ids: objects posed in BOTH frames whose GT motion moves
    def gt_dyn_entry(lab, Lc, vc):
        ok_p, L_w_p = gt_lookup(pair.gt_last, Twc_gt_last, lab)
        H_gt = (Twc_gt_cur @ Lc) @ se3.inverse(L_w_p)
        return vc & ok_p & (jnp.linalg.norm(H_gt[:3, 3]) > 0.05)

    gt_dyn = jax.vmap(gt_dyn_entry)(
        pair.gt_cur.obj_ids, pair.gt_cur.obj_L, pair.gt_cur.obj_valid
    )
    seg_conf = metrics.segmentation_confusion(
        lab_map, pair.ob_cur_label, pair.gt_cur.obj_ids, gt_dyn, pair.ob_valid
    )

    objects = ObjectOutputs(
        seen=seen,
        is_static=is_static,
        active=active,
        n_points=count.astype(jnp.int32),
        mode_last_label=mode_last,
        H=H_world,
        n_inliers=n_inl,
        centre3d=centre3d,
        centre_pre=centre_pre,
        bbox=bbox,
        speed_est=om.speed_est,
        speed_gt=om.speed_gt,
        t_rpe=om.t_abs,
        r_rpe=om.r_abs,
        t_rpe_rel=om.t_rel,
        r_rpe_rel=om.r_rel,
        speed_err_rel=om.speed_err_rel,
        t_rpe_centred=om.t_rel_centred,
        has_gt=has_gt,
    )
    return PairResult(
        Tcw_cur=Tcw_cur,
        cam_t_rpe=cam_rpe.t_abs,
        cam_r_rpe=cam_rpe.r_abs,
        cam_t_rpe_rel=cam_rpe.t_rel,
        cam_r_rpe_rel=cam_rpe.r_rel,
        n_static=n_st,
        n_static_inliers=cam_res.n_inliers,
        flow_hist=flow_hist,
        seg_confusion=seg_conf,
        objects=objects,
        obj_label_map=lab_map,
    )


def pack_pytree(tree) -> jnp.ndarray:
    """Flatten a pytree of small arrays into ONE float32 vector.

    Every device->host transfer is one more copy and sync; shipping the
    whole PairResult as a single leaf turns ~25 transfers into one.  int/bool leaves are exactly representable in f32 at the
    magnitudes used here (< 2^24)."""
    leaves = jax.tree_util.tree_leaves(tree)
    return jnp.concatenate([l.astype(jnp.float32).reshape(-1) for l in leaves])


def unpack_pytree(flat, like):
    """Inverse of pack_pytree given a ShapeDtypeStruct pytree ``like``."""
    import numpy as np

    leaves, treedef = jax.tree_util.tree_flatten(like)
    out = []
    off = 0
    flat = np.asarray(flat)
    for l in leaves:
        n = int(np.prod(l.shape)) if l.shape else 1
        chunk = flat[off : off + n].reshape(l.shape)
        out.append(chunk.astype(l.dtype))
        off += n
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.partial(jax.jit, static_argnames=("cfg",))
def first_step(gray_u8, depth_raw_u16, flow_i16, sem_u8, gt, cfg: PipelineConfig,
               noise_key=None):
    """Frame-0 frontend only (StereoInitialization role)."""
    from multimot_track_tpu.ops import wire
    from multimot_track_tpu.pipeline import frames as F

    cam = cfg.camera
    gray = gray_u8.astype(jnp.float32)
    depth_raw = wire._decode_depth(depth_raw_u16, cam.width)
    flow = wire._decode_flow(flow_i16, cam.height, cam.width)
    sem = wire._decode_sem(sem_u8, cam.width)
    return F.build_frame_observation(gray, depth_raw, flow, sem, gt, cfg,
                                     noise_key=noise_key)


@functools.partial(jax.jit, static_argnames=("cfg",))
def full_step(
    key: jax.Array,
    prev_obs,                    # FrameObservation of the last frame
    gray_u8: jnp.ndarray,        # (H, W) uint8 current gray
    depth_raw_u16: jnp.ndarray,  # (H, W) uint16 raw depth png values
    flow_i16: jnp.ndarray,       # (H, W, 2) int16 flow * 128
    sem_u8: jnp.ndarray,         # (H, W) uint8 instance labels
    gt_cur,                      # GTTable
    ctx: TrackContext,
    cfg: PipelineConfig,
):
    """One fused device program per frame: frontend + pair build + track.

    Inputs arrive in wire form (ops/wire: uint8/uint16/int16 legacy or the
    v2 packed codec) and are expanded on device, so the whole frame costs
    exactly one dispatch instead of three plus eager ops.
    Returns (PairResult, next TrackContext, current FrameObservation).
    """
    from multimot_track_tpu.ops import wire
    from multimot_track_tpu.pipeline import frames as F

    cam = cfg.camera
    gray = gray_u8.astype(jnp.float32)
    depth_raw = wire._decode_depth(depth_raw_u16, cam.width)
    flow = wire._decode_flow(flow_i16, cam.height, cam.width)
    sem = wire._decode_sem(sem_u8, cam.width)
    if cfg.solver.depth_noise or cfg.solver.flow_outliers:
        # static branch: the default PRNG stream is untouched when off
        k_noise, key = jax.random.split(key)
    else:
        k_noise = None
    obs = F.build_frame_observation(gray, depth_raw, flow, sem, gt_cur, cfg,
                                    noise_key=k_noise)
    pair = F.build_pair(prev_obs, depth_raw, sem, gt_cur, cfg, cur_gray=gray)
    result = track_pair(key, pair, ctx, cfg)
    new_ctx = next_context(result, ctx, cfg.padding.k_obj_max)
    # the per-point label map (tens of KB) stays on device: the host loop
    # only consumes the small fields; the rest ships as ONE packed vector
    # (one transfer instead of ~25)
    light = result._replace(obj_label_map=jnp.zeros((0,), jnp.int32))
    return pack_pytree(light), new_ctx, obs


def light_result_spec(cfg: PipelineConfig):
    """ShapeDtypeStruct pytree describing full_step's packed result."""
    K = cfg.padding.k_obj_max
    f32 = jnp.float32

    def s(shape, dtype=f32):
        return jax.ShapeDtypeStruct(shape, dtype)

    objects = ObjectOutputs(
        seen=s((K,), jnp.bool_),
        is_static=s((K,), jnp.bool_),
        active=s((K,), jnp.bool_),
        n_points=s((K,), jnp.int32),
        mode_last_label=s((K,), jnp.int32),
        H=s((K, 4, 4)),
        n_inliers=s((K,), jnp.int32),
        centre3d=s((K, 3)),
        centre_pre=s((K, 3)),
        bbox=s((K, 4)),
        speed_est=s((K,)),
        speed_gt=s((K,)),
        t_rpe=s((K,)),
        r_rpe=s((K,)),
        t_rpe_rel=s((K,)),
        r_rpe_rel=s((K,)),
        speed_err_rel=s((K,)),
        t_rpe_centred=s((K,)),
        has_gt=s((K,), jnp.bool_),
    )
    return PairResult(
        Tcw_cur=s((4, 4)),
        cam_t_rpe=s(()),
        cam_r_rpe=s(()),
        cam_t_rpe_rel=s(()),
        cam_r_rpe_rel=s(()),
        n_static=s((), jnp.int32),
        n_static_inliers=s((), jnp.int32),
        flow_hist=s((20,), jnp.int32),
        seg_confusion=metrics.SegConfusion(
            tot=s((), jnp.int32), fp=s((), jnp.int32),
            fn=s((), jnp.int32), nd=s((), jnp.int32),
        ),
        objects=objects,
        obj_label_map=s((0,), jnp.int32),
    )


def next_context(result: PairResult, prev: TrackContext, k_obj_max: int) -> TrackContext:
    """Fold a pair's outputs into the context for the next pair: current
    per-label motions become next frame's motion models (keyed by current
    semantic label, which is next pair's 'last own label' space), and the
    pair's relative motion becomes the constant-velocity model (mVelocity
    update, src/Tracking.cc:1311-1316)."""
    K = k_obj_max
    H_by = jnp.tile(jnp.eye(4, dtype=result.Tcw_cur.dtype), (K + 1, 1, 1))
    H_by = H_by.at[1:].set(result.objects.H)
    valid = jnp.zeros(K + 1, bool).at[1:].set(result.objects.active)
    vel = result.Tcw_cur @ se3.inverse(prev.Tcw_last)
    return TrackContext(
        Tcw_last=result.Tcw_cur, H_prev_by_label=H_by, H_prev_valid=valid,
        T_velocity=vel, velocity_valid=jnp.asarray(True),
    )
