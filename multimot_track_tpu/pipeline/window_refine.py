"""Trailing-window trajectory refinement inside the live system.

The reference continuously refines its keyframe window in a background
thread (``LocalMapping::Run`` -> ``Optimizer::LocalBundleAdjustment``,
src/LocalMapping.cc:48, src/Optimizer.cc:3341).  The batched analog is
one fused device program per frame: detect keypoints on the window's
first frame, chain them through the stored dense flow fields
(frontend/tracks.chain_tracks), and run the inverse-depth windowed BA
(solvers/window_ba) initialised at the online per-pair poses.  The system
keeps the window's compact image tensors resident on device (they were
uploaded for ``full_step`` anyway), so refinement costs zero extra
host<->device traffic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from multimot_track_tpu.config import PipelineConfig
from multimot_track_tpu.frontend import fast, tracks
from multimot_track_tpu.geometry import camera
from multimot_track_tpu.solvers.window_ba import WindowBAParams, solve_window_ba


@functools.partial(jax.jit, static_argnames=("cfg",))
def refine_joint_window(
    poses_rel: jnp.ndarray,     # (W, 4, 4) Tcw relative to window frame 0
    H_init: jnp.ndarray,        # (W-1, K, 4, 4) window-world object motions
    H_valid: jnp.ndarray,       # (W-1, K) bool
    grays_u8: jnp.ndarray,      # (W, H, W)
    depths_u16: jnp.ndarray,    # (W, H, W) raw disparity*256
    flows_i16: jnp.ndarray,     # (W-1, H, W, 2) flow k -> k+1, *128
    sems_u8: jnp.ndarray,       # (W, H, W) instance masks
    cfg: PipelineConfig,
):
    """Joint ego + multi-object windowed BA (LocalBundleAdjustment extended
    with object motions, ref src/Optimizer.cc:3341 + BASELINE.md's
    "sliding-window multi-object BA").

    One fused program per keyframe: the per-pair static/object observations
    are re-derived from the window's buffered image tensors (depth, flow,
    masks are already device-resident from ``full_step``), then the dense
    joint LM of solvers/multi_window_ba refines all window camera poses and
    all per-pair object motions together under a constant-motion prior.
    Returns (poses (W,4,4), motions (W-1,K,4,4), chi2).
    """
    from multimot_track_tpu.frontend import sampling
    from multimot_track_tpu.solvers import multi_window_ba

    be, cam, fe = cfg.backend, cfg.camera, cfg.frontend
    K = cfg.padding.k_obj_max
    Wn = poses_rel.shape[0]
    Himg, Wimg = grays_u8.shape[-2:]

    from multimot_track_tpu.ops import wire

    depths = camera.disparity_png_to_depth(
        wire._decode_depth(depths_u16, Wimg), cam.bf
    )
    flows = wire._decode_flow(flows_i16, Himg, Wimg)
    sems = wire._decode_sem(sems_u8, Wimg)

    stride = be.joint_static_stride
    Nst = be.joint_static_max
    M = be.joint_obj_pts

    def pair_obs(depth, sem, flow, gray, gray_next):
        # --- static grid: off-mask, valid depth, flow target in-bounds ---
        gi = jnp.arange(0, Himg, stride)
        gj = jnp.arange(0, Wimg, stride)
        yy, xx = jnp.meshgrid(gi, gj, indexing="ij")
        d = depth[yy, xx]
        lab = sem[yy, xx]
        f = flow[yy, xx]
        xs, ys = xx.astype(jnp.float32), yy.astype(jnp.float32)
        nx, ny = xs + f[..., 0], ys + f[..., 1]
        ok = (
            (lab == 0) & (d > 0) & (d < fe.static_max_depth)
            & (nx > 0) & (nx < Wimg) & (ny > 0) & (ny < Himg)
        )
        uv = jnp.stack([xs, ys], -1).reshape(-1, 2)
        _, m_s, uv_s, z_s, f_s = sampling.compact(
            ok, Nst, uv, d.reshape(-1), f.reshape(-1, 2)
        )
        # photometric verification of the flow correspondence (the
        # pairwise solver's ZNCC gate): raw grid points sit on textureless
        # road/sky where the precomputed flow is interpolated and biased —
        # ungated they drag the window scale (measured 0.8 m tail
        # corrections on kitti_sample); corner-grade verified points do not
        from multimot_track_tpu.ops import photometric

        r = cfg.solver.zncc_patch_radius
        p0 = photometric.extract_patches(gray, uv_s, r)
        p1 = photometric.extract_patches(gray_next, uv_s + f_s, r)
        m_s = m_s & (photometric.zncc(p0, p1) > be.window_zncc_min)
        # depth-variance weighting (sigma_z ~ z^2): fixed depths are
        # measurements; unweighted they bias the window scale exactly as
        # they bias the per-pair solve (SolverConfig.cam_depth_weight_z0)
        z0 = cfg.solver.cam_depth_weight_z0
        m_s = m_s.astype(jnp.float32) / (1.0 + (z_s / z0) ** 2)

        # --- object points: the tracker's dense sampling, split by slot ---
        s = sampling.sample_dense_objects(
            depth, sem, flow, step=fe.obj_sample_step,
            max_depth=fe.obj_max_depth, n_max=4 * M * K,
        )

        def per_slot(k):
            vk = s.valid & (s.label == k + 1)
            _, m_o, uv_o, z_o, f_o = sampling.compact(
                vk, M, s.uv, s.depth, s.flow
            )
            return uv_o, f_o, z_o, m_o

        ob_uv, ob_fl, ob_z, ob_m = jax.vmap(per_slot)(jnp.arange(K))
        return uv_s, f_s, z_s, m_s, ob_uv, ob_fl, ob_z, ob_m

    grays = grays_u8.astype(jnp.float32)
    st_uv, st_fl, st_z, st_m, ob_uv, ob_fl, ob_z, ob_m = jax.vmap(pair_obs)(
        depths[:-1], sems[:-1], flows, grays[:-1], grays[1:]
    )

    res = multi_window_ba.refine_window(
        poses_rel, H_init, H_valid,
        st_uv, st_fl, st_z, st_m,
        ob_uv, ob_fl, ob_z, ob_m,
        cam.fx, cam.fy, cam.cx, cam.cy,
        params=multi_window_ba.MultiWindowParams(
            iters=be.joint_iters, w_smooth=be.joint_w_smooth,
            w_odo=be.joint_w_odo, w_motion_prior=be.joint_w_motion_prior,
            obj_init_gate_px=be.joint_obj_gate_px,
        ),
    )
    return res.poses, res.motions, res.chi2


@functools.partial(jax.jit, static_argnames=("cfg",))
def refine_trailing_window(
    poses_rel: jnp.ndarray,     # (W, 4, 4) Tcw relative to window frame 0 (I)
    grays_u8: jnp.ndarray,      # (W, H, W) window gray frames
    depth0_u16: jnp.ndarray,    # (H, W) first window frame raw depth png
    flows_i16: jnp.ndarray,     # (W-1, H, W, 2) dense flow k -> k+1, *128
    sems_u8: jnp.ndarray,       # (W, H, W) instance masks
    cfg: PipelineConfig,
):
    """Returns (refined poses (W, 4, 4), n_live_tracks)."""
    from multimot_track_tpu.ops import photometric

    from multimot_track_tpu.ops import wire

    be, cam = cfg.backend, cfg.camera
    grays = grays_u8.astype(jnp.float32)
    gray0 = grays[0]
    depth0 = camera.disparity_png_to_depth(
        wire._decode_depth(depth0_u16, cam.width), cam.bf
    )
    flows = wire._decode_flow(flows_i16, cam.height, cam.width)
    sems = wire._decode_sem(sems_u8, cam.width)

    kp = fast.detect_pyramid(gray0, n_levels=4, n_total=be.n_window_tracks)
    z0, _ = camera.nearest_sample(depth0, kp.uv)
    lab0, _ = camera.nearest_sample(sems[0], kp.uv)
    valid0 = kp.valid & (z0 > 0) & (z0 < 40.0) & (lab0 == 0)

    tr = tracks.chain_tracks(kp.uv, valid0, flows, sems)
    # photometric verification of every chained observation against the
    # frame-0 patch: the strictest selection — only drift-free tracks
    # survive.  The KLT re-centering variant (tracks.chain_tracks_zncc)
    # more than doubles survival but admits noisier measurements and
    # measured WORSE on the refined RPE (5.7% vs 4.8% on kitti_sample);
    # with the odometry-prior fusion the BA prefers few clean tracks.
    r = cfg.solver.zncc_patch_radius
    p0 = photometric.extract_patches(gray0, kp.uv, r)

    def verify(alive_f, uv_f, gray_f):
        pf = photometric.extract_patches(gray_f, uv_f, r)
        return alive_f & (photometric.zncc(p0, pf) > be.window_zncc_min)

    alive_v = jax.vmap(verify)(tr.alive[1:], tr.uv[1:], grays[1:])
    alive_v = jnp.cumprod(alive_v.astype(jnp.int32), axis=0).astype(bool)
    alive = jnp.concatenate([tr.alive[:1], alive_v], axis=0)

    res = solve_window_ba(
        poses_rel, tr.uv, alive, z0,
        cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
        params=WindowBAParams(
            iters=be.window_ba_iters, odo_prior_weight=be.odo_prior_weight
        ),
    )
    n_live = jnp.sum(alive[-1].astype(jnp.int32))
    return res.poses, n_live
