"""Sliding-window joint ego + multi-object motion refinement.

The BASELINE north star asks for "sliding-window multi-object BA": camera
poses and per-object rigid motions refined together over a window.  The
graph (VDO-SLAM-style, the natural extension of the reference's per-pair
solves):

  variables   xi_f        camera pose deltas, f = 1..F-1 (frame 0 gauge)
              eta_{f,k}   world-frame object motion deltas per pair/object
  residuals   static flow-reprojection per pair  (reference Flow2Cam model)
              object flow-reprojection per pair  (reference Flow2 model)
              motion smoothness  Log(H_{f,k}^-1 H_{f+1,k})  (constant-
              motion prior — what makes object edges informative for the
              camera instead of gauge freedom)

Depths enter as fixed measurements (the reference's choice in its active
solvers); full structure elimination lives in solvers/window_ba.  At
window scale (~600 tangent dims) the normal system is built with jacfwd
and solved densely — a dense matmul-sized system; no sparse machinery.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera, se3


class MultiWindowParams(NamedTuple):
    iters: int = 15
    huber_px: float = 1.0
    w_static: float = 1.0
    w_object: float = 1.0
    w_smooth: float = 100.0     # information on the constant-motion prior
    # se(3) information of the online per-pair relative poses fused as
    # odometry prior edges (same formulation as window_ba's
    # odo_prior_weight: r = Log(T_f T_{f-1}^-1 Z_f^-1)).  Without it the
    # window's flow residuals alone let corrections grow along the window
    # (measured 0.88 m at the tail on kitti_sample) — the online solves
    # are measurements too and must anchor the joint refinement.
    w_odo: float = 0.0
    # se(3) prior holding each object motion near its online estimate
    # (r = sqrt(w) * eta): the online ensemble solve is a strong
    # measurement; the window should nudge it with cross-pair evidence,
    # not re-estimate it from the rawer windowed points.
    w_motion_prior: float = 0.0
    # drop object points whose residual under the ONLINE init exceeds this
    # (px; 0 disables) — mask bleed / bad boundary flow never enters
    # (LocalBundleAdjustment's outlier-edge removal after the first pass)
    obj_init_gate_px: float = 0.0
    lam: float = 1e-3


class MultiWindowResult(NamedTuple):
    poses: jnp.ndarray      # (F, 4, 4) refined Tcw
    motions: jnp.ndarray    # (F-1, K, 4, 4) refined world-frame H
    chi2: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("params",))
def refine_window(
    poses_init: jnp.ndarray,     # (F, 4, 4) Tcw from the online pass
    motions_init: jnp.ndarray,   # (F-1, K, 4, 4) vObjMod per pair/object
    motions_valid: jnp.ndarray,  # (F-1, K)
    st_uv: jnp.ndarray,          # (F-1, N, 2) last-frame static obs per pair
    st_flow: jnp.ndarray,        # (F-1, N, 2)
    st_depth: jnp.ndarray,       # (F-1, N)
    st_valid: jnp.ndarray,       # (F-1, N) bool mask or float weights
    ob_uv: jnp.ndarray,          # (F-1, K, M, 2) object points per pair/object
    ob_flow: jnp.ndarray,        # (F-1, K, M, 2)
    ob_depth: jnp.ndarray,       # (F-1, K, M)
    ob_valid: jnp.ndarray,       # (F-1, K, M) bool mask or float weights
    fx: float, fy: float, cx: float, cy: float,
    params: MultiWindowParams = MultiWindowParams(),
) -> MultiWindowResult:
    p = params
    F = poses_init.shape[0]
    K = motions_init.shape[1]
    Z_odo = jnp.einsum(
        "fij,fjk->fik", poses_init[1:], se3.inverse(poses_init[:-1])
    )                                              # (F-1, 4, 4) measured rels

    if p.obj_init_gate_px > 0.0:
        # one-shot outlier gate at the online init (v = 0)
        Twl0 = se3.inverse(poses_init[:-1])
        Tc0 = poses_init[1:]
        Xo0 = camera.backproject(ob_uv, ob_depth, fx, fy, cx, cy)
        Xw0 = jnp.einsum("fij,fkmj->fkmi", Twl0[:, :3, :3], Xo0) + Twl0[:, None, None, :3, 3]
        Xh0 = jnp.einsum("fkij,fkmj->fkmi", motions_init[..., :3, :3], Xw0) + motions_init[..., None, :3, 3]
        yo0 = jnp.einsum("fij,fkmj->fkmi", Tc0[:, :3, :3], Xh0) + Tc0[:, None, None, :3, 3]
        r0 = (ob_uv + ob_flow) - camera.project(yo0, fx, fy, cx, cy)
        ob_valid = ob_valid * (
            jnp.sum(r0 * r0, -1) < p.obj_init_gate_px ** 2
        ).astype(ob_valid.dtype)

    def unpack(v):
        xi = v[: 6 * (F - 1)].reshape(F - 1, 6)
        eta = v[6 * (F - 1) :].reshape(F - 1, K, 6)
        T = jnp.concatenate(
            [poses_init[:1], se3.exp_se3(xi) @ poses_init[1:]], axis=0
        )
        H = se3.exp_se3(eta) @ motions_init
        return T, H

    def residuals(v):
        T, H = unpack(v)
        Twl = se3.inverse(T[:-1])                      # (F-1, 4, 4)
        Tc = T[1:]

        def rw(r, w, mask):
            """Robust (Huber-IRLS) weighted residual rows.  The weight is
            frozen per linearisation (stop_gradient — classic IRLS): it
            keeps jacfwd away from sqrt(0) (the mag*unit split NaNs for
            exactly-zero residuals, e.g. every padded point when a term's
            weight is 0) AND keeps the GN step from being shrunk by the
            weight's own derivative."""
            r2 = jnp.sum(r * r, -1)
            wi = jnp.minimum(1.0, p.huber_px / jnp.sqrt(r2 + 1e-12))
            wi = jax.lax.stop_gradient(wi)
            return (mask.astype(r.dtype) * jnp.sqrt(w * wi))[..., None] * r

        # static: r = (obs + flow) - pi(Tc_f Twc_{f-1} X_l)
        Xl = camera.backproject(st_uv, st_depth, fx, fy, cx, cy)   # (F-1, N, 3)
        Xw = jnp.einsum("fij,fnj->fni", Twl[:, :3, :3], Xl) + Twl[:, None, :3, 3]
        y = jnp.einsum("fij,fnj->fni", Tc[:, :3, :3], Xw) + Tc[:, None, :3, 3]
        r_s = (st_uv + st_flow) - camera.project(y, fx, fy, cx, cy)
        out_s = rw(r_s, p.w_static, st_valid).reshape(-1)

        # objects: r = (obs + flow) - pi(Tc_f H_{f,k} Twc_{f-1} X_l)
        Xo = camera.backproject(ob_uv, ob_depth, fx, fy, cx, cy)   # (F-1, K, M, 3)
        Xw_o = jnp.einsum("fij,fkmj->fkmi", Twl[:, :3, :3], Xo) + Twl[:, None, None, :3, 3]
        Xh = jnp.einsum("fkij,fkmj->fkmi", H[..., :3, :3], Xw_o) + H[..., None, :3, 3]
        yo = jnp.einsum("fij,fkmj->fkmi", Tc[:, :3, :3], Xh) + Tc[:, None, None, :3, 3]
        r_o = (ob_uv + ob_flow) - camera.project(yo, fx, fy, cx, cy)
        w_o = ob_valid.astype(r_o.dtype) * motions_valid[..., None].astype(r_o.dtype)
        out_o = rw(r_o, p.w_object, w_o).reshape(-1)

        # smoothness: consecutive motions of the same object agree
        rel = jnp.einsum("fkij,fkjl->fkil", se3.inverse(H[:-1]), H[1:])
        r_m = se3.log_se3(rel)                          # (F-2, K, 6)
        w_m = (motions_valid[:-1] & motions_valid[1:]).astype(jnp.float32)
        out_m = (jnp.sqrt(p.w_smooth) * w_m[..., None] * r_m).reshape(-1)

        # odometry prior: relative poses stay near the online estimates
        M_odo = jnp.einsum(
            "fij,fjk,fkl->fil", T[1:], se3.inverse(T[:-1]), se3.inverse(Z_odo)
        )
        out_odo = (jnp.sqrt(p.w_odo) * se3.log_se3(M_odo)).reshape(-1)

        # motion prior: object motions stay near their online estimates
        eta = v[6 * (F - 1):].reshape(F - 1, K, 6)
        out_mp = (
            jnp.sqrt(p.w_motion_prior)
            * motions_valid[..., None].astype(eta.dtype) * eta
        ).reshape(-1)

        return jnp.concatenate([out_s, out_o, out_m, out_odo, out_mp])

    D = 6 * (F - 1) * (1 + K)

    def body(_, v):
        r = residuals(v)
        J = jax.jacfwd(residuals)(v)
        H_n = J.T @ J + p.lam * jnp.eye(D)
        g = J.T @ r
        return v + jnp.linalg.solve(H_n, -g)

    v_fin = jax.lax.fori_loop(0, p.iters, body, jnp.zeros(D))
    T, Hm = unpack(v_fin)
    r_fin = residuals(v_fin)
    return MultiWindowResult(poses=T, motions=Hm, chi2=jnp.sum(r_fin * r_fin))
