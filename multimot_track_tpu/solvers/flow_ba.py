"""Flow-aware pose/motion bundle adjustment, Schur-reduced, batched.

This is the batched replacement for the reference's g2o solves
``PoseOptimizationFlow2Cam`` (camera, src/Optimizer.cc:396-601) and
``PoseOptimizationFlow2`` (object, src/Optimizer.cc:2170-2377).  The factor
graph there is one SE(3) vertex plus one *marginalized* 2-DoF flow vertex
per point with

  binary edge   r_p = (obs + f) - pi(T @ Twl @ pi^-1(obs, depth))
                (EdgeSE3ProjectFlow2, types_six_dof_expmap.h:429-470),
                information w_p * I2, Huber delta = sqrt(rp_thres)
  unary edge    r_f = f - flow_meas (EdgeFlowPrior), information w_f * I2

g2o marginalizes the flow vertices inside its block solver — i.e. a Schur
complement onto the single 6x6 pose block.  Here that structure is exploited
*analytically*: because d(r_p)/df = I and d(r_f)/df = I, every per-point flow
Hessian block is a scalar multiple of I2, so the Schur complement reduces to
masked weighted reductions over the point axis — elementwise work plus
reductions, with zero sparse bookkeeping.  The whole Levenberg-Marquardt loop runs
device-side under ``lax.while_loop`` and is ``vmap``-able over objects.

World points X_w = Twl @ pi^-1(obs, depth) are constants of the problem
(depth is a measurement, not a variable), exactly as in the reference edge.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera, se3, smallsolve


class FlowBAParams(NamedTuple):
    reproj_info: float = 0.1     # w_p  (Optimizer.cc:465)
    prior_info: float = 0.3      # w_f  (0.3 camera / 0.5 object)
    rp_thres: float = 0.04       # chi2 inlier gate; huber delta^2
    iters: int = 100             # LM iterations (100 camera / 200 object)
    tau: float = 1e-5            # lambda_0 = tau * max diag(H)
    # accepted-step relative-decrease convergence gate; 1e-6 reaches the
    # same objective as 1e-7 on kitti data with ~35% fewer iterations
    rel_tol: float = 1e-6


class FlowBAResult(NamedTuple):
    T: jnp.ndarray           # (4, 4) optimized pose (world -> current camera)
    flow: jnp.ndarray        # (N, 2) optimized flow estimates
    chi2: jnp.ndarray        # (N,) final raw reprojection chi2 (w_p * ||r||^2)
    inliers: jnp.ndarray     # (N,) bool, chi2 <= rp_thres (Optimizer.cc:539-565)
    n_inliers: jnp.ndarray   # () int32
    mean_reproj: jnp.ndarray  # () mean sqrt(chi2) over inliers (repro_e)


def _residual_chi2(T, f, Xw, obs, flow_meas, valid, p: FlowBAParams, fx, fy, cx, cy,
                   w_pt=1.0):
    """Robustified total objective F and raw per-point chi2.

    ``w_pt`` scales each reprojection edge's information (per-point
    inverse-variance weight); the returned chi2 is the *unweighted*
    reference quantity so the inlier gate keeps its semantics."""
    y = se3.transform(T, Xw)
    r_p = (obs + f) - camera.project(y, fx, fy, cx, cy)
    chi2_p = p.reproj_info * jnp.sum(r_p * r_p, axis=-1)
    chi2_w = w_pt * chi2_p
    # Huber(rho) with delta^2 = rp_thres (deltaMono = sqrt(rp_thres))
    d2 = p.rp_thres
    rho = jnp.where(
        chi2_w <= d2, chi2_w, 2.0 * jnp.sqrt(d2 * jnp.maximum(chi2_w, 1e-20)) - d2
    )
    r_f = f - flow_meas
    chi2_f = p.prior_info * jnp.sum(r_f * r_f, axis=-1)
    F = jnp.sum(jnp.where(valid, rho + chi2_f, 0.0))
    return F, chi2_p


def _build_and_solve(T, f, Xw, obs, flow_meas, valid, lam, p: FlowBAParams, fx, fy, cx, cy,
                     w_pt=1.0):
    """One damped Gauss-Newton step via analytic Schur elimination of flow."""
    y = se3.transform(T, Xw)                      # (N, 3) camera-frame points
    uv_hat = camera.project(y, fx, fy, cx, cy)
    r_p = (obs + f) - uv_hat                      # (N, 2)
    r_f = f - flow_meas

    # robust IRLS weight rho'(chi2) on the (w_pt-weighted) projection edge
    chi2_p = w_pt * p.reproj_info * jnp.sum(r_p * r_p, axis=-1)
    w_rob = jnp.where(
        chi2_p <= p.rp_thres,
        1.0,
        jnp.sqrt(p.rp_thres / jnp.maximum(chi2_p, 1e-20)),
    )
    vw = jnp.where(valid, w_rob, 0.0)
    wp = w_pt * p.reproj_info * vw                # effective scalar info per point
    wf = p.prior_info * jnp.where(valid, 1.0, 0.0)

    # d r_p / d xi  (left-multiplicative update T <- exp(xi) T, xi=(omega, ups))
    z = y[..., 2]
    inv_z = 1.0 / jnp.maximum(z, 1e-6)
    # d pi / d y : (N, 2, 3)
    zero = jnp.zeros_like(z)
    dpi = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
        ],
        axis=-2,
    )
    # d y / d xi = [-hat(y) | I3]  : (N, 3, 6)
    dy = jnp.concatenate(
        [-se3.hat(y), jnp.broadcast_to(jnp.eye(3, dtype=y.dtype), y.shape[:-1] + (3, 3))],
        axis=-1,
    )
    A = -jnp.einsum("nij,njk->nik", dpi, dy)      # (N, 2, 6) = d r_p / d xi

    # pose block and gradient
    H_TT = jnp.einsum("nia,nib,n->ab", A, A, wp)
    g_T = jnp.einsum("nia,ni,n->a", A, r_p, wp)

    # per-point flow block is (wp + wf) * I2 -> scalar Schur
    h_ff = wp + wf + lam
    g_f = wp[:, None] * r_p + wf[:, None] * r_f   # (N, 2)

    # Schur complement onto the pose
    AtW = jnp.einsum("nia,n->nia", A, wp)          # A^T wp rows as (N, 2, 6)
    H_red = (
        H_TT
        + lam * jnp.eye(6, dtype=H_TT.dtype)
        - jnp.einsum("nia,nib,n->ab", AtW, AtW, 1.0 / h_ff)
    )
    g_red = g_T - jnp.einsum("nia,ni,n->a", AtW, g_f, 1.0 / h_ff)

    dxi = smallsolve.solve_spd6(H_red, -g_red)
    # back-substitute flow updates: (wp+wf+lam) df = -(g_f + wp * A dxi)
    Adxi = jnp.einsum("nia,a->ni", A, dxi)
    df = -(g_f + wp[:, None] * Adxi) / h_ff[:, None]

    # predicted reduction 0.5 * delta^T (lam*delta - g) over both blocks
    pred = 0.5 * (
        jnp.dot(dxi, lam * dxi - g_red)
        + jnp.sum(jnp.where(valid[:, None], df * (lam * df - g_f), 0.0))
    )
    return dxi, df, pred


@functools.partial(jax.jit, static_argnames=("params",))
def solve_flow_ba(
    T_init: jnp.ndarray,
    Twl: jnp.ndarray,
    obs: jnp.ndarray,
    flow_meas: jnp.ndarray,
    depth: jnp.ndarray,
    valid: jnp.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    params: FlowBAParams = FlowBAParams(),
    point_weight=None,
) -> FlowBAResult:
    """Solve for the pose P minimizing the flow-aware objective.

    ``P`` maps last-frame-world points into the current camera: for the
    camera solve it is Tcw of the current frame; for an object solve it is
    ``Tcw_cur @ H_world`` whose H is recovered by the caller
    (src/Tracking.cc:2127-2129).

    ``point_weight`` (N,) optionally scales each reprojection edge's
    information matrix (per-point inverse-variance weighting, e.g. the
    depth-noise model sigma_z ~ z^2, Frame.cc:1089).  The returned chi2 /
    inlier gate stay unweighted for reference parity.
    """
    p = params
    w_pt = 1.0 if point_weight is None else point_weight
    Xw = se3.transform(Twl, camera.backproject(obs, depth, fx, fy, cx, cy))
    valid = valid & (depth > 0)
    f0 = flow_meas
    F0, _ = _residual_chi2(T_init, f0, Xw, obs, flow_meas, valid, p, fx, fy, cx, cy,
                           w_pt=w_pt)

    y0 = se3.transform(T_init, Xw)

    # initial lambda = tau * max diag(H) (g2o OptimizationAlgorithmLevenberg)
    def diag_seed():
        z = jnp.maximum(y0[..., 2], 1e-6)
        scale = (fx / z) ** 2 + (fy / z) ** 2
        return jnp.max(jnp.where(valid, w_pt * p.reproj_info * scale, 0.0))

    lam0 = p.tau * jnp.maximum(diag_seed(), 1.0)

    State = tuple  # (it, T, f, F, lam, nu, done)

    def body(state):
        it, T, f, F, lam, nu, done = state
        dxi, df, pred = _build_and_solve(
            T, f, Xw, obs, flow_meas, valid, lam, p, fx, fy, cx, cy, w_pt=w_pt
        )
        T_new = se3.exp_se3(dxi) @ T
        f_new = f + df
        F_new, _ = _residual_chi2(T_new, f_new, Xw, obs, flow_meas, valid, p, fx, fy, cx, cy,
                                  w_pt=w_pt)
        gain = (F - F_new) / jnp.maximum(pred, 1e-20)
        accept = (F_new < F) & jnp.isfinite(F_new)
        # Nielsen's update (as in g2o's Levenberg strategy)
        lam_acc = lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
        # converged: an accepted step changed the objective negligibly, or
        # damping exploded (g2o terminates on the same signals); the
        # fixpoint is identical, so stopping early only saves iterations
        done = done | (accept & (F - F_new < p.rel_tol * F + 1e-10)) | (lam > 1e8)
        T = jnp.where(accept, T_new, T)
        f = jnp.where(accept, f_new, f)
        F = jnp.where(accept, F_new, F)
        lam = jnp.where(accept, lam_acc, lam * nu)
        nu = jnp.where(accept, 2.0, nu * 2.0)
        return (it + 1, T, f, F, lam, nu, done)

    def cond(state):
        return (state[0] < p.iters) & ~state[-1]

    _, T, f, F, lam, nu, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), T_init, f0, F0, lam0, jnp.float32(2.0), jnp.bool_(False))
    )

    _, chi2 = _residual_chi2(T, f, Xw, obs, flow_meas, valid, p, fx, fy, cx, cy)
    inliers = valid & (chi2 <= p.rp_thres)
    n_in = jnp.sum(inliers.astype(jnp.int32))
    mean_reproj = jnp.sum(jnp.where(inliers, jnp.sqrt(chi2), 0.0)) / jnp.maximum(
        n_in, 1
    )
    return FlowBAResult(
        T=T, flow=f, chi2=chi2, inliers=inliers, n_inliers=n_in, mean_reproj=mean_reproj
    )


def solve_flow_ba_auto(
    T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy,
    params: FlowBAParams = FlowBAParams(), point_weight=None,
) -> FlowBAResult:
    """The tracker's flow-BA entry.  Chosen where the program is lowered:
    for CUDA the fused LM kernel (solvers/flow_ba_pallas.py, one thread
    block per solve), for every other platform the XLA ``solve_flow_ba``.
    Both implement identical numerics (tests/test_flow_ba_pallas.py)."""
    from multimot_track_tpu.solvers.flow_ba_pallas import solve_flow_ba_pallas

    def branch(solve):
        return lambda *a: solve(*a, fx, fy, cx, cy, params=params,
                                point_weight=point_weight)

    return jax.lax.platform_dependent(
        T_init, Twl, obs, flow_meas, depth, valid,
        cuda=branch(solve_flow_ba_pallas), default=branch(solve_flow_ba),
    )


# Batched over K independent problems (objects) — shapes (K, ...)
solve_flow_ba_batched = jax.vmap(
    solve_flow_ba,
    in_axes=(0, None, 0, 0, 0, 0, None, None, None, None, None),
    out_axes=0,
)


class FlowDepthBAParams(NamedTuple):
    reproj_info: float = 0.1
    flow_prior_info: float = 0.3
    depth_prior_info: float = 1.0   # EdgeDepthPrior information
    rp_thres: float = 0.04
    iters: int = 100
    tau: float = 1e-5
    rel_tol: float = 1e-6


@functools.partial(jax.jit, static_argnames=("params",))
def solve_flow_depth_ba(
    T_init: jnp.ndarray,
    Twl: jnp.ndarray,
    obs: jnp.ndarray,
    flow_meas: jnp.ndarray,
    depth_meas: jnp.ndarray,
    valid: jnp.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    params: FlowDepthBAParams = FlowDepthBAParams(),
) -> FlowBAResult:
    """Flow-BA with *per-point depth as a variable* (3-DoF point vertices).

    The reference's experimental ``PoseOptimizationFlowDepth2`` family
    (src/Optimizer.cc:1568; EdgeSE3ProjectFlowDepth2
    types_six_dof_expmap.h:473 + EdgeFlowDepthPrior :339): the point
    vertex is (flow_u, flow_v, depth) with Gaussian priors on all three.
    The per-point Schur block becomes a 3x3 matrix; its closed-form
    inverse keeps elimination a batched elementwise computation.

    Useful when depth is much noisier than flow (the reference's synthetic
    depth-noise studies) — the solver can trade depth against reprojection.
    """
    p = params
    valid = valid & (depth_meas > 0)
    R_wl = Twl[:3, :3]
    t_wl = Twl[:3, 3]

    def point_world(f, d):
        X = camera.backproject(obs, d, fx, fy, cx, cy)
        return jnp.einsum("ij,nj->ni", R_wl, X) + t_wl

    def residuals(T, f, d):
        y = se3.transform(T, point_world(f, d))
        r_p = (obs + f) - camera.project(y, fx, fy, cx, cy)
        return y, r_p, f - flow_meas, d - depth_meas

    def robust_objective(T, f, d):
        _, r_p, r_f, r_d = residuals(T, f, d)
        chi2_p = p.reproj_info * jnp.sum(r_p * r_p, -1)
        d2 = p.rp_thres
        rho = jnp.where(chi2_p <= d2, chi2_p, 2 * jnp.sqrt(d2 * jnp.maximum(chi2_p, 1e-20)) - d2)
        F = rho + p.flow_prior_info * jnp.sum(r_f * r_f, -1) + p.depth_prior_info * r_d * r_d
        return jnp.sum(jnp.where(valid, F, 0.0)), chi2_p

    f0 = flow_meas
    d0 = depth_meas
    F0, _ = robust_objective(T_init, f0, d0)
    z0 = jnp.maximum(depth_meas, 1e-3)
    lam0 = p.tau * jnp.maximum(
        jnp.max(jnp.where(valid, p.reproj_info * ((fx / z0) ** 2 + (fy / z0) ** 2), 0.0)), 1.0
    )

    def build(T, f, d, lam):
        y, r_p, r_f, r_d = residuals(T, f, d)
        chi2_p = p.reproj_info * jnp.sum(r_p * r_p, -1)
        w_rob = jnp.where(chi2_p <= p.rp_thres, 1.0,
                          jnp.sqrt(p.rp_thres / jnp.maximum(chi2_p, 1e-20)))
        wp = p.reproj_info * jnp.where(valid, w_rob, 0.0)
        wf = p.flow_prior_info * jnp.where(valid, 1.0, 0.0)
        wd = p.depth_prior_info * jnp.where(valid, 1.0, 0.0)

        z = jnp.maximum(y[..., 2], 1e-6)
        inv_z = 1.0 / z
        zero = jnp.zeros_like(z)
        dpi = jnp.stack([
            jnp.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
        ], -2)                                           # (N, 2, 3)
        dy_dxi = jnp.concatenate(
            [-se3.hat(y), jnp.broadcast_to(jnp.eye(3, dtype=y.dtype), y.shape[:-1] + (3, 3))], -1
        )
        A = -jnp.einsum("nij,njk->nik", dpi, dy_dxi)      # d r_p/d xi (N, 2, 6)
        # d r_p / d depth: X = backproject(obs, d) is linear in d, so
        # dX/dd = backproject(obs, 1) and dy/dd = R_total @ that ray
        dirs = camera.backproject(obs, jnp.ones_like(d), fx, fy, cx, cy)
        dy_dd = jnp.einsum("ij,nj->ni", T[:3, :3] @ R_wl, dirs)
        J_d = -jnp.einsum("nij,nj->ni", dpi, dy_dd)       # (N, 2)
        # point-vertex jacobian of r_p wrt (fu, fv, d): [I2 | J_d]
        B = jnp.concatenate([jnp.broadcast_to(jnp.eye(2, dtype=y.dtype), r_p.shape[:-1] + (2, 2)),
                             J_d[..., None]], -1)          # (N, 2, 3)

        H_TT = jnp.einsum("nia,nib,n->ab", A, A, wp)
        g_T = jnp.einsum("nia,ni,n->a", A, r_p, wp)
        prior_diag = jnp.stack([wf, wf, wd], -1)           # (N, 3)
        H_vv = jnp.einsum("nia,nib,n->nab", B, B, wp) + \
            jax.vmap(jnp.diag)(prior_diag + lam)
        g_v = jnp.einsum("nia,ni,n->na", B, r_p, wp) + prior_diag * jnp.stack(
            [r_f[:, 0], r_f[:, 1], r_d], -1)
        H_Tv = jnp.einsum("nia,nib,n->nab", A, B, wp)      # (N, 6, 3)

        H_vv_inv = smallsolve.inv_spd3(H_vv)
        H_red = H_TT + lam * jnp.eye(6) - jnp.einsum(
            "nab,nbc,ndc->ad", H_Tv, H_vv_inv, H_Tv)
        g_red = g_T - jnp.einsum("nab,nbc,nc->a", H_Tv, H_vv_inv, g_v)
        dxi = smallsolve.solve_spd6(H_red, -g_red)
        dv = -jnp.einsum("nab,nb->na", H_vv_inv,
                         g_v + jnp.einsum("nba,b->na", H_Tv, dxi))
        pred = 0.5 * (jnp.dot(dxi, lam * dxi - g_red) + jnp.sum(
            jnp.where(valid[:, None], dv * (lam * dv - g_v), 0.0)))
        return dxi, dv, pred

    def body(state):
        it, T, f, d, Fv, lam, nu, done = state
        dxi, dv, pred = build(T, f, d, lam)
        T_new = se3.exp_se3(dxi) @ T
        f_new = f + dv[:, :2]
        d_new = jnp.maximum(d + dv[:, 2], 1e-3)
        F_new, _ = robust_objective(T_new, f_new, d_new)
        accept = (F_new < Fv) & jnp.isfinite(F_new)
        gain = (Fv - F_new) / jnp.maximum(pred, 1e-20)
        lam_acc = lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
        done = done | (accept & (Fv - F_new < p.rel_tol * Fv + 1e-10)) | (lam > 1e8)
        T = jnp.where(accept, T_new, T)
        f = jnp.where(accept, f_new, f)
        d = jnp.where(accept, d_new, d)
        Fv = jnp.where(accept, F_new, Fv)
        lam = jnp.where(accept, lam_acc, lam * nu)
        nu = jnp.where(accept, 2.0, nu * 2.0)
        return (it + 1, T, f, d, Fv, lam, nu, done)

    def cond(state):
        return (state[0] < p.iters) & ~state[-1]

    _, T, f, d, Fv, _, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), T_init, f0, d0, F0, lam0, jnp.float32(2.0), jnp.bool_(False)),
    )
    _, chi2 = robust_objective(T, f, d)
    inliers = valid & (chi2 <= p.rp_thres)
    n_in = jnp.sum(inliers.astype(jnp.int32))
    mean_reproj = jnp.sum(jnp.where(inliers, jnp.sqrt(chi2), 0.0)) / jnp.maximum(n_in, 1)
    return FlowBAResult(T=T, flow=f, chi2=chi2, inliers=inliers,
                        n_inliers=n_in, mean_reproj=mean_reproj)
