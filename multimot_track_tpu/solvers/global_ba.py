"""Global bundle adjustment over the keyframe graph (post-loop-closure).

The reference runs full global BA in a background thread after every
accepted loop closure (``LoopClosing::RunGlobalBundleAdjustment``,
src/LoopClosing.cc:647 -> ``Optimizer::GlobalBundleAdjustemnt``,
src/Optimizer.cc:41 — g2o sparse-Schur over all keyframes + map points).
Here the same problem is one dense-reduced device program:

* landmarks (map points observed by >= 2 keyframes) are Schur-eliminated
  with closed-form 3x3 block inverses — a batched elementwise computation
  over the (L, O) observation table, no sparse bookkeeping;
* the reduced camera system is (6K, 6K) dense.  At keyframe-store scale
  (K <= 64 -> 384x384) one dense solve beats any sparse path;
* the whole damped-GN loop runs device-side under ``lax.while_loop`` with
  Levenberg accept/reject, exactly like solvers/flow_ba.py.

Measurement model per observation (landmark l seen by keyframe k):
  y       = Tcw_k @ X_l
  r_uv    = uv_obs - pi(y)                  (pixels)
  r_disp  = disp_obs - bf / y_z             (pixels; the stereo row that
                                             pins scale, as in
                                             solvers/ransac._gn_refine_stereo)
with Huber IRLS on ||r_uv|| and a depth-variance weight on the disparity
row (sigma_z ~ z^2, the reference's own noise model src/Frame.cc:1089).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera, se3


class GlobalBAParams(NamedTuple):
    iters: int = 25
    huber_px: float = 2.0        # Huber delta on the pixel residual norm
    disp_info: float = 0.5       # information of the disparity row
    depth_weight_z0: float = 15.0  # z-variance model scale (SolverConfig)
    tau: float = 1e-4            # lambda_0 = tau * max diag
    rel_tol: float = 1e-6


class GlobalBAResult(NamedTuple):
    poses: jnp.ndarray       # (K, 4, 4) optimized Tcw (pose 0 = gauge, fixed)
    X: jnp.ndarray           # (L, 3) optimized landmark positions (world)
    chi2_init: jnp.ndarray   # () robust objective before
    chi2: jnp.ndarray        # () robust objective after


def _obs_terms(T_stack, X, obs_kf, obs_uv, obs_disp, obs_w,
               fx, fy, cx, cy, bf, p: GlobalBAParams):
    """Per-observation residuals, IRLS weights and Jacobian blocks.

    Shapes: T_stack (K,4,4); X (L,3); obs_* (L,O,...).
    Returns r (L,O,3), w3 (L,O,3) effective per-row information,
    Jp (L,O,3,6), Jx (L,O,3,3)."""
    Tk = T_stack[obs_kf]                              # (L, O, 4, 4)
    y = jnp.einsum("loij,lj->loi", Tk[..., :3, :3], X) + Tk[..., :3, 3]
    z = jnp.maximum(y[..., 2], 1e-3)
    u_hat = fx * y[..., 0] / z + cx
    v_hat = fy * y[..., 1] / z + cy
    disp_hat = bf / z
    r = jnp.stack(
        [obs_uv[..., 0] - u_hat, obs_uv[..., 1] - v_hat, obs_disp - disp_hat],
        axis=-1,
    )                                                  # (L, O, 3)

    # Huber IRLS on the pixel norm; depth-variance weight on disparity
    r_px = jnp.sqrt(r[..., 0] ** 2 + r[..., 1] ** 2 + 1e-12)
    w_rob = jnp.minimum(1.0, p.huber_px / r_px)
    z_meas = bf / jnp.maximum(obs_disp, 1e-3)
    w_d = p.disp_info / (1.0 + (z_meas / p.depth_weight_z0) ** 2)
    w3 = jnp.stack([obs_w * w_rob, obs_w * w_rob, obs_w * w_rob * w_d], -1)

    # d[pi; disp]/dy : (L, O, 3, 3)
    inv_z = 1.0 / z
    zero = jnp.zeros_like(z)
    dpi = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
            jnp.stack([zero, zero, bf * inv_z * inv_z], -1),
        ],
        axis=-2,
    )
    # dy/dxi = [-[y]x | I]  (left-multiplicative update T <- exp(xi) T)
    skew = jnp.zeros(y.shape[:-1] + (3, 3), y.dtype)
    skew = skew.at[..., 0, 1].set(-y[..., 2]).at[..., 0, 2].set(y[..., 1])
    skew = skew.at[..., 1, 0].set(y[..., 2]).at[..., 1, 2].set(-y[..., 0])
    skew = skew.at[..., 2, 0].set(-y[..., 1]).at[..., 2, 1].set(y[..., 0])
    eye = jnp.broadcast_to(jnp.eye(3, dtype=y.dtype), skew.shape)
    dy_dxi = jnp.concatenate([-skew, eye], axis=-1)    # (L, O, 3, 6)
    # r = obs - h(y):  dr/d· = -dh/dy @ dy/d·
    Jp = -jnp.einsum("loab,lobc->loac", dpi, dy_dxi)   # (L, O, 3, 6)
    Jx = -jnp.einsum("loab,lobc->loac", dpi, Tk[..., :3, :3])  # (L, O, 3, 3)
    return r, w3, Jp, Jx


def _objective(T_stack, X, obs_kf, obs_uv, obs_disp, obs_w,
               fx, fy, cx, cy, bf, p: GlobalBAParams):
    r, w3, _, _ = _obs_terms(
        T_stack, X, obs_kf, obs_uv, obs_disp, obs_w, fx, fy, cx, cy, bf, p
    )
    # robust pixel part: Huber(chi2_px) with delta^2 = huber_px^2
    chi2_px = r[..., 0] ** 2 + r[..., 1] ** 2
    d2 = p.huber_px ** 2
    rho = jnp.where(
        chi2_px <= d2,
        chi2_px,
        2.0 * jnp.sqrt(d2 * jnp.maximum(chi2_px, 1e-20)) - d2,
    )
    z_meas = bf / jnp.maximum(obs_disp, 1e-3)
    w_d = p.disp_info / (1.0 + (z_meas / p.depth_weight_z0) ** 2)
    return jnp.sum(obs_w * (rho + w_d * r[..., 2] ** 2))


@functools.partial(jax.jit, static_argnames=("params",))
def solve_global_ba(
    poses_Tcw: jnp.ndarray,   # (K, 4, 4)
    X0: jnp.ndarray,          # (L, 3) landmark inits (world)
    obs_kf: jnp.ndarray,      # (L, O) int32 keyframe index per observation
    obs_uv: jnp.ndarray,      # (L, O, 2) pixel observations
    obs_disp: jnp.ndarray,    # (L, O) measured disparity bf/z
    obs_w: jnp.ndarray,       # (L, O) observation weight; 0 = padding
    fx, fy, cx, cy, bf,
    params: GlobalBAParams = GlobalBAParams(),
) -> GlobalBAResult:
    p = params
    K = poses_Tcw.shape[0]
    O = obs_kf.shape[1]
    f32 = jnp.float32
    T0 = poses_Tcw.astype(f32)
    X_init = X0.astype(f32)

    # --- one damped-GN step ---
    def gn_step(T_stack, X, lam):
        r, w3, Jp, Jx = _obs_terms(
            T_stack, X, obs_kf, obs_uv, obs_disp, obs_w,
            fx, fy, cx, cy, bf, p,
        )
        WJp = w3[..., None] * Jp                       # (L, O, 3, 6)
        WJx = w3[..., None] * Jx                       # (L, O, 3, 3)
        Hpp_o = jnp.einsum("loab,loac->lobc", Jp, WJp)   # (L, O, 6, 6)
        # RHS of H dx = b is b = -J^T W r (r is modeled as r + J dx)
        bp_o = -jnp.einsum("loab,loa->lob", WJp, r)      # (L, O, 6)
        Hll = jnp.einsum("loab,loac->lbc", Jx, WJx)      # (L, 3, 3)
        bl = -jnp.einsum("loab,loa->lb", WJx, r)         # (L, 3)
        Wblk = jnp.einsum("loab,loac->lobc", Jp, WJx)    # (L, O, 6, 3)

        Hpp = jnp.zeros((K, 6, 6), f32)
        bp = jnp.zeros((K, 6), f32)
        kf_flat = obs_kf.reshape(-1)
        Hpp = Hpp.at[kf_flat].add(Hpp_o.reshape(-1, 6, 6))
        bp = bp.at[kf_flat].add(bp_o.reshape(-1, 6))

        # damped landmark blocks + closed-form 3x3 inversion
        Hll_d = Hll + (lam + 1e-8) * jnp.broadcast_to(jnp.eye(3, dtype=f32), Hll.shape)
        Hll_inv = jnp.linalg.inv(Hll_d)                # (L, 3, 3)
        U = jnp.einsum("loab,lbc->loac", Wblk, Hll_inv)  # (L, O, 6, 3)

        # reduced camera system S = Hpp + lam I - sum_l U W^T (scattered)
        S = jnp.zeros((K, K, 6, 6), f32)
        idx6 = jnp.arange(K)
        S = S.at[idx6, idx6].add(
            Hpp + lam * jnp.broadcast_to(jnp.eye(6, dtype=f32), Hpp.shape)
        )
        for o1 in range(O):
            for o2 in range(O):
                C = jnp.einsum("lab,lcb->lac", U[:, o1], Wblk[:, o2])
                S = S.at[obs_kf[:, o1], obs_kf[:, o2]].add(-C)
        b_red = bp
        Ub = jnp.einsum("loab,lb->loa", U, bl)         # (L, O, 6)
        b_red = b_red.at[kf_flat].add(-Ub.reshape(-1, 6))

        # gauge: pose 0 fixed — mask its rows/cols, identity diag
        Sm = S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
        bm = b_red.reshape(6 * K)
        free = (jnp.arange(6 * K) >= 6).astype(f32)
        Sm = Sm * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        bm = bm * free
        dxi = jnp.linalg.solve(Sm, bm).reshape(K, 6)

        # back-substitute landmarks
        dxi_obs = dxi[obs_kf]                           # (L, O, 6)
        Wt_dxi = jnp.einsum("loab,loa->lb", Wblk, dxi_obs)  # (L, 3)
        dX = jnp.einsum("lab,lb->la", Hll_inv, bl - Wt_dxi)

        T_new = jax.vmap(lambda d, T: se3.exp_se3(d) @ T)(dxi, T_stack)
        X_new = X + dX
        return T_new, X_new

    F0 = _objective(T0, X_init, obs_kf, obs_uv, obs_disp, obs_w,
                    fx, fy, cx, cy, bf, p)

    def body(state):
        it, T, X, F, lam, nu, done = state
        T_new, X_new = gn_step(T, X, lam)
        F_new = _objective(T_new, X_new, obs_kf, obs_uv, obs_disp, obs_w,
                           fx, fy, cx, cy, bf, p)
        accept = (F_new < F) & jnp.isfinite(F_new)
        done = done | (accept & (F - F_new < p.rel_tol * F + 1e-10)) | (lam > 1e8)
        T = jnp.where(accept, T_new, T)
        X = jnp.where(accept, X_new, X)
        F = jnp.where(accept, F_new, F)
        lam = jnp.where(accept, lam / 3.0, lam * nu)
        nu = jnp.where(accept, 2.0, nu * 2.0)
        return (it + 1, T, X, F, lam, nu, done)

    def cond(state):
        return (state[0] < p.iters) & ~state[-1]

    lam0 = jnp.float32(p.tau)
    _, T, X, F, _, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), T0, X_init, F0, lam0, jnp.float32(2.0), jnp.bool_(False)),
    )
    return GlobalBAResult(poses=T, X=X, chi2_init=F0, chi2=F)
