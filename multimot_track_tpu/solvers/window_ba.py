"""Sliding-window bundle adjustment with inverse-depth Schur elimination.

The batched counterpart of the reference's keyframe-window machinery
(``Optimizer::LocalBundleAdjustment`` src/Optimizer.cc:3341 — sparse Schur
over MapPoint blocks in g2o).  Structure exploited here:

* every track starts in window frame 0 (the gauge), so pose-pose coupling
  arises only through point elimination — the raw pose Hessian is
  block-diagonal;
* each point contributes one scalar inverse-depth variable; its Schur
  block inverse is a scalar multiply — elimination is a batched reduction,
  not sparse linear algebra;
* the reduced (F-1)*6 system is tiny and solved densely on-device.

Residual per (frame f >= 1, track i):
  r_{f,i} = obs_{f,i} - pi(Tcw_f @ pi^-1(obs_{0,i}, 1/rho_i))
with a Gaussian prior rho_i ~ N(1/z0_i, sigma_rho) from the depth map —
the probabilistic version of the reference's fixed-depth unprojection
(depth noise model sigma_z = z^2/(725*0.5)*0.15, src/Frame.cc:1089).

All reductions over the track axis are psum-able: the distributed variant
shards tracks across the mesh (see parallel/dist_ba.py for the pattern).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera, se3


class WindowBAParams(NamedTuple):
    iters: int = 30
    huber_px: float = 2.0          # Huber delta on the pixel residual norm
    # sigma on rho (1/m): ~2e-2 keeps the prior a soft anchor against scale
    # drift; the reference's z^2-scaled noise model (src/Frame.cc:1089)
    # corresponds to a *tighter* 4.1e-4 — use that only when depths are
    # trusted (it visibly biases poses when they are not).
    depth_prior_sigma: float = 2e-2
    tau: float = 1e-4
    # odometry fusion: se(3) prior on each consecutive relative pose,
    # measured from ``poses_init`` (the online per-pair solves).  The
    # chained-flow observations then *correct* rather than replace the
    # pairwise estimates — LocalBA as a fusion, not a re-solve.  0 = off.
    # Units: information = 1/sigma^2 on the mixed (rad, m) tangent.
    odo_prior_weight: float = 0.0


class WindowBAResult(NamedTuple):
    poses: jnp.ndarray     # (F, 4, 4) optimized Tcw (frame 0 = identity gauge)
    inv_depth: jnp.ndarray  # (N,) optimized inverse depths
    chi2: jnp.ndarray      # () final robust objective


@functools.partial(jax.jit, static_argnames=("params",))
def solve_window_ba(
    poses_init: jnp.ndarray,    # (F, 4, 4) initial Tcw (pose[0] must be I)
    uv: jnp.ndarray,            # (F, N, 2) track observations
    alive: jnp.ndarray,         # (F, N) bool
    depth0: jnp.ndarray,        # (N,) metric depth at frame-0 observation
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    params: WindowBAParams = WindowBAParams(),
) -> WindowBAResult:
    p = params
    F, N = uv.shape[0], uv.shape[1]
    uv0 = uv[0]
    valid0 = alive[0] & (depth0 > 0)
    rho0 = jnp.where(valid0, 1.0 / jnp.maximum(depth0, 1e-3), 1.0)
    w_prior = 1.0 / (p.depth_prior_sigma ** 2)
    obs = uv[1:]                                   # (F-1, N, 2)
    vis = alive[1:] & valid0[None, :]              # (F-1, N)

    # ray direction per track: X(rho) = dir / rho
    dirs = camera.backproject(uv0, jnp.ones_like(depth0), fx, fy, cx, cy)  # (N, 3)

    # odometry prior edges: measured relative poses from poses_init
    w_odo = p.odo_prior_weight
    Z_odo = jax.vmap(lambda a, b: a @ se3.inverse(b))(
        poses_init[1:], poses_init[:-1]
    )                                              # (F-1, 4, 4)
    Ad_Z = jax.vmap(se3.adjoint)(Z_odo)            # (F-1, 6, 6)

    def odo_residuals(T_stack):
        T_prev = jnp.concatenate(
            [jnp.eye(4, dtype=T_stack.dtype)[None], T_stack[:-1]], axis=0
        )
        M = jax.vmap(lambda a, b, z: a @ se3.inverse(b) @ se3.inverse(z))(
            T_stack, T_prev, Z_odo
        )
        return jax.vmap(se3.log_se3)(M)            # (F-1, 6)

    def unpack(T_stack):
        return T_stack  # (F-1, 4, 4)

    def residual_blocks(T_stack, rho, lam):
        X = dirs / rho[:, None]                    # (N, 3) frame-0 camera coords
        y = jnp.einsum("fij,nj->fni", T_stack[:, :3, :3], X) + T_stack[:, None, :3, 3]
        uv_hat = camera.project(y, fx, fy, cx, cy)  # (F-1, N, 2)
        r = obs - uv_hat
        rn2 = jnp.sum(r * r, axis=-1)
        w_rob = jnp.where(
            rn2 <= p.huber_px ** 2,
            1.0,
            p.huber_px / jnp.sqrt(jnp.maximum(rn2, 1e-20)),
        )
        w = jnp.where(vis, w_rob, 0.0)             # (F-1, N)

        z = jnp.maximum(y[..., 2], 1e-6)
        inv_z = 1.0 / z
        zero = jnp.zeros_like(z)
        dpi = jnp.stack(
            [
                jnp.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
                jnp.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
            ],
            axis=-2,
        )                                          # (F-1, N, 2, 3)
        eye3 = jnp.broadcast_to(jnp.eye(3, dtype=y.dtype), y.shape[:-1] + (3, 3))
        dy_dxi = jnp.concatenate([-se3.hat(y), eye3], axis=-1)  # (F-1, N, 3, 6)
        # r = obs - pi(y):  dr/dxi = -dpi dy
        Jp = -jnp.einsum("fnij,fnjk->fnik", dpi, dy_dxi)        # (F-1, N, 2, 6)
        # dX/drho = -X/rho; dy/drho = R @ dX
        dy_drho = -jnp.einsum("fij,nj->fni", T_stack[:, :3, :3], X) / rho[None, :, None]
        Jr = -jnp.einsum("fnij,fnj->fni", dpi, dy_drho)         # (F-1, N, 2)

        # pose diag blocks + gradient
        H_ff = jnp.einsum("fnia,fnib,fn->fab", Jp, Jp, w)        # (F-1, 6, 6)
        g_f = jnp.einsum("fnia,fni,fn->fa", Jp, r, w)            # NOTE grad of 0.5||r||^2 wrt xi is J^T W r with r = obs-pi and J = dr/dxi
        # rho blocks
        h_r = jnp.einsum("fni,fni,fn->n", Jr, Jr, w) + w_prior + lam
        g_r = jnp.einsum("fni,fni,fn->n", Jr, r, w) + w_prior * (rho - rho0)
        B = jnp.einsum("fnia,fni,fn->nfa", Jp, Jr, w)            # (N, F-1, 6)
        return r, w, H_ff, g_f, h_r, g_r, B

    def objective(T_stack, rho):
        X = dirs / rho[:, None]
        y = jnp.einsum("fij,nj->fni", T_stack[:, :3, :3], X) + T_stack[:, None, :3, 3]
        r = obs - camera.project(y, fx, fy, cx, cy)
        rn2 = jnp.sum(r * r, axis=-1)
        d2 = p.huber_px ** 2
        rob = jnp.where(rn2 <= d2, rn2, 2.0 * p.huber_px * jnp.sqrt(jnp.maximum(rn2, 1e-20)) - d2)
        prior = w_prior * (rho - rho0) ** 2
        F_pts = jnp.sum(jnp.where(vis, rob, 0.0)) + jnp.sum(jnp.where(valid0, prior, 0.0))
        if w_odo > 0.0:
            r_o = odo_residuals(T_stack)
            F_pts = F_pts + w_odo * jnp.sum(r_o * r_o)
        return F_pts

    T0 = poses_init[1:]
    F0 = objective(T0, rho0)
    lam0 = jnp.float32(p.tau) * jnp.maximum(
        1.0, (fx / jnp.maximum(jnp.min(jnp.where(valid0, depth0, 1e9)), 1.0)) ** 2
    )

    D = 6 * (F - 1)

    def body(state):
        it, T_stack, rho, Fv, lam, nu = state
        r, w, H_ff, g_f, h_r, g_r, B = residual_blocks(T_stack, rho, lam)
        # assemble reduced dense system
        H = jnp.zeros((F - 1, F - 1, 6, 6), dtype=jnp.float32)
        idx = jnp.arange(F - 1)
        H = H.at[idx, idx].set(H_ff + lam * jnp.eye(6)[None])
        Bh = B / h_r[:, None, None]                               # (N, F-1, 6)
        H = H - jnp.einsum("nfa,ngb->fgab", Bh, B)
        g = g_f - jnp.einsum("nfa,n->fa", Bh, g_r)
        if w_odo > 0.0:
            # edge e couples poses (e-1, e); cur-side Jacobian ~ I, prev-side
            # ~ -Ad(Z_e) (left-multiplicative perturbation, see se3.adjoint)
            r_o = odo_residuals(T_stack)                          # (F-1, 6)
            H = H.at[idx, idx].add(w_odo * jnp.eye(6)[None])
            g = g + w_odo * r_o
            if F > 2:
                A2 = Ad_Z[1:]                                     # (F-2, 6, 6)
                AtA = jnp.einsum("eca,ecb->eab", A2, A2)
                H = H.at[idx[:-1], idx[:-1]].add(w_odo * AtA)
                H = H.at[idx[1:], idx[:-1]].add(-w_odo * A2)
                H = H.at[idx[:-1], idx[1:]].add(
                    -w_odo * jnp.swapaxes(A2, -1, -2)
                )
                g = g.at[:-1].add(
                    -w_odo * jnp.einsum("eca,ec->ea", A2, r_o[1:])
                )
        Hd = H.transpose(0, 2, 1, 3).reshape(D, D)
        gd = g.reshape(D)
        # gradient of objective wrt xi is J^T W r where here J = dr/dxi and
        # residual enters as r -> objective 0.5 r^2; GN: (H) dx = -g
        dxi = jnp.linalg.solve(Hd, -gd).reshape(F - 1, 6)
        drho = -(g_r + jnp.einsum("nfa,fa->n", B, dxi)) / h_r
        T_new = se3.exp_se3(dxi) @ T_stack
        rho_new = jnp.where(valid0, jnp.maximum(rho + drho, 1e-4), rho)
        F_new = objective(T_new, rho_new)
        pred = 0.5 * (
            jnp.sum(dxi * (lam * dxi - g))
            + jnp.sum(jnp.where(valid0, drho * (lam * drho - g_r), 0.0))
        )
        accept = (F_new < Fv) & jnp.isfinite(F_new)
        gain = (Fv - F_new) / jnp.maximum(pred, 1e-20)
        lam_acc = lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
        T_stack = jnp.where(accept, T_new, T_stack)
        rho = jnp.where(accept, rho_new, rho)
        Fv = jnp.where(accept, F_new, Fv)
        lam = jnp.where(accept, lam_acc, lam * nu)
        nu = jnp.where(accept, 2.0, nu * 2.0)
        return (it + 1, T_stack, rho, Fv, lam, nu)

    def cond(state):
        return state[0] < p.iters

    _, T_fin, rho_fin, F_fin, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), T0, rho0, F0, lam0, jnp.float32(2.0))
    )
    poses = jnp.concatenate([poses_init[:1], T_fin], axis=0)
    return WindowBAResult(poses=poses, inv_depth=rho_fin, chi2=F_fin)
