"""Pose-graph optimization (the essential-graph solve of loop closing).

Counterpart of ``Optimizer::OptimizeEssentialGraph``
(src/Optimizer.cc:3669; invoked by LoopClosing::CorrectLoop) — relative
SE(3) constraints between keyframes, solved after a loop detection to
spread the loop-closure correction over the trajectory.

Batched shape: all edge residuals r_e = Log(Z_ij^-1 Ti Tj^-1) evaluate as one
batch.  Two solvers share that residual:

* :func:`optimize_pose_graph` — exact dense Gauss-Newton via ``jacfwd``;
  right at keyframe-graph scale (hundreds of poses: a few-thousand-dim
  dense solve), quadratic in memory beyond that;
* :func:`optimize_pose_graph_cg` — analytic per-edge Jacobians
  (J_i = Jl^-1(r) Ad(Z^-1), J_j = -Jl^-1(r) Ad(Z^-1 A)) and a
  MATRIX-FREE conjugate-gradient solve of the normal equations: Hx is a
  gather -> per-edge 6x6 block product -> segment_sum scatter, O(E)
  memory, full-KITTI scale (thousands of keyframes) without ever
  materialising H.

Gauge: pose 0 is fixed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import se3


class PoseGraphResult(NamedTuple):
    poses: jnp.ndarray    # (M, 4, 4) optimized
    chi2: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    poses_init: jnp.ndarray,   # (M, 4, 4) Tcw estimates
    edges_ij: jnp.ndarray,     # (E, 2) int32 (i, j) pose indices
    Z: jnp.ndarray,            # (E, 4, 4) measured T_i @ T_j^-1
    weights: jnp.ndarray,      # (E,) edge information scale
    iters: int = 20,
    lam: float = 1e-4,
) -> PoseGraphResult:
    M = poses_init.shape[0]

    def residuals(xi_flat, base):
        xi = xi_flat.reshape(M, 6)
        T = se3.exp_se3(xi) @ base
        Ti = T[edges_ij[:, 0]]
        Tj = T[edges_ij[:, 1]]
        rel = jnp.einsum("eij,ejk->eik", Ti, se3.inverse(Tj))
        err = jnp.einsum("eij,ejk->eik", se3.inverse(Z), rel)
        return (se3.log_se3(err) * jnp.sqrt(weights)[:, None]).reshape(-1)

    def body(_, base):
        xi0 = jnp.zeros(M * 6)
        r = residuals(xi0, base)
        J = jax.jacfwd(residuals)(xi0, base)          # (6E, 6M)
        # gauge: fix pose 0 by zeroing its columns
        mask = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (M - 1))])
        J = J * mask[None, :]
        H = J.T @ J + lam * jnp.eye(6 * M)
        g = J.T @ r
        dxi = jnp.linalg.solve(H, -g) * mask
        return se3.exp_se3(dxi.reshape(M, 6)) @ base

    poses = jax.lax.fori_loop(0, iters, body, poses_init)
    r_fin = residuals(jnp.zeros(M * 6), poses)
    return PoseGraphResult(poses=poses, chi2=jnp.sum(r_fin * r_fin))


def _ad_se3(xi: jnp.ndarray) -> jnp.ndarray:
    """Little adjoint ad(xi) for the (omega, upsilon) ordering:
    ad = [[hat(w), 0], [hat(v), hat(w)]]."""
    w, v = xi[..., :3], xi[..., 3:]
    hw = se3.hat(w)
    hv = se3.hat(v)
    z = jnp.zeros_like(hw)
    top = jnp.concatenate([hw, z], axis=-1)
    bot = jnp.concatenate([hv, hw], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters"))
def optimize_pose_graph_cg(
    poses_init: jnp.ndarray,   # (M, 4, 4) Tcw estimates
    edges_ij: jnp.ndarray,     # (E, 2) int32 (i, j) pose indices
    Z: jnp.ndarray,            # (E, 4, 4) measured T_i @ T_j^-1
    weights: jnp.ndarray,      # (E,) edge information scale
    iters: int = 20,
    cg_iters: int | None = None,
    lam: float = 1e-4,
) -> PoseGraphResult:
    """Scalable pose-graph Gauss-Newton: analytic edge Jacobians +
    matrix-free CG.  Identical model to :func:`optimize_pose_graph`; the
    Jl^-1 is the second-order expansion I - ad(r)/2 (exact as r -> 0, and
    the outer re-linearisation makes the fixed point exact anyway).

    ``cg_iters`` defaults to ~1.5*M: a loop correction must propagate
    along the odometry chain, and CG moves information one edge per
    iteration — fewer iterations silently under-correct."""
    M = poses_init.shape[0]
    if cg_iters is None:
        cg_iters = max(60, int(1.5 * M))
    ii = edges_ij[:, 0]
    jj = edges_ij[:, 1]
    Zinv = se3.inverse(Z)
    sw = jnp.sqrt(weights)

    def edge_terms(T):
        Ti = T[ii]
        Tj = T[jj]
        A = jnp.einsum("eij,ejk->eik", Ti, se3.inverse(Tj))
        err = jnp.einsum("eij,ejk->eik", Zinv, A)
        r = se3.log_se3(err)                          # (E, 6)
        Jl_inv = jnp.eye(6) - 0.5 * _ad_se3(r)        # (E, 6, 6)
        AdZ = se3.adjoint(Zinv)                       # (E, 6, 6)
        AdZA = se3.adjoint(err)                       # Ad(Z^-1 A) = Ad(err)
        Ji = jnp.einsum("eab,ebc->eac", Jl_inv, AdZ)
        Jj = -jnp.einsum("eab,ebc->eac", Jl_inv, AdZA)
        return r * sw[:, None], Ji * sw[:, None, None], Jj * sw[:, None, None]

    gauge = jnp.arange(M) > 0                         # pose 0 fixed

    def body(_, base):
        r, Ji, Jj = edge_terms(base)

        def Hx(x):                                    # x: (M, 6)
            x = x * gauge[:, None]
            ax = jnp.einsum("eab,eb->ea", Ji, x[ii]) + jnp.einsum(
                "eab,eb->ea", Jj, x[jj]
            )                                         # (E, 6) = J x
            yi = jnp.einsum("eba,eb->ea", Ji, ax)     # J_i^T (Jx)
            yj = jnp.einsum("eba,eb->ea", Jj, ax)
            y = jnp.zeros((M, 6)).at[ii].add(yi).at[jj].add(yj)
            return (y + lam * x) * gauge[:, None]

        g = jnp.zeros((M, 6)).at[ii].add(
            jnp.einsum("eba,eb->ea", Ji, r)
        ).at[jj].add(jnp.einsum("eba,eb->ea", Jj, r))
        g = g * gauge[:, None]

        # block-Jacobi preconditioner: the 6x6 diagonal blocks of H
        # (a chain graph's condition number grows ~M^2; unpreconditioned
        # CG diverges in f32 at thousands of poses)
        diag = (
            jnp.zeros((M, 6, 6))
            .at[ii].add(jnp.einsum("eba,ebc->eac", Ji, Ji))
            .at[jj].add(jnp.einsum("eba,ebc->eac", Jj, Jj))
            + (lam + 1e-6) * jnp.eye(6)
        )
        Minv = jnp.linalg.inv(diag)

        def apply_M(v):
            return jnp.einsum("mab,mb->ma", Minv, v) * gauge[:, None]

        # preconditioned CG on H dxi = -g
        def cg_step(state, _):
            x, p, rr, z, rz = state
            Hp = Hx(p)
            pHp = jnp.sum(p * Hp)
            alpha = jnp.where(pHp > 1e-20, rz / jnp.maximum(pHp, 1e-20), 0.0)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = apply_M(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(rz > 1e-20, rz_new / jnp.maximum(rz, 1e-20), 0.0)
            p = z + beta * p
            return (x, p, rr, z, rz_new), None

        x0 = jnp.zeros((M, 6))
        r0 = -g
        z0 = apply_M(r0)
        (dxi, _, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, z0, r0, z0, jnp.sum(r0 * z0)), None, length=cg_iters
        )
        # guard: a broken-down CG round (non-finite direction) is skipped
        # rather than corrupting the linearisation point
        dxi = jnp.where(jnp.isfinite(dxi), dxi, 0.0)
        return se3.exp_se3(dxi.reshape(M, 6)) @ base

    poses = jax.lax.fori_loop(0, iters, body, poses_init)
    r_fin, _, _ = edge_terms(poses)
    return PoseGraphResult(poses=poses, chi2=jnp.sum(r_fin * r_fin))


def odometry_edges(poses: jnp.ndarray):
    """Consecutive-pose odometry constraints from a trajectory."""
    M = poses.shape[0]
    ij = jnp.stack([jnp.arange(1, M), jnp.arange(0, M - 1)], axis=-1).astype(jnp.int32)
    Z = jnp.einsum("eij,ejk->eik", poses[1:], se3.inverse(poses[:-1]))
    return ij, Z
