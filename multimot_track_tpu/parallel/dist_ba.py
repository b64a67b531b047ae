"""Distributed flow-BA: point set sharded over the mesh, reduced 6x6 system
assembled with ``psum`` over the device interconnect.

This is the "distributed communication backend" the reference lacks
(SURVEY.md §2.5 last row): per-point Hessian/gradient blocks are computed
locally on each device's shard, the flow vertices are Schur-eliminated
*locally* (their blocks are per-point scalars, so elimination never crosses
shards), and only the 6x6 reduced camera/motion system plus the scalar
objective cross the interconnect — ~50 floats per device per LM iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from multimot_track_tpu.geometry import camera, se3
from multimot_track_tpu.solvers.flow_ba import FlowBAParams, _residual_chi2
from multimot_track_tpu.parallel.mesh import POINT_AXIS


def _local_blocks(T, f, Xw, obs, flow_meas, valid, lam, p: FlowBAParams, fx, fy, cx, cy):
    """Per-shard Schur-reduced system pieces (same algebra as the single-chip
    kernel in solvers/flow_ba._build_and_solve, factored for psum)."""
    y = se3.transform(T, Xw)
    r_p = (obs + f) - camera.project(y, fx, fy, cx, cy)
    r_f = f - flow_meas
    chi2_p = p.reproj_info * jnp.sum(r_p * r_p, axis=-1)
    w_rob = jnp.where(
        chi2_p <= p.rp_thres, 1.0, jnp.sqrt(p.rp_thres / jnp.maximum(chi2_p, 1e-20))
    )
    vw = jnp.where(valid, w_rob, 0.0)
    wp = p.reproj_info * vw
    wf = p.prior_info * jnp.where(valid, 1.0, 0.0)
    z = y[..., 2]
    inv_z = 1.0 / jnp.maximum(z, 1e-6)
    zero = jnp.zeros_like(z)
    dpi = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
        ],
        axis=-2,
    )
    dy = jnp.concatenate(
        [-se3.hat(y), jnp.broadcast_to(jnp.eye(3, dtype=y.dtype), y.shape[:-1] + (3, 3))],
        axis=-1,
    )
    A = -jnp.einsum("nij,njk->nik", dpi, dy)
    h_ff = wp + wf + lam
    g_f = wp[:, None] * r_p + wf[:, None] * r_f
    AtW = jnp.einsum("nia,n->nia", A, wp)
    H_loc = jnp.einsum("nia,nib,n->ab", A, A, wp) - jnp.einsum(
        "nia,nib,n->ab", AtW, AtW, 1.0 / h_ff
    )
    g_loc = jnp.einsum("nia,ni,n->a", A, r_p, wp) - jnp.einsum(
        "nia,ni,n->a", AtW, g_f, 1.0 / h_ff
    )
    return A, wp, h_ff, g_f, H_loc, g_loc


def make_distributed_flow_ba(mesh: Mesh, params: FlowBAParams, fx, fy, cx, cy):
    """Build a distributed solver over ``mesh`` (axis 'point'): inputs
    sharded on their point axis, pose replicated, LM loop device-side."""
    p = params
    pt = P(POINT_AXIS)
    rep = P()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, pt, pt, pt, pt),
        out_specs=rep,
    )
    def solve(T_init, Twl, obs, flow_meas, depth, valid):
        Xw = se3.transform(Twl, camera.backproject(obs, depth, fx, fy, cx, cy))
        valid_ = valid & (depth > 0)
        f0 = flow_meas

        def objective(T, f):
            F_loc, _ = _residual_chi2(T, f, Xw, obs, flow_meas, valid_, p, fx, fy, cx, cy)
            return jax.lax.psum(F_loc, POINT_AXIS)

        F0 = objective(T_init, f0)
        y0 = se3.transform(T_init, Xw)
        z0 = jnp.maximum(y0[..., 2], 1e-6)
        diag_loc = jnp.max(
            jnp.where(valid_, p.reproj_info * ((fx / z0) ** 2 + (fy / z0) ** 2), 0.0)
        )
        lam0 = p.tau * jnp.maximum(jax.lax.pmax(diag_loc, POINT_AXIS), 1.0)

        def body(state):
            it, T, f, F, lam, nu = state
            A, wp, h_ff, g_f, H_loc, g_loc = _local_blocks(
                T, f, Xw, obs, flow_meas, valid_, lam, p, fx, fy, cx, cy
            )
            H_red = jax.lax.psum(H_loc, POINT_AXIS) + lam * jnp.eye(6, dtype=T.dtype)
            g_red = jax.lax.psum(g_loc, POINT_AXIS)
            dxi = jnp.linalg.solve(H_red, -g_red)
            Adxi = jnp.einsum("nia,a->ni", A, dxi)
            df = -(g_f + wp[:, None] * Adxi) / h_ff[:, None]
            T_new = se3.exp_se3(dxi) @ T
            f_new = f + df
            F_new = objective(T_new, f_new)
            pred_loc = 0.5 * jnp.sum(
                jnp.where(valid_[:, None], df * (lam * df - g_f), 0.0)
            )
            pred = 0.5 * jnp.dot(dxi, lam * dxi - g_red) + jax.lax.psum(
                pred_loc, POINT_AXIS
            )
            gain = (F - F_new) / jnp.maximum(pred, 1e-20)
            accept = (F_new < F) & jnp.isfinite(F_new)
            lam_acc = lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
            T = jnp.where(accept, T_new, T)
            f = jnp.where(accept, f_new, f)
            F = jnp.where(accept, F_new, F)
            lam = jnp.where(accept, lam_acc, lam * nu)
            nu = jnp.where(accept, 2.0, nu * 2.0)
            return (it + 1, T, f, F, lam, nu)

        def cond(state):
            return state[0] < p.iters

        out = jax.lax.while_loop(
            cond, body, (jnp.int32(0), T_init, f0, F0, lam0, jnp.float32(2.0))
        )
        return out[1]

    return solve
