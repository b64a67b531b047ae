"""Parallel-in-time tracking: a batch of frame pairs sharded over the mesh.

The reference is strictly sequential frame-to-frame (SURVEY.md §5 "window of
2").  The observation: each pair's *relative* solves (camera and
objects) depend on the previous frame only through its pose, and the flow-BA
measurement model is expressed in the last frame's coordinates — so with
Twl = I the per-pair solves are fully independent.  We therefore:

  1. solve every pair's relative camera motion T_rel[k] = Tcw_k @ Twc_{k-1}
     in parallel across devices (axis "pair"),
  2. compose the trajectory with an associative scan (log-depth),
  3. optionally re-run object solves given the composed poses.

This turns frames/s into a quantity that scales with the mesh instead of
the host clock.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from multimot_track_tpu.config import PipelineConfig
from multimot_track_tpu.solvers import ransac
from multimot_track_tpu.solvers.flow_ba import FlowBAParams, solve_flow_ba_auto
from multimot_track_tpu.geometry import camera
from multimot_track_tpu.parallel.mesh import Mesh, NamedSharding, P, PAIR_AXIS


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve_relative_batch(
    keys: jax.Array,          # (B, 2) PRNG keys
    st_uv: jnp.ndarray,       # (B, N, 2) last-frame static positions
    st_flow: jnp.ndarray,     # (B, N, 2)
    st_depth: jnp.ndarray,    # (B, N)
    st_cur_uv: jnp.ndarray,   # (B, N, 2)
    st_cur_depth: jnp.ndarray,  # (B, N)
    st_valid: jnp.ndarray,    # (B, N)
    cfg: PipelineConfig,
) -> jnp.ndarray:
    """Per-pair relative camera motion T_rel (B, 4, 4), batched; the batch
    axis may be sharded over the mesh — XLA partitions the whole program."""
    cam = cfg.camera
    sol = cfg.solver
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    eye = jnp.eye(4)
    params = FlowBAParams(
        reproj_info=sol.reproj_info,
        prior_info=sol.cam_flow_prior_info,
        rp_thres=sol.cam_rp_thres,
        iters=sol.cam_lm_iters,
        tau=sol.lm_tau,
    )

    def one(key, uv, flow, depth, cur_uv, cur_depth, valid):
        Xl = camera.backproject(uv, depth, fx, fy, cx, cy)  # last-cam frame = "world"
        xyz_cur = camera.backproject(cur_uv, cur_depth, fx, fy, cx, cy)
        rr = ransac.ransac_rigid_pose(
            key, Xl, cur_uv, xyz_cur, valid & (cur_depth > 0),
            fx, fy, cx, cy,
            thresh=sol.ransac_reproj_px, iters=sol.ransac_iters,
            refine_iters=sol.refine_gn_iters,
        )
        res = solve_flow_ba_auto(
            rr.T, eye, uv, flow, depth, valid, fx, fy, cx, cy, params=params,
        )
        return res.T

    return jax.vmap(one)(keys, st_uv, st_flow, st_depth, st_cur_uv, st_cur_depth, st_valid)


def compose_trajectory(T_rel: jnp.ndarray) -> jnp.ndarray:
    """Associative scan composing relative motions into absolute poses.

    T_rel[k] maps frame-(k) camera coords from frame-(k-1) camera coords,
    i.e. Tcw_k = T_rel[k] @ Tcw_{k-1} with Tcw_0 = I.  Returns (B+1, 4, 4)
    of Tcw including the identity first frame.
    """
    def combine(a, b):
        return jnp.einsum("...ij,...jk->...ik", b, a)  # later @ earlier

    comp = jax.lax.associative_scan(combine, T_rel, axis=0)
    eye = jnp.eye(4, dtype=T_rel.dtype)[None]
    return jnp.concatenate([eye, comp], axis=0)


def shard_pairs(mesh: Mesh, tree):
    """Place a pair-batch pytree with its leading axis over the mesh."""
    sh = NamedSharding(mesh, P(PAIR_AXIS))
    return jax.device_put(tree, sh)
