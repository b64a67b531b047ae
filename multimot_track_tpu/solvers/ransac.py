"""Batched fixed-iteration RANSAC pose initialization.

Batched re-design of the reference's ``GetInitModelObj``/``GetInitModelCam``
(cv::solvePnPRansac AP3P, 500 iterations, 0.3 px reprojection gate,
src/Tracking.cc:4227-4443): no data-dependent early exit — all hypotheses
are generated and scored in one batched program, the winner picked by
argmax (SURVEY.md §7).

Hypotheses come from 3-point Horn alignment between the last frame's world
points and the current frame's back-projected points (both depths are
measurements in this RGB-D pipeline), scored with the reference's 2D
reprojection-error gate so inlier semantics match.  The winner is polished
by a few Gauss-Newton iterations on its inliers — the counterpart of
OpenCV's final LM refinement inside solvePnPRansac.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera, se3, smallsolve
from multimot_track_tpu.solvers import horn


class RansacResult(NamedTuple):
    T: jnp.ndarray          # (4, 4) pose: cur_cam <- last_world
    inliers: jnp.ndarray    # (N,) bool
    n_inliers: jnp.ndarray  # () int32


def _count_inliers(T, Xw, uv, valid, thresh, fx, fy, cx, cy):
    y = se3.transform(T, Xw)
    err = jnp.linalg.norm(camera.project(y, fx, fy, cx, cy) - uv, axis=-1)
    inl = valid & (err < thresh) & (y[..., 2] > 0)
    return inl, jnp.sum(inl.astype(jnp.int32))


def _proj_point_jacobian(y, fx, fy, bf=None):
    """Jacobian of the (u, v[, disparity]) residual of a camera-frame point
    ``y`` w.r.t. a left se(3) perturbation of the pose: (N, 2, 6), or
    (N, 3, 6) with the stereo disparity row bf/z appended when ``bf`` is
    given.  Shared by the 2D GN refiner below and the stereo refiner."""
    z = jnp.maximum(y[..., 2], 1e-6)
    inv_z = 1.0 / z
    zero = jnp.zeros_like(z)
    rows = [
        jnp.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
        jnp.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
    ]
    if bf is not None:
        rows.append(jnp.stack([zero, zero, -bf * inv_z * inv_z], -1))
    dpi = jnp.stack(rows, axis=-2)                        # (N, R, 3)
    dy = jnp.concatenate(
        [-se3.hat(y), jnp.broadcast_to(jnp.eye(3, dtype=y.dtype), y.shape[:-1] + (3, 3))],
        axis=-1,
    )                                                      # (N, 3, 6)
    return jnp.einsum("nij,njk->nik", dpi, dy)             # (N, R, 6)


def _gn_refine(T, Xw, uv, w, iters, fx, fy, cx, cy):
    """Weighted Gauss-Newton on 2D reprojection over the inlier set."""

    def step(_, T):
        y = se3.transform(T, Xw)
        r = camera.project(y, fx, fy, cx, cy) - uv        # (N, 2)
        J = _proj_point_jacobian(y, fx, fy)               # (N, 2, 6)
        H = jnp.einsum("nia,nib,n->ab", J, J, w) + 1e-6 * jnp.eye(6, dtype=T.dtype)
        g = jnp.einsum("nia,ni,n->a", J, r, w)
        dxi = smallsolve.solve_spd6(H, -g)
        return se3.exp_se3(dxi) @ T

    return jax.lax.fori_loop(0, iters, step, T)


def _gn_refine_stereo(T, Xw, uv_obs, disp_obs, w, w_disp, iters, fx, fy, cx, cy, bf):
    """Weighted GN on the stereo reprojection residual (u, v, disparity)
    — the reference's stereo PoseOptimization edge
    (EdgeStereoSE3ProjectXYZOnlyPose: e = (u, v, u - fx*b/z) residuals,
    src/Optimizer.cc:3221-3260).  The disparity row constrains the
    forward axis that pure 2D reprojection leaves soft; ``w_disp``
    carries the per-point depth-variance weight (disparity error grows
    with range exactly as the ego edges' depth weighting models)."""

    def step(_, T):
        y = se3.transform(T, Xw)
        r_uv = camera.project(y, fx, fy, cx, cy) - uv_obs          # (N, 2)
        r_d = bf / jnp.maximum(y[..., 2], 1e-6) - disp_obs         # (N,)
        J = _proj_point_jacobian(y, fx, fy, bf=bf)                 # (N, 3, 6)
        r = jnp.concatenate([r_uv, r_d[..., None]], axis=-1)       # (N, 3)
        wr = jnp.stack([w, w, w * w_disp], axis=-1)                # (N, 3)
        H = jnp.einsum("nia,nib,ni->ab", J, J, wr) + 1e-6 * jnp.eye(6, dtype=T.dtype)
        g = jnp.einsum("nia,ni,ni->a", J, r, wr)
        dxi = smallsolve.solve_spd6(H, -g)
        return se3.exp_se3(dxi) @ T

    return jax.lax.fori_loop(0, iters, step, T)


@functools.partial(jax.jit, static_argnames=("iters", "refine_iters"))
def ransac_rigid_pose(
    key: jax.Array,
    Xw_last: jnp.ndarray,      # (N, 3) last-frame points in world
    uv_cur: jnp.ndarray,       # (N, 2) current-frame pixel observations
    xyz_cur: jnp.ndarray,      # (N, 3) current-frame back-projected points (camera frame)
    valid: jnp.ndarray,        # (N,) bool
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    thresh: float = 0.3,
    iters: int = 500,
    refine_iters: int = 10,
) -> RansacResult:
    N = Xw_last.shape[0]
    vf = valid.astype(jnp.float32)
    p = vf / jnp.maximum(jnp.sum(vf), 1.0)
    idx = jax.random.choice(key, N, shape=(iters, 3), replace=True, p=p)
    src = Xw_last[idx]      # (iters, 3, 3)
    dst = xyz_cur[idx]
    T_hyp = horn.rigid_align(src, dst)                     # (iters, 4, 4)

    def score(T):
        _, n = _count_inliers(T, Xw_last, uv_cur, valid, thresh, fx, fy, cx, cy)
        return n

    # score hypotheses in chunks: a flat vmap materialises (iters, N, 3)
    # intermediates, which blows device memory once this solver itself sits under a
    # pairs x objects vmap; lax.map bounds the live set to one chunk
    chunk = 250
    n_chunks = max(iters // chunk, 1)
    if iters % chunk == 0 and n_chunks > 1:
        counts = jax.lax.map(
            jax.vmap(score), T_hyp.reshape(n_chunks, chunk, 4, 4)
        ).reshape(iters)
    else:
        counts = jax.vmap(score)(T_hyp)
    best = jnp.argmax(counts)
    T_best = T_hyp[best]
    inl0, _ = _count_inliers(T_best, Xw_last, uv_cur, valid, thresh, fx, fy, cx, cy)
    T_ref = _gn_refine(
        T_best, Xw_last, uv_cur, inl0.astype(jnp.float32), refine_iters, fx, fy, cx, cy
    )
    # keep the refinement only if it does not lose inliers
    inl1, n1 = _count_inliers(T_ref, Xw_last, uv_cur, valid, thresh, fx, fy, cx, cy)
    n0 = jnp.sum(inl0.astype(jnp.int32))
    take_ref = n1 >= n0
    T_out = jnp.where(take_ref, T_ref, T_best)
    inl = jnp.where(take_ref, inl1, inl0)
    return RansacResult(T=T_out, inliers=inl, n_inliers=jnp.maximum(n0, n1))
