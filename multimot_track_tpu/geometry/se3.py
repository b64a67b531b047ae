"""SE(3) Lie-group operations as pure jnp functions.

Everything is batched-friendly: every function accepts arbitrary leading
batch dimensions.  Transforms are stored as (..., 4, 4) float arrays; the
tangent convention is ``xi = (omega, upsilon)`` — rotation first — matching
g2o's ``SE3Quat::exp`` used by the reference optimizer
(/root/reference/Thirdparty/g2o/g2o/types/se3quat.h), so Levenberg updates
compose the same way: ``T <- exp(xi) @ T``.

This module replaces the reference's cv::Mat/Eigen/g2o conversion soup
(src/Converter.cc, Tracking::InvMatrix src/Tracking.cc:5106-5121).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(omega: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = jnp.zeros_like(ox)
    return jnp.stack(
        [
            jnp.stack([zero, -oz, oy], axis=-1),
            jnp.stack([oz, zero, -ox], axis=-1),
            jnp.stack([-oy, ox, zero], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) -> (..., 3, 3).  Safe at ||omega|| -> 0."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # Taylor-safe coefficients
    a = jnp.sin(theta) / theta
    b = (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS)
    small = theta2 < 1e-10
    a = jnp.where(small, 1.0 - theta2 / 6.0, a)
    b = jnp.where(small, 0.5 - theta2 / 24.0, b)
    K = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3).

    Differentiation-safe at theta -> 0: the arccos/sin branch is evaluated
    on sanitised inputs (double-where) so jacfwd/jacrev through residuals
    of near-identity transforms (pose-graph odometry edges) stay finite.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_t > 1.0 - 1e-6          # theta < ~1.4e-3
    cos_safe = jnp.where(small, 0.0, cos_t)   # keep arccos grad finite
    theta = jnp.arccos(cos_safe)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    sin_safe = jnp.where(small, 1.0, sin_t)
    # theta/(2 sin theta); at theta << 1 the correction is O(theta^2) < 1e-6
    scale = jnp.where(small, 0.5, theta / (2.0 * sin_safe))
    # NOTE: near theta = pi this loses precision; the pipeline only sees
    # frame-to-frame motions (theta << pi) so the simple formula suffices.
    return scale[..., None] * w


def _so3_left_jacobian(omega: jnp.ndarray) -> jnp.ndarray:
    """V such that t = V @ upsilon in exp_se3."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    b = (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS)
    c = (theta - jnp.sin(theta)) / (theta2 * theta + _EPS)
    small = theta2 < 1e-10
    b = jnp.where(small, 0.5 - theta2 / 24.0, b)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    return eye + b[..., None, None] * K + c[..., None, None] * (K @ K)


def exp_se3(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential: (..., 6) tangent (omega, upsilon) -> (..., 4, 4)."""
    omega, ups = xi[..., :3], xi[..., 3:]
    R = exp_so3(omega)
    V = _so3_left_jacobian(omega)
    t = jnp.einsum("...ij,...j->...i", V, ups)
    return make_T(R, t)


def _so3_left_jacobian_inv(omega: jnp.ndarray) -> jnp.ndarray:
    """Closed-form V^{-1} = I - K/2 + (1/theta^2 - (1+cos)/(2 theta sin)) K^2
    — avoids a batched 3x3 LAPACK solve in log_se3 (tiny-solve custom calls
    serialize badly, geometry/smallsolve.py)."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    small = theta2 < 1e-10
    denom = jnp.where(small, 1.0, 2.0 * theta * sin_t)
    c = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / jnp.maximum(theta2, _EPS * _EPS) - (1.0 + cos_t) / denom,
    )
    return eye - 0.5 * K + c[..., None, None] * (K @ K)


def log_se3(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6) tangent (omega, upsilon)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = log_so3(R)
    Vinv = _so3_left_jacobian_inv(omega)
    ups = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([omega, ups], axis=-1)


def make_T(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) adjoint for the (omega, upsilon) tangent ordering:
    Ad(T) = [[R, 0], [hat(t) R, R]]  (6, 6); satisfies
    T exp(xi) T^-1 = exp(Ad(T) xi)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    z = jnp.zeros(T.shape[:-2] + (3, 3), T.dtype)
    top = jnp.concatenate([R, z], axis=-1)
    bottom = jnp.concatenate([hat(t) @ R, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Rigid inverse (reference Tracking::InvMatrix, src/Tracking.cc:5106)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply T to points (..., 3); batch dims of T and pts must broadcast
    (e.g. (4,4) x (N,3), or (B,4,4) x (B,3))."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...j->...i", R, pts) + t


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to a point *set* (..., N, 3) sharing batch dims."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def rotation_angle_deg(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation magnitude in degrees via the reference's clamped-trace formula.

    The reference folds diagonal entries > 1 as ``1 - (d - 1)`` before the
    acos (src/Tracking.cc:1330-1343, 2225-2239) to guard against numeric
    drift; replicated exactly for metric parity.
    """
    d = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    d = jnp.where(d > 1.0, 1.0 - (d - 1.0), d)
    trace = jnp.sum(d, axis=-1)
    cos_t = (trace - 1.0) * 0.5
    return jnp.arccos(jnp.clip(cos_t, -1.0, 1.0)) * (180.0 / 3.1415926)


def euler_y_to_R(yaw: jnp.ndarray) -> jnp.ndarray:
    """R = Ry(yaw)·Rx(0)·Rz(0) as composed by the reference's KITTI object-pose
    parser (Tracking::ObjPoseParsing, src/Tracking.cc:4997-5104), which adds
    pi/2 to the raw rotation_y before calling this.
    """
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    zero = jnp.zeros_like(yaw)
    one = jnp.ones_like(yaw)
    return jnp.stack(
        [
            jnp.stack([cy, zero, sy], axis=-1),
            jnp.stack([zero, one, zero], axis=-1),
            jnp.stack([-sy, zero, cy], axis=-1),
        ],
        axis=-2,
    )
