"""Batched tiny SPD solves as pure fused element ops.

``jnp.linalg.solve``/``cholesky`` lower to LAPACK-style custom calls, one
more launch per call inside a 100-iteration LM loop that is the critical
path.  For the fixed small sizes this
framework needs (6x6 pose blocks, 3x3 point blocks, 7x7 Sim3), an unrolled
Cholesky generates ~n^3/3 fused scalar ops over the batch — no custom
calls, no while loops, vmap/batch-friendly to any leading shape.
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_unrolled(H: jnp.ndarray, n: int) -> list:
    """Lower-triangular factor of SPD ``H`` (..., n, n) as an n x n list of
    batched scalars (None above the diagonal).  Unrolled at trace time."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def solve_spd(H: jnp.ndarray, g: jnp.ndarray, n: int) -> jnp.ndarray:
    """x with H x = g for SPD H: (..., n, n) @ (..., n) -> (..., n).

    ``n`` must be static (shapes are anyway under jit).  Forward+backward
    substitution unrolled; everything stays elementwise over the batch.
    """
    L = cholesky_unrolled(H, n)
    # L y = g
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def solve_spd6(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """6x6 SPD solve (pose blocks)."""
    return solve_spd(H, g, 6)


def solve_spd3(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """3x3 SPD solve (point blocks)."""
    return solve_spd(H, g, 3)


def inv_spd3(H: jnp.ndarray) -> jnp.ndarray:
    """Explicit symmetric 3x3 inverse via the adjugate (..., 3, 3)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e = H[..., 1, 1], H[..., 1, 2]
    f = H[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    row0 = jnp.stack([A, B, C], axis=-1)
    row1 = jnp.stack([B, D, E], axis=-1)
    row2 = jnp.stack([C, E, F], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]
