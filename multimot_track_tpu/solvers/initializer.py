"""Monocular two-view initialization (H/F model selection + pose recovery).

Counterpart of the reference Initializer (src/Initializer.cc): parallel
RANSAC over a fundamental-matrix model and a homography model, the
reference's SH/(SH+SF) > 0.40 selection rule, then pose recovery and
triangulation with cheirality/parallax checks.

Batched shape: all hypotheses for both models are solved and scored as one
batch (8-point F via vmapped SVD, 4-point H via DLT); triangulation of all
points under all 4 (R, t) candidates is a single batched linear solve.

When the homography model wins, the pose is recovered by the Faugeras
H-decomposition (:func:`decompose_homography`, the reference's
ReconstructH path, src/Initializer.cc) — all 8 (R, t, n) candidates are
triangulated and cheirality-scored as one batch together with the
essential-matrix candidates, and the model-selection flag picks which
candidate set counts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import se3


def _normalize(pts):
    mean = jnp.mean(pts, axis=-2, keepdims=True)
    d = jnp.mean(jnp.linalg.norm(pts - mean, axis=-1), axis=-1)
    s = jnp.sqrt(2.0) / jnp.maximum(d, 1e-9)
    T = (
        jnp.zeros(pts.shape[:-2] + (3, 3))
        .at[..., 0, 0].set(s)
        .at[..., 1, 1].set(s)
        .at[..., 0, 2].set(-s * mean[..., 0, 0])
        .at[..., 1, 2].set(-s * mean[..., 0, 1])
        .at[..., 2, 2].set(1.0)
    )
    pn = (pts - mean) * s[..., None, None]
    return pn, T


def eight_point_F(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """(..., 8+, 2) x2 -> (..., 3, 3) fundamental matrices (normalized 8-pt)."""
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1)
    _, _, Vt = jnp.linalg.svd(A)
    F = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    U, S, Vt2 = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)  # rank-2 enforcement
    F = jnp.einsum("...ij,...j,...jk->...ik", U, S, Vt2)
    return jnp.einsum("...ji,...jk,...kl->...il", T2, F, T1)


def four_point_H(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """(..., 4+, 2) x2 -> (..., 3, 3) homographies (DLT)."""
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], axis=-1)
    r2 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)
    _, _, Vt = jnp.linalg.svd(A)
    Hn = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    return jnp.einsum("...ij,...jk,...kl->...il", jnp.linalg.inv(T2), Hn, T1)


def _sym_epipolar_score(F, p1, p2, sigma2=1.0, th=3.841, th_score=5.991):
    """The reference's CheckFundamental scoring: chi-square transfer errors
    both ways, score = sum of (th_score - chi2) over inliers."""
    ones = jnp.ones(p1.shape[:-1] + (1,), p1.dtype)
    x1 = jnp.concatenate([p1, ones], axis=-1)
    x2 = jnp.concatenate([p2, ones], axis=-1)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2)
    x2Fx1 = jnp.sum(x2 * Fx1, axis=-1)
    e2_1 = x2Fx1**2 / jnp.maximum(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, 1e-12) / sigma2
    e2_2 = x2Fx1**2 / jnp.maximum(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, 1e-12) / sigma2
    ok = (e2_1 < th) & (e2_2 < th)
    score = jnp.sum(
        jnp.where(e2_1 < th, th_score - e2_1, 0.0)
        + jnp.where(e2_2 < th, th_score - e2_2, 0.0),
        axis=-1,
    )
    return ok, score


def _homography_score(H, p1, p2, sigma2=1.0, th=5.991):
    ones = jnp.ones(p1.shape[:-1] + (1,), p1.dtype)
    x1 = jnp.concatenate([p1, ones], axis=-1)
    x2 = jnp.concatenate([p2, ones], axis=-1)
    Hx1 = jnp.einsum("...ij,...nj->...ni", H, x1)
    Hinvx2 = jnp.einsum("...ij,...nj->...ni", jnp.linalg.inv(H), x2)
    p2h = Hx1[..., :2] / jnp.maximum(Hx1[..., 2:3], 1e-12)
    p1h = Hinvx2[..., :2] / jnp.maximum(Hinvx2[..., 2:3], 1e-12)
    e2_2 = jnp.sum((p2 - p2h) ** 2, axis=-1) / sigma2
    e2_1 = jnp.sum((p1 - p1h) ** 2, axis=-1) / sigma2
    ok = (e2_1 < th) & (e2_2 < th)
    score = jnp.sum(
        jnp.where(e2_1 < th, th - e2_1, 0.0) + jnp.where(e2_2 < th, th - e2_2, 0.0),
        axis=-1,
    )
    return ok, score


def decompose_homography(H: jnp.ndarray, K: jnp.ndarray):
    """Faugeras-Lustman decomposition of a calibrated homography.

    Counterpart of the reference Initializer::ReconstructH candidate
    enumeration (src/Initializer.cc; Faugeras & Lustman 1988, "Motion and
    structure from motion in a piecewise planar environment").  Returns the
    8 candidate motions as a batch:

      R (8, 3, 3), t (8, 3) unit-norm, n (8, 3) plane normals,
      valid () bool — False when the singular values are too close for the
      decomposition to be well-conditioned (the reference rejects
      d1/d2 or d2/d3 within 1.00001).
    """
    A = jnp.linalg.inv(K) @ H @ K
    U, d, Vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    valid = (d1 / jnp.maximum(d2, 1e-12) > 1.00001) & (
        d2 / jnp.maximum(d3, 1e-12) > 1.00001
    )

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    x1m = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    x3m = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    e1 = jnp.asarray([1.0, 1.0, -1.0, -1.0])
    e3 = jnp.asarray([1.0, -1.0, 1.0, -1.0])

    # --- case d' = +d2: rotation about y by theta -----------------------
    st = (
        e1 * e3 * jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
        / jnp.maximum((d1 + d3) * d2, 1e-12)
    )                                           # (4,)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)

    def rot_y(c, sn, flip):
        # flip=False: diag(+1) theta-form; flip=True: the d'=-d2 phi-form
        if not flip:
            return jnp.stack([
                jnp.stack([c, jnp.zeros_like(c), -sn], -1),
                jnp.stack([jnp.zeros_like(c), jnp.ones_like(c), jnp.zeros_like(c)], -1),
                jnp.stack([sn, jnp.zeros_like(c), c], -1),
            ], -2)
        return jnp.stack([
            jnp.stack([c, jnp.zeros_like(c), sn], -1),
            jnp.stack([jnp.zeros_like(c), -jnp.ones_like(c), jnp.zeros_like(c)], -1),
            jnp.stack([sn, jnp.zeros_like(c), -c], -1),
        ], -2)

    Rp_pos = rot_y(jnp.full(4, ct), st, flip=False)             # (4, 3, 3)
    tp_pos = (d1 - d3) * jnp.stack([e1 * x1m, jnp.zeros(4), -e3 * x3m], -1)
    np_pos = jnp.stack([e1 * x1m, jnp.zeros(4), e3 * x3m], -1)

    # --- case d' = -d2: rotation-with-reflection by phi -----------------
    sp = (
        e1 * e3 * jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
        / jnp.maximum((d1 - d3) * d2, 1e-12)
    )
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    Rp_neg = rot_y(jnp.full(4, cp), sp, flip=True)
    tp_neg = (d1 + d3) * jnp.stack([e1 * x1m, jnp.zeros(4), e3 * x3m], -1)
    np_neg = np_pos

    Rp = jnp.concatenate([Rp_pos, Rp_neg])                      # (8, 3, 3)
    tp = jnp.concatenate([tp_pos, tp_neg])                      # (8, 3)
    npl = jnp.concatenate([np_pos, np_neg])

    R = s * jnp.einsum("ij,bjk,kl->bil", U, Rp, Vt)
    t = jnp.einsum("ij,bj->bi", U, tp)
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    n = jnp.einsum("ji,bj->bi", Vt, npl)
    # normals conventionally point towards the camera (n_z > 0)
    n = jnp.where(n[..., 2:3] < 0, -n, n)
    return R, t, n, valid


def triangulate(P1, P2, p1, p2):
    """DLT triangulation: P (3, 4) projection matrices, p (..., 2)."""
    rows = jnp.stack(
        [
            p1[..., 0, None] * P1[2] - P1[0],
            p1[..., 1, None] * P1[2] - P1[1],
            p2[..., 0, None] * P2[2] - P2[0],
            p2[..., 1, None] * P2[2] - P2[1],
        ],
        axis=-2,
    )
    _, _, Vt = jnp.linalg.svd(rows)
    Xh = Vt[..., -1, :]
    return Xh[..., :3] / jnp.where(jnp.abs(Xh[..., 3:]) > 1e-12, Xh[..., 3:], 1e-12)


class MonoInit(NamedTuple):
    ok: jnp.ndarray          # () bool — enough inliers + parallax
    used_homography: jnp.ndarray
    T21: jnp.ndarray         # (4, 4) pose of frame 2 w.r.t. frame 1 (t unit-norm)
    points3d: jnp.ndarray    # (N, 3) triangulated points in frame-1 coords
    inliers: jnp.ndarray     # (N,)


@functools.partial(jax.jit, static_argnames=("iters",))
def initialize_mono(
    key: jax.Array,
    uv1: jnp.ndarray,      # (N, 2) matched pixels frame 1
    uv2: jnp.ndarray,      # (N, 2) matched pixels frame 2
    valid: jnp.ndarray,
    fx, fy, cx, cy,
    iters: int = 200,
    sigma: float = 1.0,
    min_inliers: int = 50,
) -> MonoInit:
    N = uv1.shape[0]
    Kmat = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)
    Kinv = jnp.linalg.inv(Kmat)
    vf = valid.astype(jnp.float32)
    pr = vf / jnp.maximum(jnp.sum(vf), 1.0)
    kF, kH = jax.random.split(key)
    idxF = jax.random.choice(kF, N, shape=(iters, 8), replace=True, p=pr)
    idxH = jax.random.choice(kH, N, shape=(iters, 4), replace=True, p=pr)
    Fs = eight_point_F(uv1[idxF], uv2[idxF])
    Hs = four_point_H(uv1[idxH], uv2[idxH])
    s2 = sigma * sigma
    okF, scF = _sym_epipolar_score(Fs, uv1[None], uv2[None], s2)
    okH, scH = _homography_score(Hs, uv1[None], uv2[None], s2)
    scF = jnp.where(jnp.all(jnp.isfinite(Fs.reshape(iters, -1)), -1), scF, -1.0)
    scH = jnp.where(jnp.all(jnp.isfinite(Hs.reshape(iters, -1)), -1), scH, -1.0)
    bF = jnp.argmax(scF)
    bH = jnp.argmax(scH)
    SF = scF[bF]
    SH = scH[bH]
    use_H = SH / jnp.maximum(SH + SF, 1e-9) > 0.40   # Initializer RH rule

    F_best = Fs[bF]
    H_best = Hs[bH]
    inl = jnp.where(use_H, okH[bH], okF[bF]) & valid

    # essential decomposition (F model)
    E = Kmat.T @ F_best @ Kmat
    U, _, Vt = jnp.linalg.svd(E)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    tvec = U[:, 2]
    tvec = tvec / jnp.maximum(jnp.linalg.norm(tvec), 1e-12)

    cands_E = jnp.stack(
        [
            se3.make_T(R1, tvec), se3.make_T(R1, -tvec),
            se3.make_T(R2, tvec), se3.make_T(R2, -tvec),
            jnp.eye(4), jnp.eye(4), jnp.eye(4), jnp.eye(4),   # padding, masked
        ]
    )
    valid_E = jnp.asarray([True] * 4 + [False] * 4)

    # Faugeras decomposition (H model): 8 (R, t, n) candidates
    RsH, tsH, _, h_ok = decompose_homography(H_best, Kmat)
    cands_H = jax.vmap(se3.make_T)(RsH, tsH)
    valid_H = jnp.broadcast_to(h_ok, (8,))

    cand_T = jnp.where(use_H, cands_H, cands_E)
    cand_valid = jnp.where(use_H, valid_H, valid_E)

    P1 = Kmat @ jnp.eye(4)[:3]

    def eval_cand(T):
        P2 = Kmat @ T[:3]
        X = triangulate(P1, P2, uv1, uv2)
        z1 = X[..., 2]
        Xc2 = se3.transform(T, X)
        z2 = Xc2[..., 2]
        # reprojection gate in both views (Initializer CheckRT: err2 < 4*sigma2)
        # — with pure cheirality the two Faugeras planar solutions tie
        u1 = Kmat[0, 0] * X[..., 0] / z1 + Kmat[0, 2]
        v1 = Kmat[1, 1] * X[..., 1] / z1 + Kmat[1, 2]
        u2 = Kmat[0, 0] * Xc2[..., 0] / z2 + Kmat[0, 2]
        v2 = Kmat[1, 1] * Xc2[..., 1] / z2 + Kmat[1, 2]
        e1 = (u1 - uv1[..., 0]) ** 2 + (v1 - uv1[..., 1]) ** 2
        e2 = (u2 - uv2[..., 0]) ** 2 + (v2 - uv2[..., 1]) ** 2
        rp_ok = (e1 < 4.0 * sigma * sigma) & (e2 < 4.0 * sigma * sigma)
        ok_geom = (
            (z1 > 0) & (z2 > 0)
            & jnp.isfinite(z1) & jnp.isfinite(z2) & rp_ok
        )
        # candidate selection scores ALL matched points (deviation from the
        # reference, which scores only model inliers): for a plane-dominant
        # scene the two Faugeras solutions tie exactly on the planar inlier
        # set, and only the off-plane points — H-model outliers — separate
        # the true motion from its planar twin
        good_all = valid & ok_geom
        good_model = inl & ok_geom
        return (
            jnp.sum(good_all.astype(jnp.int32)),
            jnp.sum(good_model.astype(jnp.int32)),
            X,
            good_model,
        )

    ns_sel, ns_model, Xs, goods = jax.vmap(eval_cand)(cand_T)
    ns_sel = jnp.where(cand_valid, ns_sel, -1)
    best_c = jnp.argmax(ns_sel)
    n_good = ns_model[best_c]
    n_inl = jnp.sum(inl.astype(jnp.int32))
    # the cheirality/reprojection winner must clearly dominate the runner-up
    # (role of the reference's secondBestGood < 0.75*bestGood).  With the
    # all-points selection scoring the margin is what carries the signal —
    # the planar twin ties exactly on the plane and loses only the off-plane
    # points — so dominance is relative (<0.9) plus an absolute gap.
    n_valid = jnp.sum(valid.astype(jnp.int32))
    second = jnp.sort(ns_sel)[-2]
    best_sel = ns_sel[best_c].astype(jnp.float32)
    gap_ok = (second.astype(jnp.float32) < 0.9 * best_sel) & (
        (best_sel - second.astype(jnp.float32))
        > jnp.maximum(10.0, 0.02 * n_valid.astype(jnp.float32))
    )
    ok = (n_good > min_inliers) & (n_good.astype(jnp.float32) > 0.7 * n_inl) & gap_ok
    return MonoInit(
        ok=ok,
        used_homography=use_H,
        T21=cand_T[best_c],
        points3d=Xs[best_c],
        inliers=goods[best_c],
    )
