"""Fused flow-BA Levenberg-Marquardt solve: one Pallas kernel (Triton route).

``solvers/flow_ba.solve_flow_ba`` expresses one LM iteration as ~100 small
XLA ops (projection, Jacobian planes, 27 masked reductions, a 6x6 solve,
exp/compose) inside a ``lax.while_loop``.  On a GPU every fusion of that
chain is a kernel launch and every loop trip a predicate round trip, while
the arithmetic is only ~1 MFLOP per iteration at N=4096: the solve is
bound by launch latency.  This module runs the *entire* LM loop inside
one thread block per solve instance:

* the point set is one power-of-two 1-D block (any other N is padded with
  ``valid=0``); ``num_warps`` is sized so each thread holds 8 points;
* the per-point constants are re-read from global memory (L1/L2 resident)
  in every iteration, so only the flow estimate is carried in registers;
* the pose, damping and bookkeeping ride a ``lax.while_loop`` scalar
  carry, so the early-exit convergence gate (rel_tol) holds per instance;
* the 21 Hessian and 6 gradient entries of the Schur-reduced pose system
  are in-block reductions; the 6x6 system is solved by an unrolled scalar
  Cholesky (geometry/smallsolve.py's trick, on in-kernel scalars);
* ``vmap`` over solves becomes the kernel grid: one block per instance.

Numerics mirror ``solve_flow_ba`` (same measurement model as the
reference's EdgeSE3ProjectFlow2, types_six_dof_expmap.h:429-470; same
Nielsen lambda schedule as g2o's Levenberg strategy).  Only the reduction
order over points differs, so the two agree to float32 tolerance, not
bit-exactly (tests/test_flow_ba_pallas.py, chip_smoke.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from multimot_track_tpu.geometry import camera, se3
from multimot_track_tpu.solvers.flow_ba import FlowBAParams, FlowBAResult

_POINTS_PER_THREAD = 8
# packed scalar output: [0:16] the 4x4 pose row-major, [16] inlier count,
# [17] mean reprojection error, [18] final objective, [19] iterations
_OUT_LEN = 32


def padded_size(n: int) -> int:
    """Power-of-two block length holding ``n`` points (Triton blocks are
    powers of two)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def num_warps_for(n_pad: int) -> int:
    """Warps per block so each thread holds ~8 points without spilling."""
    return int(min(16, max(1, n_pad // (32 * _POINTS_PER_THREAD))))


def _chol_solve6(H, g):
    """x = H^{-1} g for a 6x6 SPD H given as lists of scalars.

    H: list-of-lists (row-major, full), g: list of 6 scalars.  Unrolled at
    trace time — pure scalar ops, no arrays (smallsolve.solve_spd6 logic).
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _exp_se3_scalar(xi):
    """se(3) exp on 6 scalars (omega, upsilon) -> (R 3x3 list, t 3 list).

    Mirrors geometry/se3.exp_se3 (incl. its eps regularisation) so the LM
    trajectory matches the XLA solve step for step."""
    EPS = 1e-8
    w0, w1, w2, u0, u1, u2 = xi
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = jnp.sqrt(th2 + EPS * EPS)
    small = th2 < 1e-10
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / (th2 + EPS * EPS))
    c = jnp.where(
        small, 1.0 / 6.0 - th2 / 120.0, (th - jnp.sin(th)) / (th2 * th + EPS)
    )
    # K = hat(w); R = I + a K + b K^2 ; V = I + b K + c K^2
    K = [[0.0, -w2, w1], [w2, 0.0, -w0], [-w1, w0, 0.0]]
    K2 = [
        [
            sum(K[i][k] * K[k][j] for k in range(3))
            for j in range(3)
        ]
        for i in range(3)
    ]
    eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    R = [[eye[i][j] + a * K[i][j] + b * K2[i][j] for j in range(3)] for i in range(3)]
    V = [[eye[i][j] + b * K[i][j] + c * K2[i][j] for j in range(3)] for i in range(3)]
    u = [u0, u1, u2]
    t = [sum(V[i][j] * u[j] for j in range(3)) for i in range(3)]
    return R, t


def _compose(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb) as scalar lists."""
    R = [
        [sum(Ra[i][k] * Rb[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]
    t = [sum(Ra[i][k] * tb[k] for k in range(3)) + ta[i] for i in range(3)]
    return R, t


def _mul(x, y):
    """Product that folds the Jacobian's literal zeros at trace time."""
    if isinstance(x, float) or isinstance(y, float):
        return 0.0
    return x * y


def _add(x, y):
    if isinstance(x, float):
        return y
    if isinstance(y, float):
        return x
    return x + y


def _make_kernel(p: FlowBAParams, fx, fy, cx, cy):
    """Kernel factory: params/intrinsics are compile-time constants."""
    wp0 = p.reproj_info
    wf0 = p.prior_info
    d2 = p.rp_thres

    def kernel(tin_ref, x0_ref, x1_ref, x2_ref, ob0_ref, ob1_ref, fm0_ref,
               fm1_ref, val_ref, wpt_ref, out_ref, f0_ref, f1_ref, chi2_ref):
        lane = jax.lax.broadcasted_iota(jnp.int32, (_OUT_LEN,), 0)
        tin = tin_ref[...]

        def scalar(k):
            return jnp.sum(jnp.where(lane == k, tin, 0.0))

        T0 = [[scalar(4 * i + j) for j in range(3)] for i in range(3)]
        t0 = [scalar(4 * i + 3) for i in range(3)]

        def transform(R, t):
            X0, X1, X2 = x0_ref[...], x1_ref[...], x2_ref[...]
            y0 = R[0][0] * X0 + R[0][1] * X1 + R[0][2] * X2 + t[0]
            y1 = R[1][0] * X0 + R[1][1] * X1 + R[1][2] * X2 + t[1]
            y2 = R[2][0] * X0 + R[2][1] * X1 + R[2][2] * X2 + t[2]
            return y0, y1, y2

        def residual(R, t, f0, f1):
            """Reprojection residual r_p and camera-frame points (as in
            flow_ba._residual_chi2 via camera.project)."""
            y0, y1, y2 = transform(R, t)
            iz = 1.0 / (y2 + 1e-9)
            r0 = (ob0_ref[...] + f0) - (fx * y0 * iz + cx)
            r1 = (ob1_ref[...] + f1) - (fy * y1 * iz + cy)
            return r0, r1, (y0, y1, y2)

        def objective(R, t, f0, f1):
            """Robust total objective F (valid-masked), as in _residual_chi2."""
            r0, r1, _ = residual(R, t, f0, f1)
            chi2w = wpt_ref[...] * wp0 * (r0 * r0 + r1 * r1)
            rho = jnp.where(
                chi2w <= d2,
                chi2w,
                2.0 * jnp.sqrt(d2 * jnp.maximum(chi2w, 1e-20)) - d2,
            )
            rf0 = f0 - fm0_ref[...]
            rf1 = f1 - fm1_ref[...]
            chi2f = wf0 * (rf0 * rf0 + rf1 * rf1)
            return jnp.sum(jnp.where(val_ref[...] > 0, rho + chi2f, 0.0))

        # ---- lambda seed: tau * max(diag scale) (solve_flow_ba) ----
        _, _, y2i = transform(T0, t0)
        zi = jnp.maximum(y2i, 1e-6)
        scale = (fx / zi) ** 2 + (fy / zi) ** 2
        lam0 = p.tau * jnp.maximum(
            jnp.max(jnp.where(val_ref[...] > 0, wpt_ref[...] * wp0 * scale, 0.0)),
            1.0,
        )
        fm0 = fm0_ref[...]
        fm1 = fm1_ref[...]
        F0 = objective(T0, t0, fm0, fm1)

        def body(state):
            (it, R00, R01, R02, R10, R11, R12, R20, R21, R22,
             tx, ty, tz, f0, f1, F, lam, nu, done) = state
            R = [[R00, R01, R02], [R10, R11, R12], [R20, R21, R22]]
            t = [tx, ty, tz]
            vmask = val_ref[...]

            # ---- build: residuals, robust weights, Jacobian rows ----
            r0, r1, (y0, y1, y2) = residual(R, t, f0, f1)
            chi2w = wpt_ref[...] * wp0 * (r0 * r0 + r1 * r1)
            w_rob = jnp.where(
                chi2w <= d2, 1.0, jnp.sqrt(d2 / jnp.maximum(chi2w, 1e-20))
            )
            wp = wpt_ref[...] * wp0 * w_rob * vmask
            wf = wf0 * vmask

            iz = 1.0 / jnp.maximum(y2, 1e-6)               # Jacobian projection
            a = fx * iz
            b = -fx * y0 * iz * iz
            c = fy * iz
            d = -fy * y1 * iz * iz
            # A = d r_p/d xi, xi = (omega, ups): A0 row (du), A1 row (dv)
            A0 = (-b * y1, -a * y2 + b * y0, a * y1, -a, 0.0, -b)
            A1 = (c * y2 - d * y1, d * y0, -c * y0, 0.0, -c, -d)

            # flow block h_ff = wp + wf + lam; Schur weight wH = wp(wf+lam)/h_ff
            h_ff = wp + wf + lam
            inv_h = 1.0 / h_ff
            wH = wp * (wf + lam) * inv_h
            # effective rhs per point: e = wp[(1 - wp/h)r_p - (wf/h)r_f]
            rf0 = f0 - fm0_ref[...]
            rf1 = f1 - fm1_ref[...]
            k1 = 1.0 - wp * inv_h
            k2 = wf * inv_h
            e0 = wp * (k1 * r0 - k2 * rf0)
            e1 = wp * (k1 * r1 - k2 * rf1)

            # upper-triangle reduced Hessian + gradient as block reductions
            H = [[None] * 6 for _ in range(6)]
            g = [None] * 6
            for i in range(6):
                for j in range(i, 6):
                    acc = _add(_mul(A0[i], A0[j]), _mul(A1[i], A1[j]))
                    Hij = (jnp.float32(0.0) if isinstance(acc, float)
                           else jnp.sum(wH * acc))
                    H[i][j] = Hij
                    H[j][i] = Hij
                gacc = _add(_mul(A0[i], e0), _mul(A1[i], e1))
                g[i] = (jnp.float32(0.0) if isinstance(gacc, float)
                        else jnp.sum(gacc))
            for i in range(6):
                H[i][i] = H[i][i] + lam

            dxi = _chol_solve6(H, [-gi for gi in g])

            # flow back-substitution: df = -(g_f + wp * A dxi) / h_ff
            gf0 = wp * r0 + wf * rf0
            gf1 = wp * r1 + wf * rf1
            Ad0 = sum(A0[k] * dxi[k] for k in range(6) if not isinstance(A0[k], float))
            Ad1 = sum(A1[k] * dxi[k] for k in range(6) if not isinstance(A1[k], float))
            df0 = -(gf0 + wp * Ad0) * inv_h
            df1 = -(gf1 + wp * Ad1) * inv_h

            # predicted reduction over both blocks
            pred_pose = 0.0
            for i in range(6):
                pred_pose = pred_pose + dxi[i] * (lam * dxi[i] - g[i])
            pred_flow = jnp.sum(
                jnp.where(
                    vmask > 0,
                    df0 * (lam * df0 - gf0) + df1 * (lam * df1 - gf1),
                    0.0,
                )
            )
            pred = 0.5 * (pred_pose + pred_flow)

            # ---- trial step ----
            dR, dt = _exp_se3_scalar(dxi)
            Rn, tn = _compose(dR, dt, R, t)
            f0n = f0 + df0
            f1n = f1 + df1
            F_new = objective(Rn, tn, f0n, f1n)
            gain = (F - F_new) / jnp.maximum(pred, 1e-20)
            accept = (F_new < F) & jnp.isfinite(F_new)
            lam_acc = lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
            done_n = done | (accept & (F - F_new < p.rel_tol * F + 1e-10)) | (lam > 1e8)

            out = [it + 1]
            for i in range(3):
                for j in range(3):
                    out.append(jnp.where(accept, Rn[i][j], R[i][j]))
            for i in range(3):
                out.append(jnp.where(accept, tn[i], t[i]))
            out.append(jnp.where(accept, f0n, f0))
            out.append(jnp.where(accept, f1n, f1))
            out.append(jnp.where(accept, F_new, F))
            out.append(jnp.where(accept, lam_acc, lam * nu))
            out.append(jnp.where(accept, 2.0, nu * 2.0))
            out.append(done_n)
            return tuple(out)

        def cond(state):
            return (state[0] < p.iters) & jnp.logical_not(state[-1])

        init = (
            jnp.int32(0),
            T0[0][0], T0[0][1], T0[0][2],
            T0[1][0], T0[1][1], T0[1][2],
            T0[2][0], T0[2][1], T0[2][2],
            t0[0], t0[1], t0[2],
            fm0, fm1,
            F0, lam0, jnp.float32(2.0), jnp.bool_(False),
        )
        fin = jax.lax.while_loop(cond, body, init)
        (it_f, R00, R01, R02, R10, R11, R12, R20, R21, R22,
         tx, ty, tz, f0, f1, F_f, _lam, _nu, _done) = fin
        Rf = [[R00, R01, R02], [R10, R11, R12], [R20, R21, R22]]
        tf = [tx, ty, tz]

        # ---- final chi2 / inliers / mean reproj (unweighted, as the gate) ----
        r0, r1, _ = residual(Rf, tf, f0, f1)
        chi2p = wp0 * (r0 * r0 + r1 * r1)
        inl = (val_ref[...] > 0) & (chi2p <= d2)
        n_in = jnp.sum(jnp.where(inl, 1.0, 0.0))
        mean_rp = jnp.sum(jnp.where(inl, jnp.sqrt(chi2p), 0.0)) / jnp.maximum(n_in, 1.0)

        f0_ref[...] = f0
        f1_ref[...] = f1
        chi2_ref[...] = chi2p

        pairs = []
        for i in range(3):
            for j in range(3):
                pairs.append((4 * i + j, Rf[i][j]))
            pairs.append((4 * i + 3, tf[i]))
        pairs += [(15, 1.0), (16, n_in), (17, mean_rp), (18, F_f),
                  (19, it_f.astype(jnp.float32))]
        row = jnp.zeros((_OUT_LEN,), jnp.float32)
        for idx, val in pairs:
            row = jnp.where(lane == idx, val, row)
        out_ref[...] = row

    return kernel


@functools.partial(
    jax.jit, static_argnames=("fx", "fy", "cx", "cy", "params", "interpret")
)
def solve_flow_ba_pallas(
    T_init: jnp.ndarray,
    Twl: jnp.ndarray,
    obs: jnp.ndarray,
    flow_meas: jnp.ndarray,
    depth: jnp.ndarray,
    valid: jnp.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    params: FlowBAParams = FlowBAParams(),
    interpret: bool = False,
    point_weight=None,
) -> FlowBAResult:
    """Drop-in kernel replacement for ``flow_ba.solve_flow_ba``.

    Any point count N is accepted: the block is padded to the next power
    of two with invalid points (unit depth, zero weight).
    """
    p = params
    f32 = jnp.float32
    N = obs.shape[0]
    Np = padded_size(N)
    pad = Np - N

    valid = valid & (depth > 0)
    if point_weight is None:
        wpt = jnp.ones((N,), f32)
    else:
        wpt = jnp.broadcast_to(jnp.asarray(point_weight, f32), (N,))

    def padded(x, fill):
        return jnp.pad(x.astype(f32), [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                       constant_values=fill)

    obs_p = padded(obs, 0.0)
    depth_p = padded(depth, 1.0)
    Xw = se3.transform(Twl, camera.backproject(obs_p, depth_p, fx, fy, cx, cy))
    fm_p = padded(flow_meas, 0.0)
    planes = (
        Xw[:, 0].astype(f32), Xw[:, 1].astype(f32), Xw[:, 2].astype(f32),
        obs_p[:, 0], obs_p[:, 1], fm_p[:, 0], fm_p[:, 1],
        padded(valid, 0.0), padded(wpt, 0.0),
    )
    tin = jnp.zeros((_OUT_LEN,), f32).at[:16].set(T_init.reshape(16).astype(f32))

    kern = _make_kernel(p, float(fx), float(fy), float(cx), float(cy))
    out, f0, f1, chi2 = pl.pallas_call(
        kern,
        out_shape=(
            jax.ShapeDtypeStruct((_OUT_LEN,), f32),
            jax.ShapeDtypeStruct((Np,), f32),
            jax.ShapeDtypeStruct((Np,), f32),
            jax.ShapeDtypeStruct((Np,), f32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps_for(Np),
                                           num_stages=1),
        interpret=interpret,
        name="flow_ba_lm",
        cost_estimate=pl.CostEstimate(
            flops=p.iters * Np * 300,
            bytes_accessed=p.iters * Np * 9 * 4 * 2,
            transcendentals=p.iters * Np * 2,
        ),
    )(tin, *planes)

    T = out[:16].reshape(4, 4)
    f = jnp.stack([f0[:N], f1[:N]], axis=-1)
    chi2 = chi2[:N]
    inliers = valid & (chi2 <= p.rp_thres)
    return FlowBAResult(
        T=T,
        flow=f,
        chi2=chi2,
        inliers=inliers,
        n_inliers=out[16].astype(jnp.int32),
        mean_reproj=out[17],
    )
