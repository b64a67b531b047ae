"""Parity: the fused flow-BA LM kernel vs the XLA reference solve.

The kernel runs in Pallas interpret mode here (the test mesh is CPU); on
the GPU it compiles through Triton, and chip_smoke.py compares it with the
XLA solve at the tracker's real widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimot_track_tpu.geometry import se3, camera
from multimot_track_tpu.solvers.flow_ba import FlowBAParams, solve_flow_ba
from multimot_track_tpu.solvers.flow_ba_pallas import (
    num_warps_for, padded_size, solve_flow_ba_pallas)

FX, FY, CX, CY = 721.5377, 721.5377, 609.5593, 172.854


def _make_problem(seed, N=256, n_valid=200, outlier_frac=0.1):
    rng = np.random.default_rng(seed)
    uv = np.stack(
        [rng.uniform(50, 1150, N), rng.uniform(50, 330, N)], axis=-1
    ).astype(np.float32)
    depth = rng.uniform(4.0, 30.0, N).astype(np.float32)
    valid = np.arange(N) < n_valid

    xi = np.array([0.004, -0.01, 0.002, 0.3, -0.05, 1.1], np.float32)
    T_true = np.asarray(se3.exp_se3(jnp.asarray(xi)))
    Xw = np.asarray(camera.backproject(jnp.asarray(uv), jnp.asarray(depth), FX, FY, CX, CY))
    y = (T_true[:3, :3] @ Xw.T).T + T_true[:3, 3]
    uv_cur = np.asarray(camera.project(jnp.asarray(y), FX, FY, CX, CY))
    flow = (uv_cur - uv + rng.normal(0, 0.05, (N, 2))).astype(np.float32)
    n_out = int(outlier_frac * n_valid)
    flow[:n_out] += rng.normal(0, 20.0, (n_out, 2))
    return uv, flow, depth, valid, T_true


@pytest.mark.parametrize("seed", [0, 3])
def test_pallas_matches_xla(seed):
    uv, flow, depth, valid, T_true = _make_problem(seed)
    p = FlowBAParams(iters=40)
    Twl = jnp.eye(4)
    T0 = jnp.eye(4)
    args = (T0, Twl, jnp.asarray(uv), jnp.asarray(flow), jnp.asarray(depth),
            jnp.asarray(valid), FX, FY, CX, CY)
    ref = solve_flow_ba(*args, params=p)
    out = solve_flow_ba_pallas(*args, params=p, interpret=True)

    # both must recover the true pose
    err_ref = np.linalg.norm(np.asarray(ref.T)[:3, 3] - T_true[:3, 3])
    err_pal = np.linalg.norm(np.asarray(out.T)[:3, 3] - T_true[:3, 3])
    assert err_ref < 5e-3
    assert err_pal < 5e-3
    # and agree with each other to float32 reduction tolerance
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(ref.T), atol=2e-4)
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 2
    np.testing.assert_allclose(
        float(out.mean_reproj), float(ref.mean_reproj), rtol=0.05, atol=1e-4
    )


def test_pallas_vmapped():
    """Batched solves (the object path vmaps over slots/streams)."""
    problems = [_make_problem(s, N=128, n_valid=100) for s in (1, 2, 7)]
    T0 = jnp.stack([jnp.eye(4)] * 3)
    uv = jnp.stack([jnp.asarray(p[0]) for p in problems])
    flow = jnp.stack([jnp.asarray(p[1]) for p in problems])
    depth = jnp.stack([jnp.asarray(p[2]) for p in problems])
    valid = jnp.stack([jnp.asarray(p[3]) for p in problems])
    p = FlowBAParams(iters=30)
    Twl = jnp.eye(4)

    solve = jax.vmap(
        lambda t0, u, f, d, v: solve_flow_ba_pallas(
            t0, Twl, u, f, d, v, FX, FY, CX, CY, params=p, interpret=True
        )
    )
    out = solve(T0, uv, flow, depth, valid)
    for k, (_, _, _, _, T_true) in enumerate(problems):
        err = np.linalg.norm(np.asarray(out.T[k])[:3, 3] - T_true[:3, 3])
        assert err < 1e-2, (k, err)


def test_pallas_pads_non_power_of_two():
    """N=200 pads to a 256-point block with invalid points; the padded
    points change nothing (same pose, flow and chi2 as the XLA solve)."""
    uv, flow, depth, valid, T_true = _make_problem(4, N=200, n_valid=160)
    p = FlowBAParams(iters=30)
    args = (jnp.eye(4), jnp.eye(4), jnp.asarray(uv), jnp.asarray(flow),
            jnp.asarray(depth), jnp.asarray(valid), FX, FY, CX, CY)
    ref = solve_flow_ba(*args, params=p)
    out = solve_flow_ba_pallas(*args, params=p, interpret=True)
    assert padded_size(200) == 256
    assert out.flow.shape == (200, 2) and out.chi2.shape == (200,)
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(ref.T), atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.flow), np.asarray(ref.flow), atol=2e-3)
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 2


@pytest.mark.parametrize("n,warps", [(100, 1), (2048, 8), (4096, 16), (5000, 16)])
def test_block_size_and_warps(n, warps):
    """Power-of-two blocks; 8 points per thread up to 16 warps."""
    n_pad = padded_size(n)
    assert n_pad >= n and n_pad & (n_pad - 1) == 0 and n_pad < 2 * max(n, 16)
    assert num_warps_for(n_pad) == warps


def test_kernel_lowers_for_gpu():
    """The Triton route lowers (no card needed: the pallas_call is lowered
    to Triton IR for the cuda platform, under a nested vmap as in the
    object ensemble)."""
    p = FlowBAParams(iters=5)
    solve = jax.vmap(jax.vmap(
        lambda t0, u, f, d, v: solve_flow_ba_pallas(
            t0, jnp.eye(4), u, f, d, v, FX, FY, CX, CY, params=p)
    ))
    S, K, N = 3, 2, 384
    args = (jnp.zeros((S, K, 4, 4)), jnp.zeros((S, K, N, 2)),
            jnp.zeros((S, K, N, 2)), jnp.ones((S, K, N)),
            jnp.ones((S, K, N), bool))
    text = jax.jit(solve).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "flow_ba_lm" in text


def test_dispatch_takes_kernel_for_cuda_only():
    """solve_flow_ba_auto lowers to the kernel for CUDA and nothing else;
    every other platform gets the XLA solve (same result here)."""
    from multimot_track_tpu.solvers.flow_ba import solve_flow_ba_auto

    uv, flow, depth, valid, T_true = _make_problem(5, N=128, n_valid=128,
                                                   outlier_frac=0.0)
    args = (jnp.eye(4), jnp.eye(4), jnp.asarray(uv), jnp.asarray(flow),
            jnp.asarray(depth), jnp.asarray(valid))
    w = jnp.asarray(1.0 / (1.0 + (depth / 15.0) ** 2))

    def auto(*a):
        return solve_flow_ba_auto(*a, FX, FY, CX, CY,
                                  params=FlowBAParams(iters=20), point_weight=w)

    traced = jax.jit(auto).trace(*args)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "flow_ba_lm" in cuda and "stablehlo.while" not in cuda
    assert "flow_ba_lm" not in cpu and "stablehlo.while" in cpu
    out = jax.jit(auto)(*args)
    ref = solve_flow_ba(*args, FX, FY, CX, CY, params=FlowBAParams(iters=20),
                        point_weight=w)
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(ref.T), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.T), T_true, atol=1e-2)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu_device):
    """The Triton-compiled kernel against the XLA solve, on the card."""
    import chip_smoke

    with jax.default_device(gpu_device):
        chip_smoke.compare_flow_ba(
            chip_smoke.Report(), "objects 2x3 N=512", (2, 3), 512,
            FlowBAParams(prior_info=0.5, rp_thres=0.01), weighted=False, seed=9)
