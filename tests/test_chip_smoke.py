"""chip_smoke.py's phases at a tiny size on the CPU.

The script itself refuses to run without a GPU; its phase functions take a
config and frames, so the streaming and live checks it applies on the card
run here on a quarter-resolution junction scene with a cut-down config."""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from multimot_track_tpu.config import DEFAULT_CONFIG, CameraConfig

CAM = dict(fx=180.0, fy=180.0, cx=160.0, cy=48.0, bf=97.0, width=320,
           height=96, fps=10.0)
_C = DEFAULT_CONFIG
TINY = dataclasses.replace(
    _C,
    camera=CameraConfig(**CAM),
    frontend=dataclasses.replace(_C.frontend, n_features=256, n_levels=3,
                                 grid_cols=16, grid_rows=8),
    padding=dataclasses.replace(_C.padding, n_static_max=256, n_obj_pts_max=512,
                                k_obj_max=4, k_obj_solve=2, n_per_obj_max=128),
    solver=dataclasses.replace(_C.solver, ransac_iters=32, obj_ransac_iters=32,
                               cam_lm_iters=10, obj_lm_iters=10,
                               refine_gn_iters=2, obj_ensemble_seeds=2,
                               obj_ransac_score_pts=64, obj_consensus_pts=64),
    backend=dataclasses.replace(_C.backend, n_window_tracks=256,
                                joint_static_max=128, kf_capacity=8,
                                window_ba_iters=5, joint_iters=3,
                                global_ba_iters=3),
)


@pytest.fixture(scope="module")
def frames():
    return chip_smoke.make_frames(6, cam=dict(CAM))


@pytest.fixture(scope="module")
def report():
    return chip_smoke.Report()


def test_device_guard_refuses_cpu(report, capsys):
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.phase_device(report)
    assert "ok" not in capsys.readouterr().out


def test_streaming_phase_tiny(report, frames):
    rpe = chip_smoke.phase_streaming(report, TINY, frames, chunk=4)
    assert 0.0 <= rpe < chip_smoke.RPE_GATE


def test_live_phase_tiny(report, frames):
    rpe = chip_smoke.phase_live(report, TINY, frames, min_keyframes=1)
    assert 0.0 <= rpe < chip_smoke.RPE_GATE


def test_popcount_reference_is_hamming():
    """The numpy reference the card's matcher is held to: byte-LUT XOR
    popcount equals the sign-form Hamming distance."""
    rng = np.random.default_rng(0)
    a = rng.choice([-1, 1], size=(40, 256)).astype(np.int8)
    b = rng.choice([-1, 1], size=(24, 256)).astype(np.int8)
    uv = np.zeros((40, 2), np.float32)
    D, best, second = chip_smoke.popcount_top2(
        a, uv, np.ones(40, bool), b, np.zeros((24, 2), np.float32),
        np.ones(24, bool), radius=1.0, rows=16)
    ref = (a[:, None, :] != b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(D, ref)
    srt = np.sort(ref, axis=1)
    np.testing.assert_array_equal(best, srt[:, 0])
    np.testing.assert_array_equal(second, srt[:, 1])


def test_multi_phase_tiny(report, frames):
    """The four-device phase on four of the virtual CPU devices: the
    pair-sharded tracker and the point-sharded flow-BA against one
    device."""
    chip_smoke.phase_multi(report, TINY, frames, n_dev=4, n_pairs=4)
