"""ORB descriptor + matcher tests (SURVEY.md §7 step 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimot_track_tpu.frontend import fast, orb
from multimot_track_tpu.ops import matching

RNG = np.random.default_rng(11)


def textured_image(H=240, W=320, n_blobs=60):
    img = np.zeros((H, W), np.float32)
    ys = RNG.integers(20, H - 20, n_blobs)
    xs = RNG.integers(20, W - 20, n_blobs)
    for y, x in zip(ys, xs):
        h, w = RNG.integers(6, 16, 2)
        img[y : y + h, x : x + w] += RNG.uniform(60, 200)
    return np.clip(img, 0, 255)


def test_descriptor_shapes_and_range():
    img = jnp.asarray(textured_image())
    kp = fast.detect_pyramid(img, n_levels=1, n_total=128, cell=16, per_cell=2)
    desc, ang = orb.describe(img, kp.uv)
    assert desc.shape == (128, 256) and desc.dtype == jnp.int8
    assert set(np.unique(np.asarray(desc))) <= {-1, 1}
    assert np.all(np.isfinite(np.asarray(ang)))


def test_hamming_matrix_matches_popcount():
    a = jnp.asarray(RNG.choice([-1, 1], size=(32, 256)).astype(np.int8))
    b = jnp.asarray(RNG.choice([-1, 1], size=(48, 256)).astype(np.int8))
    D = np.asarray(matching.hamming_matrix(a, b))
    ref = ((np.asarray(a)[:, None, :] != np.asarray(b)[None, :, :]).sum(-1)).astype(np.float32)
    np.testing.assert_array_equal(D, ref)


def test_self_matching_under_shift():
    """Descriptors of the same physical points in a shifted image must match."""
    base = textured_image()
    img0 = jnp.asarray(base)
    shift = 3
    img1 = jnp.asarray(np.roll(base, shift, axis=1))
    kp0 = fast.detect_pyramid(img0, n_levels=1, n_total=256, cell=16, per_cell=2)
    uv1 = kp0.uv + jnp.asarray([shift, 0.0])
    ok1 = (
        kp0.valid
        & (uv1[:, 0] < img0.shape[1] - 20)
        & (uv1[:, 0] > 20)
    )
    d0, a0 = orb.describe(img0, kp0.uv)
    d1, a1 = orb.describe(img1, uv1)
    res = matching.match_descriptors(d0, d1, kp0.valid & ok1, kp0.valid & ok1)
    v = np.asarray(res.valid)
    n_valid = int(np.asarray(kp0.valid & ok1).sum())
    assert v.sum() > 0.8 * n_valid
    # matched index must be the identity (same row)
    idx = np.asarray(res.idx)
    assert (idx[v] == np.arange(len(idx))[v]).mean() > 0.95


def test_match_projected_radius_gate():
    a = jnp.asarray(RNG.choice([-1, 1], size=(16, 256)).astype(np.int8))
    uv = jnp.asarray(RNG.uniform(0, 100, (16, 2)).astype(np.float32))
    valid = jnp.ones(16, bool)
    # B = same descriptors but positions pushed outside the radius for half
    uv_b = np.array(uv)
    uv_b[8:] += 100.0
    res = matching.match_projected(a, uv, valid, a, jnp.asarray(uv_b), valid, radius=10.0)
    v = np.asarray(res.valid)
    assert v[:8].all()
    assert not v[8:].any()


def test_rotation_consistency():
    idx = jnp.arange(64, dtype=jnp.int32)
    valid = jnp.ones(64, bool)
    ang_a = jnp.zeros(64)
    ang_b = np.zeros(64, np.float32)
    # 4 inconsistent matches: 4 < 0.1 * 60, so their bin is dropped by the
    # reference's ComputeThreeMaxima 10%-of-max rule
    ang_b[:4] = 2.0
    keep = matching.rotation_consistency(ang_a, jnp.asarray(ang_b), idx, valid)
    k = np.asarray(keep)
    assert k[4:].all() and not k[:4].any()


def _popcount_top2(desc_a, uv_a, va, desc_b, uv_b, vb, radius):
    """Plain reference: packed-bit XOR popcount distances, spatial and
    validity gates, then best / second-best / argmin per query row."""
    bits_a = np.packbits(np.asarray(desc_a) > 0, axis=1)
    bits_b = np.packbits(np.asarray(desc_b) > 0, axis=1)
    x = np.bitwise_xor(bits_a[:, None, :], bits_b[None, :, :])
    D = np.unpackbits(x, axis=2).sum(axis=2).astype(np.float32)
    d2 = ((np.asarray(uv_a)[:, None, :] - np.asarray(uv_b)[None, :, :]) ** 2).sum(-1)
    ok = np.asarray(va)[:, None] & np.asarray(vb)[None, :] & (d2 <= radius * radius)
    D = np.where(ok, D, np.float32(1e9))
    order = np.sort(D, axis=1)
    return D, order[:, 0], order[:, 1]


@pytest.mark.parametrize("N,M", [(96, 160), (512, 384)])
def test_match_projected_matches_popcount_reference(N, M):
    rng = np.random.default_rng(N + M)
    a = rng.choice([-1, 1], size=(N, 256)).astype(np.int8)
    b = rng.choice([-1, 1], size=(M, 256)).astype(np.int8)
    # plant near-duplicates so some rows pass the TH_HIGH / ratio gates
    b[: N // 2] = a[: N // 2] * np.where(rng.random((N // 2, 256)) < 0.05, -1, 1)
    uv_a = rng.uniform(0, 120, (N, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 120, (M, 2)).astype(np.float32)
    uv_b[: N // 2] = uv_a[: N // 2] + 1.0
    va = rng.random(N) < 0.9
    vb = rng.random(M) < 0.9
    radius = 25.0

    out = matching.match_projected(
        jnp.asarray(a), jnp.asarray(uv_a), jnp.asarray(va), jnp.asarray(b),
        jnp.asarray(uv_b), jnp.asarray(vb), radius=radius,
    )
    D, best, second = _popcount_top2(a, uv_a, va, b, uv_b, vb, radius)
    np.testing.assert_array_equal(np.asarray(out.dist), best)
    # random descriptors tie often: the index must be *a* minimiser
    picked = D[np.arange(N), np.asarray(out.idx)]
    np.testing.assert_array_equal(picked, best)
    ok = va & (best <= matching.TH_HIGH) & (best < 0.9 * second)
    np.testing.assert_array_equal(np.asarray(out.valid), ok)
    assert ok.sum() >= N // 4
