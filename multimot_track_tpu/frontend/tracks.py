"""Multi-frame point tracks chained through dense optical flow.

The reference's active path only ever relates frame k-1 to k (window of 2,
SURVEY.md §5); longer temporal structure lives in its keyframe/map-point
machinery.  The batched analog: chain the *dense* flow fields to carry a
window's worth of observations per point — a `lax.scan` over stacked flow
tensors — feeding the windowed BA (solvers/window_ba.py), which plays the
role of LocalMapping's local bundle adjustment (src/LocalMapping.cc +
src/Optimizer.cc:3341).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera


class Tracks(NamedTuple):
    uv: jnp.ndarray      # (F, N, 2) per-frame positions (frame 0 = keypoints)
    alive: jnp.ndarray   # (F, N) observation validity (monotone decreasing)


def chain_tracks(
    start_uv: jnp.ndarray,      # (N, 2) keypoints in frame 0
    start_valid: jnp.ndarray,   # (N,)
    flows: jnp.ndarray,         # (F-1, H, W, 2) flow fields k -> k+1
    sem_masks: jnp.ndarray,     # (F, H, W) instance masks (0 = static)
    margin: float = 2.0,
) -> Tracks:
    """Propagate keypoints through the flow chain; a track dies when it
    leaves the image or lands on a (dynamic-candidate) instance mask."""
    F = flows.shape[0] + 1
    H, W = flows.shape[1], flows.shape[2]

    def step(carry, inp):
        pos, alive = carry
        flow_f, mask_next = inp
        fl = camera.bilinear_sample(flow_f, pos)
        nxt = pos + fl
        inb = (
            (nxt[:, 0] >= margin)
            & (nxt[:, 0] < W - margin)
            & (nxt[:, 1] >= margin)
            & (nxt[:, 1] < H - margin)
        )
        lab, _ = camera.nearest_sample(mask_next, nxt)
        alive_n = alive & inb & (lab == 0)
        return (nxt, alive_n), (nxt, alive_n)

    (_, _), (uvs, alives) = jax.lax.scan(
        step, (start_uv, start_valid), (flows, sem_masks[1:])
    )
    uv = jnp.concatenate([start_uv[None], uvs], axis=0)
    alive = jnp.concatenate([start_valid[None], alives], axis=0)
    return Tracks(uv=uv, alive=alive)


def build_window_tracks(
    grays,            # list/stack of F (H, W) gray images
    flows,            # (F-1, H, W, 2) dense flow (prediction prior)
    depth0,           # (H, W) metric depth of frame 0
    sem_masks,        # (F, H, W) instance masks
    n_kp: int = 3072,
    radius: float = 15.0,
    max_depth: float = 40.0,
):
    """Detection-linked static tracks over a window, tuned for survival.

    Repeatability notes (measured on kitti_sample): rotation-consistency
    and tight ratio tests are counterproductive for forward vehicle motion
    — with n_kp=3072, radius 15 and no ratio gate, ~16% of frame-0
    keypoints survive 4 links (vs ~1% with the conservative settings),
    which is what the windowed BA needs.

    Returns (Tracks, depth0_per_track (N,)).
    """
    import jax.numpy as jnp

    from multimot_track_tpu.frontend import fast, orb
    from multimot_track_tpu.geometry import camera
    from multimot_track_tpu.ops import matching

    kps, descs = [], []
    for f in range(len(grays)):
        g = jnp.asarray(grays[f])
        kp = fast.detect_pyramid(g, n_levels=4, n_total=n_kp)
        d, _ = orb.describe(g, kp.uv)
        lab, _ = camera.nearest_sample(jnp.asarray(sem_masks[f]), kp.uv)
        kps.append((kp.uv, kp.valid & (lab == 0)))
        descs.append(d)
    z0, _ = camera.nearest_sample(jnp.asarray(depth0), kps[0][0])
    v0 = kps[0][1] & (z0 > 0) & (z0 < max_depth)
    kp_uv = jnp.stack([k[0] for k in kps])
    kp_valid = jnp.stack([k[1] for k in kps]).at[0].set(v0)
    midx, mok = [], []
    for f in range(len(grays) - 1):
        fl = camera.bilinear_sample(jnp.asarray(flows[f]), kps[f][0])
        r = matching.match_projected(
            descs[f], kps[f][0] + fl, kp_valid[f],
            descs[f + 1], kps[f + 1][0], kp_valid[f + 1],
            radius=radius, ratio=1.0,
        )
        midx.append(r.idx)
        mok.append(r.valid)
    tr = link_detections(kp_uv, kp_valid, jnp.stack(midx), jnp.stack(mok))
    return tr, z0


def link_detections(
    kp_uv: jnp.ndarray,       # (F, N, 2) per-frame detected keypoints
    kp_valid: jnp.ndarray,    # (F, N)
    match_idx: jnp.ndarray,   # (F-1, N) match of frame-f kp -> frame-(f+1) kp
    match_ok: jnp.ndarray,    # (F-1, N) match validity
) -> Tracks:
    """Chain per-frame *detected* keypoints through descriptor matches.

    Unlike ``chain_tracks`` the observations are re-detected every frame, so
    track positions carry no accumulated flow drift — this is the analog of
    the reference's map-point tracks (MapPoint observations across
    keyframes) and the preferred input to the windowed BA.  Track i follows
    frame-0 keypoint i; its frame-f position is the matched detection.
    """
    F = kp_uv.shape[0]

    def step(carry, inp):
        cur, alive = carry
        idx_f, ok_f, uv_next, val_next = inp
        nxt = idx_f[cur]
        alive_n = alive & ok_f[cur] & val_next[nxt]
        pos = uv_next[nxt]
        return (nxt, alive_n), (pos, alive_n)

    init = (jnp.arange(kp_uv.shape[1], dtype=jnp.int32), kp_valid[0])
    (_, _), (uvs, alives) = jax.lax.scan(
        step, init, (match_idx, match_ok, kp_uv[1:], kp_valid[1:])
    )
    uv = jnp.concatenate([kp_uv[:1], uvs], axis=0)
    alive = jnp.concatenate([kp_valid[:1], alives], axis=0)
    return Tracks(uv=uv, alive=alive)


def chain_tracks_zncc(
    start_uv: jnp.ndarray,      # (N, 2) keypoints in frame 0
    start_valid: jnp.ndarray,   # (N,)
    flows: jnp.ndarray,         # (F-1, H, W, 2) flow fields k -> k+1
    grays: jnp.ndarray,         # (F, H, W) float gray frames
    sem_masks: jnp.ndarray,     # (F, H, W) instance masks (0 = static)
    patch_radius: int = 2,
    zncc_min: float = 0.7,
    search_radius: int = 2,
    margin: float = 3.0,
) -> Tracks:
    """Flow-chained tracks with per-link KLT re-centering.

    ``chain_tracks`` accumulates dense-flow drift until the photometric
    gate kills the track; here each hop predicts through the flow, then
    locks onto the local ZNCC optimum (ops/photometric.refine_position,
    subpixel) of the PREVIOUS frame's patch at the track's last position —
    the classic template-update KLT.  A frame-0 template would avoid
    drift entirely but mis-registers ~2 px under the window's forward-
    motion scale change (measured); the per-link update keeps the scale
    delta negligible while the re-centering still more than doubles
    4-link survival on kitti_sample (20% -> ~45%)."""
    from multimot_track_tpu.ops import photometric

    H, W = grays.shape[1], grays.shape[2]
    p_init = photometric.extract_patches(grays[0], start_uv, patch_radius)

    def step(carry, inp):
        pos, patch_prev, alive = carry
        flow_f, mask_next, gray_next = inp
        fl = camera.bilinear_sample(flow_f, pos)
        pred = pos + fl
        ref, sc = photometric.refine_position(
            gray_next, pred, patch_prev, patch_radius, search_radius
        )
        inb = (
            (ref[:, 0] >= margin)
            & (ref[:, 0] < W - margin)
            & (ref[:, 1] >= margin)
            & (ref[:, 1] < H - margin)
        )
        lab, _ = camera.nearest_sample(mask_next, ref)
        alive_n = alive & inb & (lab == 0) & (sc > zncc_min)
        patch_new = photometric.extract_patches(gray_next, ref, patch_radius)
        return (ref, patch_new, alive_n), (ref, alive_n)

    (_, _, _), (uvs, alives) = jax.lax.scan(
        step, (start_uv, p_init, start_valid), (flows, sem_masks[1:], grays[1:])
    )
    uv = jnp.concatenate([start_uv[None], uvs], axis=0)
    alive = jnp.concatenate([start_valid[None], alives], axis=0)
    return Tracks(uv=uv, alive=alive)
