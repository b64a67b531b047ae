"""Smoke run of the tracker's main path on one NVIDIA GPU.

Drives the system once through the entry points a user calls, at the
default deployment (``DEFAULT_CONFIG``: KITTI camera 1242x375, 2048 static
and 8192 object points, 8 object slots, top-6 solve batch, 500/1000
RANSAC hypotheses, a keyframe store of 96) on a seeded synthetic junction
scene with 8 concurrent movers and exact ground truth:

  1. device    the platform must be "gpu"; card name and power limit
  2. kernels   the flow-BA LM kernel against the XLA solve (one camera
               solve at N=2048, a vmapped 6x3 object ensemble at N=4096)
               and the projected matcher against a numpy popcount top-2
  3. streaming pipeline/batch.run_sequence_streaming, chunk 8
  4. live      MultiMotSystem(pipelined=True): upload + track_rgbd + flush
  5. endpoint  io/stream.serve_connection on a socket pair

Every phase raises on failure; the last line of standard output is one
JSON object naming the device.  Informational lines (compile and steady
seconds, peak device memory) are labelled with the card and its power
limit; none of them is a benchmark result.

  python chip_smoke.py           # one card, all phases
  python chip_smoke.py --multi   # four cards: the pair-sharded tracker and
                                 # the point-sharded flow-BA against one card
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

import jax
import jax.numpy as jnp

from multimot_track_tpu.config import DEFAULT_CONFIG, PipelineConfig
from multimot_track_tpu.geometry import camera, se3
from multimot_track_tpu.solvers.flow_ba import FlowBAParams

N_FRAMES = 30
N_PAIRS_MULTI = 8
CHUNK = 8
RPE_GATE = 0.05          # mean ego t-RPE vs exact GT on a synthetic scene

# Flow-BA kernel vs XLA solve.  Both run float32 (the package sets
# jax_default_matmul_precision="float32", so no TF32 anywhere).  They sum
# the per-point terms in different orders (block tree reduction in the
# kernel, XLA's fused reductions in the reference), so the LM trajectories
# drift apart in the last bits and may stop one iteration apart at the
# rel_tol gate: poses agree to ATOL_POSE; a point sitting on the chi2 gate
# may flip, so inlier counts agree to +-INLIER_SLACK; the mean reprojection
# error over the inliers agrees to RTOL_REPROJ.
ATOL_POSE = 2e-4
INLIER_SLACK = 2
RTOL_REPROJ = 0.05


class Report:
    """Prints labelled informational lines and collects compile times."""

    def __init__(self):
        self.card = "unknown card"
        self.compile_s: dict = {}
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            name = kw.get("fun_name", "?")
            self.compile_s[name] = self.compile_s.get(name, 0.0) + duration

    def info(self, what: str, value):
        print(f"[{self.card}] {what}: {value}", flush=True)

    def take_compiles(self, phase: str):
        if self.compile_s:
            top = sorted(self.compile_s.items(), key=lambda kv: -kv[1])
            self.info(f"{phase} compile s (total {sum(self.compile_s.values()):.1f})",
                      ", ".join(f"{k}={v:.2f}" for k, v in top))
        self.compile_s = {}


def card_name_and_power() -> str:
    """``nvidia-smi`` in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out


def phase_device(rep: Report, count: int = 1) -> dict:
    """Refuse anything but a GPU; print what the run is measured on."""
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found platform {d.platform!r}"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX found {len(devs)}")
    smi = card_name_and_power()
    print(smi, flush=True)
    rep.card = smi.splitlines()[0]
    rep.info("device_kind", d.device_kind)
    rep.info("device count", len(devs))
    rep.info("jax", jax.__version__)
    rep.info("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    rep.info("compile cache", jax.config.jax_compilation_cache_dir)
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


# ---------------------------------------------------------------- kernels
def flow_ba_problem(seed: int, n: int, n_valid: int, outlier_frac=0.1):
    """Seeded flow-BA instance at the KITTI camera: ``n_valid`` of ``n``
    points valid, a known motion, 0.05 px flow noise, gross outliers."""
    cam = DEFAULT_CONFIG.camera
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(40, cam.width - 40, n),
                   rng.uniform(30, cam.height - 30, n)], -1).astype(np.float32)
    depth = rng.uniform(4.0, 30.0, n).astype(np.float32)
    valid = np.arange(n) < n_valid
    xi = (rng.normal(size=6) * [0.004, 0.004, 0.004, 0.05, 0.05, 0.3]).astype(np.float32)
    T_true = np.asarray(se3.exp_se3(jnp.asarray(xi)))
    X = np.asarray(camera.backproject(jnp.asarray(uv), jnp.asarray(depth),
                                      cam.fx, cam.fy, cam.cx, cam.cy))
    y = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv1 = np.asarray(camera.project(jnp.asarray(y), cam.fx, cam.fy, cam.cx, cam.cy))
    flow = (uv1 - uv + rng.normal(0, 0.05, (n, 2))).astype(np.float32)
    k = int(outlier_frac * n_valid)
    flow[:k] += rng.normal(0, 20.0, (k, 2)).astype(np.float32)
    return uv, flow, depth, valid, T_true


def _median_s(fn, reps: int = 10) -> float:
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def compare_flow_ba(rep: Report, label: str, batch: tuple, n: int,
                    params: FlowBAParams, weighted: bool, seed: int):
    """Kernel vs XLA solve on ``prod(batch)`` instances of ``n`` points."""
    from multimot_track_tpu.solvers.flow_ba import solve_flow_ba
    from multimot_track_tpu.solvers.flow_ba_pallas import solve_flow_ba_pallas

    cam = DEFAULT_CONFIG.camera
    n_inst = int(np.prod(batch)) if batch else 1
    probs = [flow_ba_problem(seed + i, n, n_valid=n - (i * 97) % (n // 2))
             for i in range(n_inst)]

    def stack(j, dtype):
        a = np.stack([p[j] for p in probs]).astype(dtype)
        return jnp.asarray(a.reshape(tuple(batch) + a.shape[1:]))

    uv, flow, depth = stack(0, np.float32), stack(1, np.float32), stack(2, np.float32)
    valid = stack(3, bool)
    T0 = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), tuple(batch) + (4, 4))
    w = 1.0 / (1.0 + (depth / 15.0) ** 2) if weighted else None

    def solver(fn):
        def one(t0, u, f, d, v, wt):
            return fn(t0, jnp.eye(4, dtype=jnp.float32), u, f, d, v,
                      cam.fx, cam.fy, cam.cx, cam.cy, params=params,
                      point_weight=wt)
        for _ in batch:
            one = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0 if weighted else None))
        return jax.jit(one)

    kern, xla = solver(solve_flow_ba_pallas), solver(solve_flow_ba)
    args = (T0, uv, flow, depth, valid, w)
    out, ref = kern(*args), xla(*args)
    jax.block_until_ready((out, ref))
    dT = float(jnp.max(jnp.abs(out.T - ref.T)))
    dn = int(jnp.max(jnp.abs(out.n_inliers - ref.n_inliers)))
    mr, mx = np.asarray(out.mean_reproj), np.asarray(ref.mean_reproj)
    ok_rp = np.all(np.abs(mr - mx) <= RTOL_REPROJ * np.abs(mx) + 1e-4)
    T_true = np.stack([p[4] for p in probs]).reshape(tuple(batch) + (4, 4))
    dtrue = float(np.max(np.abs(np.asarray(out.T)[..., :3, 3] - T_true[..., :3, 3])))
    print(f"flow-BA {label}: max|dT| {dT:.2e} (atol {ATOL_POSE}), "
          f"max|d inliers| {dn} (<= {INLIER_SLACK}), mean reproj rel diff "
          f"{float(np.max(np.abs(mr - mx) / np.maximum(np.abs(mx), 1e-9))):.2e} "
          f"(rtol {RTOL_REPROJ}), max|t - t_true| {dtrue:.2e}", flush=True)
    if not (np.isfinite(np.asarray(out.T)).all() and dT <= ATOL_POSE
            and dn <= INLIER_SLACK and ok_rp):
        raise AssertionError(f"flow-BA kernel disagrees with XLA ({label})")
    t_k = _median_s(lambda: kern(*args))
    t_x = _median_s(lambda: xla(*args))
    rep.info(f"flow-BA {label} median s kernel / xla", f"{t_k:.6f} / {t_x:.6f}")


def popcount_top2(a, uv_a, va, b, uv_b, vb, radius, rows=256):
    """numpy reference of the projected matcher: XOR popcount distances
    through a byte lookup table, gates, best / second / argmin."""
    lut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
    pa, pb = np.packbits(a > 0, axis=1), np.packbits(b > 0, axis=1)
    best = np.empty(len(a), np.float32)
    second = np.empty(len(a), np.float32)
    D_rows = []
    for r0 in range(0, len(a), rows):
        D = lut[np.bitwise_xor(pa[r0:r0 + rows, None, :], pb[None])].sum(-1)
        d2 = ((uv_a[r0:r0 + rows, None] - uv_b[None]) ** 2).sum(-1)
        ok = va[r0:r0 + rows, None] & vb[None] & (d2 <= radius * radius)
        D = np.where(ok, D.astype(np.float32), np.float32(1e9))
        part = np.partition(D, 1, axis=1)
        best[r0:r0 + rows], second[r0:r0 + rows] = part[:, 0], part[:, 1]
        D_rows.append(D)
    return np.concatenate(D_rows), best, second


def compare_matcher(rep: Report, n: int, m: int, seed: int = 0, radius=15.0):
    from multimot_track_tpu.ops import matching

    cam = DEFAULT_CONFIG.camera
    rng = np.random.default_rng(seed)
    a = rng.choice([-1, 1], size=(n, 256)).astype(np.int8)
    b = rng.choice([-1, 1], size=(m, 256)).astype(np.int8)
    k = min(n, m) // 2
    b[:k] = a[:k] * np.where(rng.random((k, 256)) < 0.05, -1, 1)
    uv_a = np.stack([rng.uniform(0, cam.width, n),
                     rng.uniform(0, cam.height, n)], -1).astype(np.float32)
    uv_b = np.stack([rng.uniform(0, cam.width, m),
                     rng.uniform(0, cam.height, m)], -1).astype(np.float32)
    uv_b[:k] = uv_a[:k] + 2.0
    va, vb = rng.random(n) < 0.95, rng.random(m) < 0.95
    dev = [jnp.asarray(x) for x in (a, uv_a, va, b, uv_b, vb)]

    def run():
        return matching.match_projected(*dev, radius=radius)

    out = run()
    D, best, second = popcount_top2(a, uv_a, va, b, uv_b, vb, radius)
    dist, idx = np.asarray(out.dist), np.asarray(out.idx)
    ok = va & (best <= matching.TH_HIGH) & (best < 0.9 * second)
    good = (np.array_equal(dist, best)
            and np.array_equal(D[np.arange(n), idx], best)
            and np.array_equal(np.asarray(out.valid), ok))
    print(f"matcher {n}x{m}x256 bits: best/idx/valid exact vs popcount: {good} "
          f"({int(ok.sum())} matches)", flush=True)
    if not good:
        raise AssertionError(f"match_projected disagrees with popcount ({n}x{m})")
    rep.info(f"match_projected {n}x{m} median s", f"{_median_s(run):.6f}")


def phase_kernels(rep: Report, cfg: PipelineConfig = DEFAULT_CONFIG):
    sol, pad = cfg.solver, cfg.padding
    cam_p = FlowBAParams(reproj_info=sol.reproj_info, prior_info=sol.cam_flow_prior_info,
                         rp_thres=sol.cam_rp_thres, iters=sol.cam_lm_iters, tau=sol.lm_tau)
    obj_p = FlowBAParams(reproj_info=sol.reproj_info, prior_info=sol.obj_flow_prior_info,
                         rp_thres=sol.obj_rp_thres, iters=sol.obj_lm_iters, tau=sol.lm_tau)
    compare_flow_ba(rep, f"camera N={pad.n_static_max}", (), pad.n_static_max,
                    cam_p, weighted=True, seed=100)
    compare_flow_ba(rep, f"objects {pad.k_obj_solve}x{sol.obj_ensemble_seeds} "
                    f"N={pad.n_per_obj_max}",
                    (pad.k_obj_solve, sol.obj_ensemble_seeds), pad.n_per_obj_max,
                    obj_p, weighted=False, seed=200)
    compare_matcher(rep, 4096, 4096)
    # the live path's shapes: local map (3 keyframes x 1024) and fuse scan
    compare_matcher(rep, 3072, 1024, seed=1, radius=12.0)
    compare_matcher(rep, 1024, 1024, seed=2, radius=6.0)
    rep.take_compiles("kernels")


# ---------------------------------------------------------------- tracking
def make_frames(n_frames: int = N_FRAMES, cam=None):
    from multimot_track_tpu.io import synth

    return synth.make_junction_frames(n_frames=n_frames, cam=cam)


def phase_streaming(rep: Report, cfg: PipelineConfig, frames, chunk=CHUNK,
                    rpe_gate=RPE_GATE):
    """Serving mode over the whole scene; returns mean ego t-RPE."""
    from multimot_track_tpu.pipeline import batch as B

    wires = [B.pack_frame_wire(fd, cfg) for fd in frames]
    t0 = time.perf_counter()
    B.run_sequence_streaming(frames, cfg, chunk=chunk, prepacked=wires)
    first = time.perf_counter() - t0
    rep.take_compiles("streaming")
    t0 = time.perf_counter()
    Tcw, res, _ = B.run_sequence_streaming(frames, cfg, chunk=chunk, prepacked=wires)
    steady = time.perf_counter() - t0
    rel = np.asarray(res.cam_t_rpe_rel)
    rpe = float(np.mean(rel))
    print(f"streaming: {len(frames)} frames, poses finite "
          f"{bool(np.isfinite(Tcw).all())}, mean ego t-RPE {rpe:.4f} "
          f"(< {rpe_gate})", flush=True)
    if not (np.isfinite(Tcw).all() and Tcw.shape == (len(frames), 4, 4)
            and np.isfinite(rel).all() and rpe < rpe_gate):
        raise AssertionError("streaming run failed its checks")
    rep.info("streaming first-call s", f"{first:.3f}")
    rep.info("streaming steady s/frame", f"{steady / len(frames):.6f}")
    return rpe


def _live_pass(cfg, frames):
    from multimot_track_tpu.pipeline.system import MultiMotSystem

    sys_ = MultiMotSystem(cfg, pipelined=True)
    times = []
    for fd in frames:
        h = sys_.upload(fd)
        t0 = time.perf_counter()
        sys_.track_rgbd(fd, uploaded=h)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    sys_.flush()
    times.append(time.perf_counter() - t0)
    return sys_, np.asarray(times[1:])       # frame 0 is the frontend only


def phase_live(rep: Report, cfg: PipelineConfig, frames, rpe_gate=RPE_GATE,
               min_keyframes=2):
    """Full-backend live mode; a second pass gives steady per-frame time."""
    t0 = time.perf_counter()
    _live_pass(cfg, frames)
    first = time.perf_counter() - t0
    rep.take_compiles("live")
    sys_, times = _live_pass(cfg, frames)
    s = sys_.summary()
    n_kf = len(sys_.keyframes.frames)
    poses = np.stack(sys_.map.camera_poses)
    rpe = s["cam_t_rpe_rel_mean"]
    print(f"live: {s['n_frames']} frames, {n_kf} keyframes (>= {min_keyframes}), "
          f"poses finite {bool(np.isfinite(poses).all())}, mean ego t-RPE "
          f"{rpe:.4f} (< {rpe_gate})", flush=True)
    if not (n_kf >= min_keyframes and np.isfinite(poses).all()
            and len(poses) == len(frames) and rpe < rpe_gate):
        raise AssertionError("live run failed its checks")
    rep.info("live first-pass s", f"{first:.3f}")
    rep.info("live steady median s/frame", f"{float(np.median(times)):.6f}")
    rep.info("live steady total s/frame", f"{float(times.sum()) / len(times):.6f}")
    return rpe


def phase_endpoint(rep: Report, cfg: PipelineConfig, frames, n=3):
    """The socket endpoint in a thread of this process: n frames in,
    n replies out."""
    from multimot_track_tpu.io import stream

    a, b = socket.socketpair()
    box = {}

    def server():
        try:
            box["sys"] = stream.serve_connection(b, cfg=cfg)
        except BaseException as e:  # re-raised below, in the main thread
            box["error"] = e
            raise
        finally:
            b.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    t0 = time.perf_counter()
    replies = []
    try:
        for fd in frames[:n]:
            stream.send_frame(
                a, np.clip(fd.gray, 0, 255).astype(np.uint8),
                np.clip(fd.depth_raw, 0, 65535).astype(np.uint16),
                flow=fd.flow, sem=fd.sem_mask, frame=fd.index,
                timestamp=fd.timestamp,
            )
            replies.append(stream.recv_result(a))
    finally:
        a.shutdown(socket.SHUT_WR)
        th.join(timeout=600)
        a.close()
    if "error" in box:
        raise box["error"]
    if th.is_alive():
        raise AssertionError("stream server did not finish")
    Ts = [np.asarray(r["Tcw"]).reshape(4, 4) for r in replies]
    good = ([r["frame"] for r in replies] == [fd.index for fd in frames[:n]]
            and all(np.isfinite(T).all() for T in Ts)
            and box["sys"].summary()["n_frames"] == n)
    print(f"endpoint: {len(replies)} replies for {n} frames, states "
          f"{[r['state'] for r in replies]}", flush=True)
    if not good:
        raise AssertionError("stream endpoint failed its checks")
    rep.info("endpoint s for 3 frames (incl. compile)", f"{time.perf_counter() - t0:.3f}")


# ------------------------------------------------------------- four cards
def phase_multi(rep: Report, cfg: PipelineConfig, frames, n_dev=4,
                n_pairs=N_PAIRS_MULTI):
    """The paths that span devices, each against one card: the full
    tracker over a flat "pair" mesh, and the point-sharded flow-BA."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimot_track_tpu.parallel import dist_ba, mesh as meshmod, pairwise
    from multimot_track_tpu.pipeline import batch as B
    from multimot_track_tpu.pipeline import frames as Fr
    from multimot_track_tpu.solvers.flow_ba import solve_flow_ba

    frames = frames[: n_pairs + 1]
    K = cfg.padding.k_obj_max
    gray = np.stack([np.clip(np.round(fd.gray), 0, 255).astype(np.uint8) for fd in frames])
    depth = np.stack([np.clip(fd.depth_raw, 0, 65535).astype(np.uint16) for fd in frames])
    flow = np.stack([B.pack_flow12(fd.flow) for fd in frames])
    sem = np.stack([B.pack_sem4(fd.sem_mask) for fd in frames])
    gts = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[
        Fr.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K) for fd in frames])
    obs = B.frontend_batch(jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(flow),
                           jnp.asarray(sem), gts, cfg)
    prev = jax.tree_util.tree_map(lambda x: x[:-1], obs)
    gt_cur = jax.tree_util.tree_map(lambda x: x[1:], gts)
    keys = jax.random.split(jax.random.PRNGKey(0), n_pairs)
    args = (keys, prev, jnp.asarray(gray[1:]), jnp.asarray(depth[1:]),
            jnp.asarray(sem[1:]), gt_cur)

    one = B.track_pairs(*args, cfg)
    mesh = meshmod.make_mesh(n_dev)
    sharded = jax.device_put(args, NamedSharding(mesh, P(meshmod.PAIR_AXIS)))
    t0 = time.perf_counter()
    multi = B.track_pairs(*sharded, cfg)
    jax.block_until_ready(multi)
    rep.info(f"track_pairs on {n_dev} cards first call s", f"{time.perf_counter() - t0:.3f}")
    shards = {s.device for s in multi.Tcw_cur.addressable_shards}
    T1, T4 = np.asarray(one.Tcw_cur), np.asarray(multi.Tcw_cur)
    per_pair = np.abs(T1 - T4).reshape(n_pairs, -1).max(1)
    traj = np.asarray(pairwise.compose_trajectory(multi.Tcw_cur))
    print(f"multi: track_pairs over {len(shards)} cards vs 1 card, per-pair "
          f"max|dT| {np.array2string(per_pair, precision=2)} (atol 1e-3)", flush=True)
    if not (len(shards) == n_dev and np.isfinite(T4).all()
            and (per_pair <= 1e-3).all() and np.isfinite(traj).all()):
        raise AssertionError("pair-sharded tracker disagrees with one card")

    cam = cfg.camera
    uv, fl, dep, valid, T_true = flow_ba_problem(300, 4096, 4096, outlier_frac=0.0)
    params = FlowBAParams(iters=50)
    pmesh = meshmod.make_mesh(n_dev, axis=meshmod.POINT_AXIS)
    dist = jax.jit(dist_ba.make_distributed_flow_ba(pmesh, params, cam.fx, cam.fy,
                                                    cam.cx, cam.cy))
    pts = NamedSharding(pmesh, P(meshmod.POINT_AXIS))
    eye = jnp.eye(4, dtype=jnp.float32)
    T_d = dist(eye, eye, *jax.device_put(
        (jnp.asarray(uv), jnp.asarray(fl), jnp.asarray(dep), jnp.asarray(valid)), pts))
    T_s = solve_flow_ba(eye, eye, jnp.asarray(uv), jnp.asarray(fl), jnp.asarray(dep),
                        jnp.asarray(valid), cam.fx, cam.fy, cam.cx, cam.cy,
                        params=params).T
    d = float(np.max(np.abs(np.asarray(T_d) - np.asarray(T_s))))
    print(f"multi: point-sharded flow-BA over {n_dev} cards vs 1 card max|dT| "
          f"{d:.2e} (atol 5e-4)", flush=True)
    if not d <= 5e-4:
        raise AssertionError("point-sharded flow-BA disagrees with one card")
    rep.take_compiles("multi")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    rep = Report()
    count = 4 if args.multi else 1
    device = phase_device(rep, count)
    cfg = DEFAULT_CONFIG
    t0 = time.perf_counter()
    frames = make_frames(N_PAIRS_MULTI + 1 if args.multi else N_FRAMES)
    rep.info(f"render {len(frames)} frames s (host)", f"{time.perf_counter() - t0:.3f}")
    if args.multi:
        phase_multi(rep, cfg, frames, n_dev=count)
    else:
        phase_kernels(rep, cfg)
        phase_streaming(rep, cfg, frames)
        phase_live(rep, cfg, frames)
        phase_endpoint(rep, cfg, frames)
        rep.take_compiles("endpoint")
    stats = jax.devices()[0].memory_stats() or {}
    rep.info("peak_bytes_in_use", stats.get("peak_bytes_in_use"))
    rep.info("wall s", f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
