"""Worker for the REAL two-process jax.distributed test.

Each OS process runs this script with (process_id, num_processes, port,
out_dir).  It brings up the distributed runtime over a TCP coordinator —
the actual multi-host code path, not the single-process virtual mesh — builds
the hybrid ("host", "pair") mesh, assembles a global batch from
process-local shards, and runs the psum-assembled distributed flow-BA
(parallel/dist_ba) with its point axis spanning BOTH processes, so the
Schur reduction's collectives genuinely cross the process boundary.
Writes a JSON verdict per process; tests/test_multiprocess.py asserts it.
"""

import json
import os
import pathlib
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    out_dir = pathlib.Path(sys.argv[4])
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 --xla_cpu_max_isa=AVX2"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from multimot_track_tpu.config import CameraConfig
    from multimot_track_tpu.geometry import camera, se3
    from multimot_track_tpu.parallel import dist_ba, multihost
    from multimot_track_tpu.parallel.mesh import POINT_AXIS
    from multimot_track_tpu.solvers import flow_ba

    did_init = multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
    report = {"pid": pid, "did_init": bool(did_init)}
    try:
        assert jax.process_count() == nproc, jax.process_count()
        assert jax.device_count() == 4 * nproc, jax.device_count()
        assert jax.local_device_count() == 4

        mesh = multihost.make_process_mesh()
        assert mesh.devices.shape == (nproc, 4), mesh.devices.shape
        report["mesh_shape"] = list(mesh.devices.shape)

        # ---- global batch assembly from process-local rows ----
        B_local = 4
        local = {
            "x": (np.arange(B_local, dtype=np.float32)[:, None]
                  + pid * B_local) * np.ones((B_local, 3), np.float32)
        }
        g = multihost.global_pair_batch(mesh, local)
        total = float(jax.jit(lambda t: jnp.sum(t["x"]))(g))
        B = B_local * nproc
        expect = 3.0 * (B * (B - 1)) / 2.0
        assert abs(total - expect) < 1e-3, (total, expect)
        report["global_batch_sum_ok"] = True

        # ---- distributed flow-BA with the point axis across processes ----
        cam = CameraConfig()
        N = 2048
        rng = np.random.default_rng(7)   # SAME problem on every process
        uv = rng.uniform([80, 60], [cam.width - 80, cam.height - 60],
                         (N, 2)).astype(np.float32)
        z = rng.uniform(5, 30, N).astype(np.float32)
        X = np.asarray(camera.backproject(jnp.asarray(uv), jnp.asarray(z),
                                          cam.fx, cam.fy, cam.cx, cam.cy))
        T_true = np.asarray(se3.exp_se3(
            jnp.asarray([0.004, -0.003, 0.002, 0.05, -0.03, 0.9], jnp.float32)))
        Xc = np.asarray(se3.transform(jnp.asarray(T_true), jnp.asarray(X)))
        uv1 = np.asarray(camera.project(jnp.asarray(Xc), cam.fx, cam.fy,
                                        cam.cx, cam.cy))
        flow_meas = (uv1 - uv).astype(np.float32)
        valid = np.ones(N, bool)
        Twl = np.eye(4, dtype=np.float32)
        T0 = np.eye(4, dtype=np.float32)

        params = flow_ba.FlowBAParams(iters=40)
        # single-device reference
        ref = flow_ba.solve_flow_ba(
            jnp.asarray(T0), jnp.asarray(Twl), jnp.asarray(uv),
            jnp.asarray(flow_meas), jnp.asarray(z), jnp.asarray(valid),
            cam.fx, cam.fy, cam.cx, cam.cy, params,
        )
        T_ref = np.asarray(ref.T)

        # distributed: point axis over ALL (host x pair) devices
        pmesh = Mesh(mesh.devices.reshape(-1), (POINT_AXIS,))
        solve = dist_ba.make_distributed_flow_ba(
            pmesh, params, cam.fx, cam.fy, cam.cx, cam.cy
        )

        def shard_pts(x):
            return jax.make_array_from_process_local_data(
                NamedSharding(pmesh, P(POINT_AXIS, *([None] * (np.ndim(x) - 1)))),
                np.asarray(x)[pid * (N // nproc):(pid + 1) * (N // nproc)],
            )

        out = solve(
            jnp.asarray(T0), jnp.asarray(Twl), shard_pts(uv),
            shard_pts(flow_meas), shard_pts(z), shard_pts(valid),
        )
        T_dist = np.asarray(jax.device_get(out))   # solve returns the (4,4)
        err_vs_ref = float(np.abs(T_dist - T_ref).max())
        err_vs_true = float(np.abs(T_dist - T_true).max())
        report["dist_vs_single_max_abs"] = err_vs_ref
        report["dist_vs_true_max_abs"] = err_vs_true
        assert err_vs_ref < 5e-4, err_vs_ref
        assert err_vs_true < 5e-3, err_vs_true

        # ---- the FULL tracker, pair-sharded across both processes ----
        # same synthetic sequence on every process (same seed); each
        # process feeds only ITS pairs into the global batch, then checks
        # its addressable shards against a locally-computed reference.
        import __graft_entry__ as entrymod
        from multimot_track_tpu.pipeline import batch as B_
        from multimot_track_tpu.pipeline import frames as F

        dcfg = entrymod._dryrun_cfg()
        K = dcfg.padding.k_obj_max
        n_pairs = 4 * nproc
        nb = n_pairs + 1
        H, W = dcfg.camera.height, dcfg.camera.width
        rng2 = np.random.default_rng(1)
        gray2 = rng2.integers(0, 255, (nb, H, W)).astype(np.uint8)
        disp2 = rng2.uniform(2000, 20000, (nb, H, W)).astype(np.uint16)
        fl2 = np.clip(rng2.normal(0, 1.5, (nb, H, W, 2)) * 128.0,
                      -32767, 32767).astype(np.int16)
        sem2 = np.zeros((nb, H, W), np.uint8)
        sem2[:, 40:70, 60:120] = 1
        gts = [F.make_gt_table(np.eye(4), [1], [np.eye(4)], K) for _ in range(nb)]
        gt_stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *gts)
        obs = B_.frontend_batch(
            jnp.asarray(gray2), jnp.asarray(disp2), jnp.asarray(fl2),
            jnp.asarray(sem2), gt_stack, dcfg,
        )
        prev = jax.tree_util.tree_map(lambda x: np.asarray(x[:-1]), obs)
        gt_cur = jax.tree_util.tree_map(lambda x: np.asarray(x[1:]), gt_stack)
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), n_pairs))
        full = (keys, prev, gray2[1:], disp2[1:], sem2[1:], gt_cur)

        # local single-device reference over ALL pairs
        ref_res = B_.track_pairs(
            *jax.tree_util.tree_map(jnp.asarray, full), dcfg
        )
        ref_T = np.asarray(ref_res.Tcw_cur)

        lo, hi = pid * 4, (pid + 1) * 4
        local_tree = jax.tree_util.tree_map(lambda x: x[lo:hi], full)
        sharded = multihost.global_pair_batch(mesh, local_tree)
        res = B_.track_pairs(*sharded, dcfg)
        jax.block_until_ready(res)
        assert res.Tcw_cur.shape == (n_pairs, 4, 4)
        worst = 0.0
        for sh in res.Tcw_cur.addressable_shards:
            row = sh.index[0].start if sh.index[0].start is not None else 0
            got = np.asarray(sh.data)
            worst = max(worst, float(np.abs(got - ref_T[row:row + got.shape[0]]).max()))
        report["tracker_shard_vs_local_max_abs"] = worst
        assert worst < 5e-4, worst
        report["ok"] = True
    except Exception as e:  # pragma: no cover - surfaced via the verdict
        report["ok"] = False
        report["error"] = repr(e)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"proc{pid}.json").write_text(json.dumps(report))
    sys.exit(0 if report.get("ok") else 1)


if __name__ == "__main__":
    main()
