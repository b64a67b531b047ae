"""REAL multi-process distribution: two OS processes, a TCP coordinator,
and cross-process collectives (the multi-host code path itself, not the
single-process virtual mesh the other multihost tests use).

Each worker (tools/multiprocess_worker.py) brings up jax.distributed
over 127.0.0.1, builds the hybrid ("host", "pair") mesh spanning both
processes, assembles a global pair batch from process-local shards, and
runs the psum-assembled distributed flow-BA with the point axis crossing
the process boundary — asserting the result matches the single-device
solve to float32 exactness."""

import json
import pathlib
import socket
import subprocess
import sys

import pytest

WORKER = pathlib.Path(__file__).resolve().parent.parent / "tools" / "multiprocess_worker.py"


@pytest.mark.slow
def test_two_process_distributed_runtime(tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(i), "2", str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=540)[0].decode() for p in procs]

    reports = {}
    for i in range(2):
        f = tmp_path / f"proc{i}.json"
        assert f.exists(), f"worker {i} wrote no verdict:\n{outs[i][-3000:]}"
        reports[i] = json.loads(f.read_text())

    for i, p in enumerate(procs):
        assert p.returncode == 0, (i, reports[i], outs[i][-3000:])
    for i in range(2):
        r = reports[i]
        assert r["ok"], r
        assert r["did_init"], r
        assert r["mesh_shape"] == [2, 4], r
        assert r["global_batch_sum_ok"], r
        # distributed == single-device to float32 exactness
        assert r["dist_vs_single_max_abs"] < 5e-4, r
        # the FULL tracker, pair-sharded across both processes, matches a
        # locally-computed reference on every addressable shard
        assert r["tracker_shard_vs_local_max_abs"] < 5e-4, r
