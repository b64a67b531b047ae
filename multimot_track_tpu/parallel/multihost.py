"""Multi-host distribution: jax.distributed runtime + process-aware meshes.

The reference's entire parallelism story is three pthreads and mutexes in
one process (src/System.cc:155-163 starts LocalMapping/LoopClosing/Viewer
threads); it has no multi-machine path at all.  SURVEY.md §2.5 asks for a
real distributed backend.  The design:

  * every host runs the same program and calls :func:`initialize` once
    with the coordinator address / process count / process id (nothing
    discovers a cluster on its own);
  * the device mesh is two-level: the outer ``"host"`` axis spans
    processes (the host network) and the inner ``"pair"`` axis the local
    devices of one process (NVLink on a multi-GPU host) — collectives
    that ride the fast fabric stay on the inner axis;
  * the frame-pair batch (pipeline/batch.track_pairs) is sharded over
    *both* axes of the mesh: pairs are embarrassingly parallel, so the
    only cross-device traffic XLA inserts is the final gather of the
    packed result vector;
  * each host feeds only its local shard of the batch —
    :func:`global_pair_batch` assembles per-process numpy data into one
    global jax.Array with ``jax.make_array_from_process_local_data`` (no
    host ever materialises the full batch).
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multimot_track_tpu.parallel.mesh import PAIR_AXIS

HOST_AXIS = "host"

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
) -> bool:
    """Bring up the multi-process JAX runtime (idempotent).

    Pass coordinator/count/id explicitly (or set JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns True if this call performed the initialisation, False if the
    runtime was already up (or is single-process with no coordinator
    configured, in which case initialisation is not needed).
    """
    global _initialized
    if _initialized:
        return False
    # NOTE: must not touch the XLA backend before jax.distributed comes up
    # (jax.process_count()/jax.devices() would initialise it single-process
    # and make distributed initialisation impossible) — probe the
    # distributed client state directly instead.
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        _initialized = True           # embedder already brought it up
        return False
    import os

    if coordinator_address is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        # plain single-process run (the common local case): nothing to do
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:
        msg = str(e)
        if "already" in msg:  # initialised by the embedder
            _initialized = True
            return False
        if "must be called before" in msg and (num_processes or 1) <= 1:
            # backend already up in a single-process program (tests, REPL):
            # distribution cannot and need not be initialised
            return False
        raise
    _initialized = True
    return True


def make_process_mesh(
    devices: Sequence[jax.Device] | None = None,
    emulate_hosts: int | None = None,
) -> Mesh:
    """A ("host", "pair") mesh: processes outer, local devices inner.

    Multi-process: the "host" axis spans processes and "pair" the local
    devices, rows ordered by process — the layout where per-pair work
    never crosses hosts and the result gather is the only inter-host
    transfer.  Every device of a host reaches every other at the same
    rate, so the mesh follows the algorithm alone.

    Single-process: a (1, n) mesh over the given/available devices — the
    same PartitionSpecs work unchanged.  ``emulate_hosts`` folds the local
    devices into that many "host" rows instead, so multi-host sharding
    layouts (uneven axes, host-major batch order) are exercised on the
    virtual CPU mesh without a second machine.
    """
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    n_proc = jax.process_count()
    if n_proc > 1:
        devs = sorted(devices, key=lambda d: (d.process_index, d.id))
        mesh_devs = np.asarray(devs).reshape(n_proc, jax.local_device_count())
        return Mesh(mesh_devs, (HOST_AXIS, PAIR_AXIS))
    h = int(emulate_hosts or 1)
    assert len(devices) % h == 0, (len(devices), h)
    arr = np.asarray(devices).reshape(h, len(devices) // h)
    return Mesh(arr, (HOST_AXIS, PAIR_AXIS))


def pair_batch_spec(ndim: int) -> P:
    """Leading axis split over host x pair, everything else replicated."""
    return P((HOST_AXIS, PAIR_AXIS), *([None] * (ndim - 1)))


def shard_pair_batch(mesh: Mesh, tree):
    """Place a pair-batch pytree (leading axis = B) over the full mesh."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, pair_batch_spec(np.ndim(x)))),
        tree,
    )


def global_pair_batch(mesh: Mesh, local_tree):
    """Assemble per-process local pair batches into global sharded arrays.

    Every process passes its own (B_local, ...) numpy pytree; the result is
    a (B_local * process_count, ...) jax.Array sharded host-major over the
    mesh.  Single-process this degenerates to :func:`shard_pair_batch`.
    """
    if jax.process_count() == 1:
        return shard_pair_batch(mesh, local_tree)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(
            NamedSharding(mesh, pair_batch_spec(np.ndim(x))), np.asarray(x)
        ),
        local_tree,
    )
