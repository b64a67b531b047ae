"""Device-mesh helpers.

The reference has no distributed backend at all (SURVEY.md §2.5) — its
parallelism is 3 CPU threads and mutexes.  Here scaling is expressed
as a ``jax.sharding.Mesh`` over the devices, shardings annotated
with ``NamedSharding``/``PartitionSpec``, XLA inserting the collectives.

Axes:
  "pair"  — data parallelism over frame pairs (batch axis of the tracker);
  "point" — sharding of a single solve's point set (distributed BA).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401

PAIR_AXIS = "pair"
POINT_AXIS = "point"


def make_mesh(n_devices: int | None = None, axis: str = PAIR_AXIS) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.asarray(devs[:n]), (axis,))


def pair_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for a batch of frame pairs."""
    return NamedSharding(mesh, P(PAIR_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
