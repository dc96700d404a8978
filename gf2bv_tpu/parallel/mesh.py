"""Device-mesh helpers for the batched and row-sharded solvers.

The reference is single-process (SURVEY.md §2: no distribution layer at
all); this module introduces one: ``jax.sharding.Mesh`` +
``NamedSharding``, letting XLA place the collectives.  Axis names:

* ``"batch"`` — independent systems (data-parallel analog; the per-guess
  NLFSR subsystem pattern, ``/root/reference/examples/nlfsr_ex.py:78-86``)
* ``"rows"``  — block row-sharding of one huge system (tensor/sequence
  parallel analog; pivot argmax + pivot-row broadcast are collectives)
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
ROWS_AXIS = "rows"


def make_mesh(
    batch: int | None = None, rows: int | None = None, devices=None
) -> Mesh:
    """Build a (batch, rows) mesh over ``devices`` (default: all devices).

    With only one knob given, the other absorbs the remaining devices.
    Defaults to all devices on the batch axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if batch is None and rows is None:
        batch, rows = n, 1
    elif batch is None:
        batch = n // rows
    elif rows is None:
        rows = n // batch
    if batch * rows != n:
        raise ValueError(f"mesh {batch}x{rows} != {n} devices")
    devs = np.asarray(devices).reshape(batch, rows)
    return Mesh(devs, (BATCH_AXIS, ROWS_AXIS))


def _mesh_key(mesh: Mesh):
    """Value-based cache key for per-mesh compiled kernels: id() can be
    reused after a mesh is garbage-collected."""
    return (
        tuple(sorted(mesh.shape.items())),
        tuple(d.id for d in mesh.devices.flat),
    )


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BATCH_AXIS, None, None))


def rows_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROWS_AXIS, None))
