"""Multi-host setup: one process per host, devices glued by jax.distributed.

The reference is strictly single-process (SURVEY.md §2: no distribution
inventory at all); this is the layer that extends the row-sharded and
batched solvers across hosts.  XLA compiles the same ``shard_map``
collectives (pmin/psum in rowshard.py) to the devices' interconnect (NCCL
on GPUs) — no hand-written communication layer exists or is needed.

Usage (same program on every host):

    from gf2bv_tpu.parallel import distributed, mesh as meshlib
    distributed.initialize()            # reads env or explicit args
    mesh = meshlib.make_mesh(rows=jax.device_count())   # global devices
    ... solve_rowsharded(eqs, cols, mode, mesh) ...

Pass coordinator_address (``host:port``) / num_processes / process_id
explicitly or via GF2BV_TPU_COORD / _NPROC / _PROC_ID; without them JAX
has no cluster to discover and the call fails.
"""

from __future__ import annotations

import os


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    import jax

    coordinator_address = coordinator_address or os.environ.get("GF2BV_TPU_COORD")
    if num_processes is None and "GF2BV_TPU_NPROC" in os.environ:
        num_processes = int(os.environ["GF2BV_TPU_NPROC"])
    if process_id is None and "GF2BV_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["GF2BV_TPU_PROC_ID"])

    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_multi_process() -> bool:
    import jax

    return jax.process_count() > 1
