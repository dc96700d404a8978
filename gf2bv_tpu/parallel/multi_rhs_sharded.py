"""Mesh-sharded multi-RHS serving: B instances of ONE trace structure
across N devices, ZERO cross-device communication.

The multi-RHS trick (ops/multi_rhs.py) amortizes one elimination over
thousands of appended per-instance affine columns; this module scales the
INSTANCE axis across a device mesh.  The coefficient matrix is replicated
and each device eliminates ``[A | its own slice of RHS tiles]`` —
recomputing the elimination per device is the right trade here because it
is already amortized over that device's thousands of instances, and the
alternative (row-sharding one elimination) spends per-panel collectives
to save work that costs less than the wire time.  Scaling is linear in
devices by construction: there are no collectives at all (verified by the
HLO test in tests/test_multi_rhs_sharded.py).

Elimination decisions depend only on the coefficient part (appended
columns can never pivot — the panel scan's validity mask guarantees it),
so every device computes the IDENTICAL coefficient RREF; mode 1 exploits
that to build the (shared) kernel basis once from the replicated output.

The reference solves each instance with its own full PLUQ on one core
(``/root/reference/gf2bv/_internal.c:359-502``); it has no distribution
layer at all (SURVEY.md §2).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import packing
from ..core.affine import AffineSpace
from ..ops import multi_rhs
from ..ops.gauss_blocked import K_PANEL
from . import mesh as meshlib
from .mesh import _mesh_key

_kernel_cache: dict = {}
_CACHE_MAX = 8


def _build(mesh, cols: int, wp: int, bw_d: int, k_panel: int):
    """Compiled shard_map solver for one (mesh, shape) combination."""

    def local(a_loc, rhs_loc):
        # one shared augment/eliminate/extract implementation with the
        # single-device path (tile padding, engine plumbing, extraction)
        rref32, pof, origins32, unsat_words = multi_rhs.solve_multi_rhs_device(
            a_loc, cols, rhs_loc, bw_d, k_panel
        )
        # the coefficient RREF and pivot map are device-invariant (the
        # appended block never influences pivoting), so returning them
        # with a replicated out_spec is exact, not an approximation
        return origins32, unsat_words, rref32[:, :wp], pof

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, meshlib.BATCH_AXIS)),
        out_specs=(
            P(meshlib.BATCH_AXIS, None),
            P(meshlib.BATCH_AXIS),
            P(),
            P(),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_capacity(mesh=None) -> tuple:
    """Validate a batch-axis mesh; returns ``(mesh, n_dev, per-chunk
    instance capacity)`` (the mesh is defaulted/echoed so callers can pass
    None)."""
    mesh = mesh if mesh is not None else meshlib.make_mesh()
    if meshlib.ROWS_AXIS in mesh.shape and mesh.shape[meshlib.ROWS_AXIS] > 1:
        raise ValueError(
            "multi-RHS sharding uses the batch axis; use a (batch, 1) mesh "
            "(row-shard one huge system with parallel.solve_sharded instead)"
        )
    n_dev = mesh.shape[meshlib.BATCH_AXIS]
    return mesh, n_dev, n_dev * multi_rhs.MAX_RHS


def pack_shard_blocks(instances, nb: int, n_dev: int, rows_pad: int,
                      pack_fn) -> tuple[np.ndarray, int]:
    """THE owner of the sharded-block layout: split ``nb`` instances into
    ``n_dev`` contiguous shards of ``nb_d = ceil(nb / n_dev)`` (instance g
    lives on device ``g // nb_d`` — the extractor's ``divmod`` mapping),
    pack each shard with ``pack_fn(slice, rows_pad, bw_d)``, zero-fill
    empty tail shards, and concatenate along the sharded word axis.
    Returns ``(packed (rows_pad, n_dev * bw_d) uint32, bw_d)``.  Both the
    generic bit-matrix path and the sweep's structured-RHS path build
    through here so the layout can never diverge from the extraction."""
    nb_d = -(-nb // n_dev)
    bw_d = multi_rhs._bw_for(nb_d)
    blocks = []
    for d in range(n_dev):
        sl = instances[d * nb_d : (d + 1) * nb_d]
        if sl.shape[0] == 0:  # trailing empty shard: phantom instances
            blocks.append(np.zeros((rows_pad, bw_d), np.uint32))
            continue
        blocks.append(pack_fn(sl, rows_pad, bw_d))
    return np.concatenate(blocks, axis=1), bw_d


def solve_multi_rhs_sharded(
    a32,
    cols: int,
    rhs_bits: np.ndarray | None,
    mode: int = 0,
    mesh=None,
    k_panel: int | None = None,
    basis_cache: dict | None = None,
    rhs_packed: np.ndarray | None = None,
    nb: int | None = None,
):
    """Solve the SAME coefficient matrix for many affine columns, instances
    sharded across the mesh batch axis (``ops/multi_rhs.solve_multi_rhs``
    contract: one entry per instance — raw int / None for mode 0, a
    basis-sharing AffineSpace / None for mode 1).

    a32: (rows_pad, wp) packed matrix (uint32, host or device; its own
    bit-0 affine column is inert); rhs_bits: (B, rows) uint8.  B may
    exceed N * MAX_RHS only by chunking at the caller (as in
    ``LinearSystem._sweep_from_eqs``).

    ``rhs_packed``/``nb``: pre-packed alternative (pass ``rhs_bits=None``):
    a (rows_pad, n_dev * bw_d) uint32 block — device d's instances in
    word columns [d*bw_d, (d+1)*bw_d) in ``_pack_rhs`` layout, bw_d the
    bucket for ceil(nb / n_dev).  Structured-RHS callers (the guess
    sweep) build this directly instead of materializing (B, rows) bits.
    """
    mesh, n_dev, _ = shard_capacity(mesh)

    a_dev = jnp.asarray(a32, jnp.uint32)
    rows_pad, wp = a_dev.shape
    if rhs_packed is not None:
        if nb is None:
            raise ValueError("rhs_packed requires nb")
        if nb == 0:
            return []
        nb_d = -(-nb // n_dev)
        bw_d, rem = divmod(rhs_packed.shape[1], n_dev)
        if rem or bw_d != multi_rhs._bw_for(nb_d):
            raise ValueError(
                f"rhs_packed width {rhs_packed.shape[1]} != n_dev * bucket "
                f"({n_dev} * {multi_rhs._bw_for(nb_d)}) for nb={nb}"
            )
    else:
        nb = rhs_bits.shape[0]
        if nb == 0:
            return []
        nb_d = -(-nb // n_dev)
        if nb_d > multi_rhs.MAX_RHS:
            raise ValueError(
                f"{nb} instances over {n_dev} devices is {nb_d}/device, "
                f"above MAX_RHS={multi_rhs.MAX_RHS}; chunk the batch"
            )
        rhs_packed, bw_d = pack_shard_blocks(
            np.asarray(rhs_bits, np.uint8), nb, n_dev, rows_pad,
            lambda sl, rp, bw: multi_rhs._pack_rhs(sl, rp, bw),
        )

    k_panel = k_panel or K_PANEL
    key = (_mesh_key(mesh), cols, rows_pad, wp, bw_d, k_panel)
    fn = _kernel_cache.get(key)
    if fn is None:
        fn = _build(mesh, cols, wp, bw_d, k_panel)
        while len(_kernel_cache) >= _CACHE_MAX:
            _kernel_cache.pop(next(iter(_kernel_cache)))
        _kernel_cache[key] = fn

    rhs_dev = jax.device_put(
        rhs_packed, NamedSharding(mesh, P(None, meshlib.BATCH_AXIS))
    )
    a_repl = jax.device_put(a_dev, NamedSharding(mesh, P(None, None)))
    origins_g, unsat_g, rref_coeff, pof = fn(a_repl, rhs_dev)
    origins32, unsat_words = jax.device_get((origins_g, unsat_g))

    bcache = basis_cache if basis_cache is not None else {}

    def _basis():
        if "basis" not in bcache:
            from ..ops import extract_device

            bcache["basis"] = extract_device._basis_host_orchestrated(
                rref_coeff, np.asarray(pof), cols
            )
        return bcache["basis"]

    out = []
    slots = 32 * bw_d  # origin rows per device block
    for g in range(nb):
        d, k = divmod(g, nb_d)
        if (unsat_words[d * bw_d + (k >> 5)] >> (k & 31)) & 1:
            out.append(None)
            continue
        origin = packing.from_u32(origins32[d * slots + k][None, :])[0]
        if mode == 0:
            out.append(packing.words_to_int(origin))
        else:
            out.append(AffineSpace(origin, _basis(), cols))
    return out
