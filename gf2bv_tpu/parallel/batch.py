"""Batched multi-instance solving: vmap over a leading batch dim + mesh
sharding on the ``batch`` axis.

This is the high-efficiency scaling axis the reference cannot use at all
(its per-guess NLFSR subsystems are solved one C call at a time,
``/root/reference/examples/nlfsr_ex.py:78-86``): here N same-shape systems
are one vmapped Gauss-Jordan, sharded across chips, with per-instance
inconsistency flags — no cross-instance sync anywhere, so scaling is linear.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import packing
from ..core.affine import AffineSpace
from . import mesh as meshlib

# Batch-route crossover between the vmapped per-pivot kernel and the
# blocked family (scripts/bench_batch_crossover.py measures it): tuned on
# another machine, to re-measure (ROADMAP S3).
_PER_PIVOT_MAX_COLS = 2048


@functools.partial(jax.jit, static_argnums=(1,))
def _rref_batched(a: jnp.ndarray, cols: int):
    """vmapped full Gauss-Jordan; a: (B, rows, W32) uint32."""
    from ..ops.gauss_jax import rref_device

    return jax.vmap(lambda m: rref_device(m, cols))(a)


def pack_batch(eq_mats: list[np.ndarray], cols: int) -> np.ndarray:
    """Stack packed (rows_i, W64) systems into one (B, rows_max32) uint32
    array, padding rows with zeros (harmless: zero rows never pivot)."""
    from ..ops.gauss_jax import _ROW_BUCKET

    rows_max = max((m.shape[0] for m in eq_mats), default=1)
    rows_pad = max(_ROW_BUCKET, -(-rows_max // _ROW_BUCKET) * _ROW_BUCKET)
    nw32 = 2 * packing.nwords64(1 + cols)
    out = np.zeros((len(eq_mats), rows_pad, nw32), dtype=np.uint32)
    for i, m in enumerate(eq_mats):
        out[i, : m.shape[0]] = packing.to_u32(m)
    return out


def solve_batch(
    eq_mats: list[np.ndarray],
    cols: int,
    mode: int,
    mesh=None,
):
    """Solve many independent systems at once.

    Returns a list with one entry per system: None (unsatisfiable), a packed
    origin (mode 0), or an (origin, basis) pair (mode 1).

    The vmapped kernel is the per-pivot one (cols sequential full-matrix
    passes per instance) — the right shape for the many-small-systems
    pattern this axis exists for.  From ``_PER_PIVOT_MAX_COLS`` up the
    per-pivot form loses to the blocked family (crossover: the constant),
    so wide systems route through the panel-blocked solvers instead.
    """
    if not eq_mats:
        return []
    from ..ops.gauss_blocked import solve_blocked

    if cols >= _PER_PIVOT_MAX_COLS:
        if mesh is not None:
            import warnings

            warnings.warn(
                f"solve_batch: cols={cols} routes through the batched "
                "blocked solver on the default device; the batch mesh is "
                "not used (shard wide systems with parallel.solve_sharded "
                "instead)",
                stacklevel=2,
            )
        # one stacked device program (ops/gauss_batched) unless the stacked
        # batch would be unreasonably large on device
        from ..ops.gauss_batched import padded_batch_dims, solve_batched

        # estimate from the PADDED dims solve_batched will actually allocate
        # (shared helper, so the guard can't drift from the allocation) —
        # the unpadded dims can undershoot several-fold for short rows /
        # narrow systems and risk a device OOM instead of the loop
        rows_max = max(m.shape[0] for m in eq_mats)
        rows_pad, wp = padded_batch_dims(rows_max, eq_mats[0].shape[1])
        est_bytes = len(eq_mats) * rows_pad * wp * 4
        if est_bytes <= 2 << 30:
            # mode 0: device-chained fused solves; mode 1: lax.map of the
            # blocked RREF + one batched extraction
            return solve_batched(eq_mats, cols, mode)
        return [solve_blocked(m, cols, mode) for m in eq_mats]
    a = pack_batch(eq_mats, cols)
    if mesh is not None:
        # pad batch to a multiple of the mesh batch axis
        nb = mesh.shape[meshlib.BATCH_AXIS]
        pad = (-len(eq_mats)) % nb
        if pad:
            a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)], axis=0)
        sharding = NamedSharding(mesh, P(meshlib.BATCH_AXIS, None, None))
        a = jax.device_put(a, sharding)
    rref32, pof, inconsistent = _rref_batched(jnp.asarray(a), cols)

    from ..ops import extract_device

    # Slice the mesh-padding instances off BEFORE extraction: an all-zero
    # padding system has dim == cols, and mode-1 basis extraction for it
    # would compile/run a cols-sized bucket purely for throwaway results.
    n = len(eq_mats)
    return extract_device.finalize_batch(
        rref32[:n], pof[:n], inconsistent[:n], cols, mode
    )


def solve_batch_systems(system, zeros_batch, mode: int = 0, mesh=None):
    """Batched LinearSystem front-end: one entry per zeros list.

    mode 0 -> list of raw solution ints (or None); mode 1 -> list of
    AffineSpace (or None).  QuadraticSystem consistency filtering still
    applies when converting via ``system.convert_sol``.
    """
    cols = system._cols

    from ..ops import solver as _solver

    resolved = _solver._resolve_backend(system._backend, cols)
    if mesh is None and resolved in ("native", "oracle"):
        # host engines: a per-system loop IS the fast path — there is no
        # dispatch/compile overhead to amortize with a stacked program
        # (the batch axis exists for device throughput); an explicit mesh
        # still routes to the device sharding below
        out = []
        for zeros in zeros_batch:
            eqs = system.get_eqs_packed(zeros)
            lit_one = (eqs[:, 0] == 1) & ~eqs[:, 1:].any(axis=1)
            if lit_one.any():
                out.append(None)
                continue
            eqs = eqs[eqs.any(axis=1)]
            raw = _solver.solve(eqs, cols, mode, backend=resolved)
            out.append(raw)
        return out

    mats, unsat = [], []
    for zeros in zeros_batch:
        eqs = system.get_eqs_packed(zeros)
        lit_one = (eqs[:, 0] == 1) & ~eqs[:, 1:].any(axis=1)
        unsat.append(bool(lit_one.any()))
        mats.append(eqs)
    raw = solve_batch(mats, cols, mode, mesh=mesh)
    out = []
    for r, u in zip(raw, unsat):
        if u or r is None:
            out.append(None)
        elif mode == 0:
            out.append(packing.words_to_int(r))
        else:
            out.append(AffineSpace(r[0], r[1], cols))
    return out
