"""Row-sharded Gauss-Jordan: one huge system across many chips.

Multi-chip replacement for the reference's single-core ``m4ri_solve``
(``/root/reference/gf2bv/_internal.c:359-502``); the reference has no
distribution layer at all (SURVEY.md §2).

The multi-chip analog of M4RI's single-core PLUQ: the packed matrix is
block-sharded by rows over the ``rows`` mesh axis with ``shard_map``; each
pivot step does a local candidate argmax, a global winner election
(``lax.pmin`` on global row index), and a pivot-row broadcast (``lax.psum``
of a one-hot contribution) — both compile to device collectives.  The
elimination XOR is purely local.  This is the structural pattern SURVEY.md §5
maps from ring/context parallelism: shard one long axis, rotate/broadcast a
small working set.

Per-pivot collectives are latency-bound for huge cols; the blocked panel
variant (gauss_blocked) amortizes them K columns at a time.  This module is
the always-correct multi-chip path and the dryrun target.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import packing
from . import mesh as meshlib
from .mesh import _mesh_key

_BIG = np.int32(2**30)
_kernel_cache: dict = {}


def _build(mesh, cols: int):
    def kernel(a):
        """a: (rloc, W32) local row block."""
        rloc = a.shape[0]
        ax = lax.axis_index(meshlib.ROWS_AXIS).astype(jnp.int32)
        offset = ax * rloc
        row_ids = lax.broadcasted_iota(jnp.int32, (rloc, 1), 0)[:, 0]
        used0 = jnp.zeros((rloc,), jnp.bool_)
        pof0 = jnp.full((cols,), -1, jnp.int32)

        def step(k, carry):
            a, used, pof = carry
            j = k + 1
            word = j >> 5
            shift = (j & 31).astype(jnp.uint32)
            col = (
                lax.dynamic_index_in_dim(a, word, axis=1, keepdims=False) >> shift
            ) & 1
            cand = (col == 1) & ~used
            lidx = jnp.argmax(cand).astype(jnp.int32)
            lhas = cand[lidx]
            gidx = jnp.where(lhas, offset + lidx, _BIG)
            winner = lax.pmin(gidx, meshlib.ROWS_AXIS)  # lowest global row wins
            has = winner < _BIG
            i_own = has & (winner >= offset) & (winner < offset + rloc)
            lwin = jnp.where(i_own, winner - offset, 0)
            myrow = lax.dynamic_index_in_dim(a, lwin, axis=0, keepdims=False)
            contrib = jnp.where(i_own, myrow, jnp.zeros_like(myrow))
            pivrow = lax.psum(contrib, meshlib.ROWS_AXIS)  # broadcast pivot row
            elim = (col == 1) & has & ~(i_own & (row_ids == lwin))
            a = jnp.where(elim[:, None], a ^ pivrow[None, :], a)
            used = used | (i_own & (row_ids == lwin))
            pof = pof.at[k].set(jnp.where(has, winner, jnp.int32(-1)))
            return a, used, pof

        a, used, pof = lax.fori_loop(0, cols, step, (a, used0, pof0))
        return a, pof

    fn = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=P(meshlib.ROWS_AXIS, None),
        out_specs=(P(meshlib.ROWS_AXIS, None), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def rref_rowsharded(a32: np.ndarray, cols: int, mesh):
    """Sharded RREF. a32: (rows, W32) uint32, rows % mesh rows-axis == 0."""
    key = (_mesh_key(mesh), cols)
    fn = _kernel_cache.get(key)
    if fn is None:
        fn = _kernel_cache[key] = _build(mesh, cols)
    sharding = NamedSharding(mesh, P(meshlib.ROWS_AXIS, None))
    a = jax.device_put(a32, sharding)
    return fn(a)


def solve_rowsharded(eqs: np.ndarray, cols: int, mode: int, mesh):
    """Drop-in replacement for gauss_jax.solve_jax across a mesh."""
    from ..ops import extract_device

    naxis = mesh.shape[meshlib.ROWS_AXIS]
    a32 = packing.pad2d(packing.to_u32(eqs), row_align=naxis)
    rref32, pof = rref_rowsharded(a32, cols, mesh)
    inconsistent = extract_device.inconsistent_device(rref32)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)
