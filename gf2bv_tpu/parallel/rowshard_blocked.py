"""Panel-blocked row-sharded elimination: the scalable multi-chip solver.

The per-pivot solver (rowshard.py) pays two collectives per column AND does
full-width local elimination per column — per-pivot full-matrix passes make
it latency- and bandwidth-bound.  This module is the multi-chip version of
the panel-blocked algorithm (ops/gauss_blocked.py): per K-column panel,

  phase 1 (thin, per pivot): the candidate scan and intra-slice elimination
    touch only the local (rloc, K/32)-word slice; the collectives per pivot
    are one ``pmin`` (global winner election on the row index, scalar) and
    one ``psum`` (the owner's reconstructed full-width forward pivot row,
    wp words) — after which the pivot-row panel ``pf`` is replicated on all
    shards for free.
  phase 2 (bulk): the rank-K update of the local row block is entirely
    local — ``selector_from_prow``'s ``owned``/``local_idx`` parameters mask
    the diagonal flip to the shard that owns each pivot row.  No bulk data
    ever crosses the interconnect; per-column communication is O(wp) words instead of the
    naive O(rows·wp).

Same RREF/pof contract as gauss_blocked.rref_blocked, with ``pof`` holding
GLOBAL row indices (block layout: global = shard * rloc + local), so
extract_device works on the sharded result unchanged.

Replaces the reference's single-core PLUQ (``/root/reference/gf2bv/
_internal.c:359-502``) at pod scale; the reference has no distribution layer
at all (SURVEY.md §2).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import packing
from ..ops.gauss_blocked import apply_rank_k_update, selector_from_prow
from . import mesh as meshlib
from .mesh import _mesh_key

_BIG = np.int32(2**30)
_kernel_cache: dict = {}


def _build(mesh, cols: int, k_panel: int):
    K = k_panel
    kw = K // 32

    def kernel(a):
        """a: (rloc, wp) local row block; wp % kw == 0."""
        rloc, wp = a.shape
        panels = wp // kw
        ax = lax.axis_index(meshlib.ROWS_AXIS).astype(jnp.int32)
        offset = ax * rloc
        row_ids = lax.broadcasted_iota(jnp.int32, (rloc, 1), 0)[:, 0]
        pf_ids = lax.broadcasted_iota(jnp.int32, (K, 1), 0)[:, 0]
        bit_ids = pf_ids
        used0 = jnp.zeros((rloc,), jnp.bool_)
        pof0 = jnp.full((cols + 1,), -1, jnp.int32)  # +1 dump slot

        def xor_select(mat, selbits):
            """XOR of mat rows (K, wp) selected by packed selbits (kw,)."""
            bits = (selbits[bit_ids >> 5] >> (bit_ids & 31).astype(jnp.uint32)) & 1
            mask = (jnp.uint32(0) - bits).astype(jnp.uint32)
            return jnp.bitwise_xor.reduce(mat & mask[:, None], axis=0)

        def panel_body(t, carry):
            a, used, pof = carry
            w0 = t * kw
            b_orig = lax.dynamic_slice(a, (0, w0), (rloc, kw))

            def p1(jj, c):
                b, cmat, pf, used, pof, prow_g, owned, lidx_arr = c
                gbit = 32 * w0 + jj
                valid = (gbit >= 1) & (gbit <= cols)
                word = jj >> 5
                shift = (jj & 31).astype(jnp.uint32)
                colb = (
                    lax.dynamic_index_in_dim(b, word, axis=1, keepdims=False)
                    >> shift
                ) & 1
                cand = (colb == 1) & ~used & valid
                lpos = jnp.argmax(cand).astype(jnp.int32)
                lhas = cand[lpos]
                gidx = jnp.where(lhas, offset + lpos, _BIG)
                winner = lax.pmin(gidx, meshlib.ROWS_AXIS)
                has = winner < _BIG
                i_own = has & (winner >= offset) & (winner < offset + rloc)
                lwin = jnp.where(i_own, winner - offset, 0)

                # owner reconstructs the full-width forward pivot row and
                # broadcasts it (psum of a one-hot contribution)
                arow = lax.dynamic_index_in_dim(a, lwin, axis=0, keepdims=False)
                crow = lax.dynamic_index_in_dim(cmat, lwin, axis=0, keepdims=False)
                full = arow ^ xor_select(pf, crow)
                contrib = jnp.where(i_own, full, jnp.zeros_like(full))
                pivrow = lax.psum(contrib, meshlib.ROWS_AXIS)
                pf = pf.at[jj].set(jnp.where(has, pivrow, jnp.zeros_like(pivrow)))

                # intra-slice elimination against the pivot's panel words
                bpiv = lax.dynamic_slice(pivrow, (w0,), (kw,))
                elim = cand & ~(i_own & (row_ids == lwin))
                b = jnp.where(elim[:, None], b ^ bpiv[None, :], b)
                cw = lax.dynamic_index_in_dim(cmat, word, axis=1, keepdims=False)
                cw = cw ^ (elim.astype(jnp.uint32) << shift)
                cmat = lax.dynamic_update_slice(cmat, cw[:, None], (0, word))

                used = used | (i_own & (row_ids == lwin))
                prow_g = prow_g.at[jj].set(jnp.where(has, winner, jnp.int32(-1)))
                owned = owned.at[jj].set(i_own)
                lidx_arr = lidx_arr.at[jj].set(lwin)
                dst = jnp.where(valid & has, gbit - 1, cols)
                pof = pof.at[dst].set(jnp.where(has, winner, jnp.int32(-1)))
                return b, cmat, pf, used, pof, prow_g, owned, lidx_arr

            c0 = (
                b_orig,
                jnp.zeros((rloc, kw), jnp.uint32),
                jnp.zeros((K, wp), jnp.uint32),
                used,
                pof,
                jnp.full((K,), -1, jnp.int32),
                jnp.zeros((K,), jnp.bool_),
                jnp.zeros((K,), jnp.int32),
            )
            _, _, pf, used, pof, prow_g, owned, lidx_arr = lax.fori_loop(
                0, K, p1, c0
            )

            # back-eliminate the (replicated) pivot rows — all-local
            def p1b(s, pf):
                jj = K - 1 - s
                word = w0 + (jj >> 5)
                shift = (jj & 31).astype(jnp.uint32)
                pivoted = prow_g[jj] >= 0
                colb = (
                    lax.dynamic_index_in_dim(pf, word, axis=1, keepdims=False)
                    >> shift
                ) & 1
                elim = (colb == 1) & (pf_ids != jj) & pivoted
                pfrow = lax.dynamic_index_in_dim(pf, jj, axis=0, keepdims=False)
                return jnp.where(elim[:, None], pf ^ pfrow[None, :], pf)

            pf = lax.fori_loop(0, K, p1b, pf)

            # rank-K bulk update of the local block — all-local
            s = selector_from_prow(b_orig, prow_g, owned=owned, local_idx=lidx_arr)
            a = apply_rank_k_update(a, s, pf)
            return a, used, pof

        a, used, pof = lax.fori_loop(0, panels, panel_body, (a, used0, pof0))
        return a, pof[:cols]

    fn = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=P(meshlib.ROWS_AXIS, None),
        out_specs=(P(meshlib.ROWS_AXIS, None), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def rref_rowsharded_blocked(a32: np.ndarray, cols: int, mesh, k_panel: int = 256):
    """Sharded blocked RREF.  a32: (rows, W32) u32; rows % rows-axis == 0 and
    W32 % (k_panel//32) == 0 are the caller's responsibility (see solve)."""
    key = (_mesh_key(mesh), cols, k_panel)
    fn = _kernel_cache.get(key)
    if fn is None:
        fn = _kernel_cache[key] = _build(mesh, cols, k_panel)
    sharding = NamedSharding(mesh, P(meshlib.ROWS_AXIS, None))
    a = jax.device_put(a32, sharding)
    return fn(a)


def solve_rowsharded_blocked(
    eqs: np.ndarray,
    cols: int,
    mode: int,
    mesh,
    k_panel: int = 256,
):
    """Drop-in replacement for rowshard.solve_rowsharded (same contract),
    using the panel-blocked kernel."""
    from ..ops import extract_device

    naxis = mesh.shape[meshlib.ROWS_AXIS]
    a32 = packing.pad2d(
        packing.to_u32(eqs), row_align=naxis, word_align=k_panel // 32
    )
    rref32, pof = rref_rowsharded_blocked(a32, cols, mesh, k_panel)
    inconsistent = extract_device.inconsistent_device(rref32)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)
