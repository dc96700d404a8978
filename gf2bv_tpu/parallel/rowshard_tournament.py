"""Tournament-pivoting row-sharded elimination: ONE collective per panel.

The panel-blocked sharded solver (rowshard_blocked.py) still pays two
latency-bound collectives per PIVOT (pmin election + psum row broadcast) —
~2K collective rounds per panel dominate a pod-scale solve.  This module
reduces communication to one ``all_gather`` per PANEL:

1. every shard runs the panel phase 1 (gauss_blocked.phase1_panel) on
   its local row block — purely local — electing up to K local rows whose
   strip span covers the shard's panel columns;
2. the K elected rows are all-gathered RAW — un-eliminated, straight out
   of the local block (K·wp words, one round);
3. every shard runs the same phase 1 on the replicated (N·K, wp)
   stacked rows, yielding the merged panel pivot rows;
4. the rank-K bulk update is entirely local, exactly as in
   rowshard_blocked.

Exactness: the local scan's in-strip elimination is an invertible
transform among the elected rows, so the RAW elected rows span the same
panel-strip space as the locally-reduced candidates — no pivot can be
missed (rank of the gathered union = global panel rank).  Gathering RAW
rows (not local combinations) is what makes the bulk update's
diagonal-flip replacement exact: the merged pivot rows are combinations
of ELECTED stacked rows only, so the owner's original row reduces to its
merged pf row through its own original strip selector — the single-chip
algebra verbatim.  (Round-4 bug, caught by fuzzing: gathering the
locally-ELIMINATED candidates breaks that identity whenever a local
combination involves a slot that loses the merged election — the raw row
then sits outside span(merged pf), the replaced row keeps a nonzero
residual, and the matrix silently drops rank; underdetermined systems
at ~2000 cols lost pivots.  Bit-exactness vs the oracle over random
underdetermined shapes now guards this.)

Communication per panel: one all_gather of K·wp words (+ 2K small ids)
versus 2K scalar/row collectives — the collective-latency term drops from
O(cols) rounds to O(cols/K).  Replaces the reference's single-core PLUQ
(``/root/reference/gf2bv/_internal.c:359-502``) at pod scale.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import packing
from ..ops.gauss_blocked import (
    _ROW_BUCKET,
    apply_rank_k_update,
    origin_parity_unsat,
    phase1_panel,
    selector_from_prow,
)
from . import mesh as meshlib
from .mesh import _mesh_key

_kernel_cache: dict = {}


def _build(mesh, cols: int, k_panel: int, fused_origin: bool = False):
    K = k_panel
    kw = K // 32
    naxis = mesh.shape[meshlib.ROWS_AXIS]

    def kernel(a_in):
        """a_in: (rloc, wp) local row block; wp % (k_panel//32) == 0."""
        rloc, wp = a_in.shape
        panels = wp // kw
        ax = lax.axis_index(meshlib.ROWS_AXIS).astype(jnp.int32)
        offset = ax * rloc
        bit_ids = lax.broadcasted_iota(jnp.int32, (K, 1), 0)[:, 0]
        used0 = jnp.zeros((rloc,), jnp.bool_)
        pof0 = jnp.full((cols + 1,), -1, jnp.int32)  # +1 dump slot

        def panel_body(t, carry):
            a, used, pof = carry
            w0 = t * kw
            b_orig = lax.dynamic_slice(a, (0, w0), (rloc, kw))

            # 1) local phase 1: elect up to K local rows spanning the
            # shard's panel-strip space.  Only the election is used (its
            # local pivot rows are dead code to XLA) — the merged stage
            # below does ALL reduction; see module docstring for why the
            # RAW rows must be the ones gathered
            _, prow_l, _ = phase1_panel(a, b_orig, used, w0, K, cols)
            valid_l = prow_l >= 0
            raw_l = jnp.where(
                valid_l[:, None], a[jnp.maximum(prow_l, 0)], jnp.uint32(0)
            )

            # 2) ONE collective round: gather the raw elected rows + their
            # global ids together (a pytree all_gather; XLA's collective
            # combiner merges the two gathers into one round on the wire)
            stacked, grow = lax.all_gather(
                (raw_l, jnp.where(valid_l, prow_l + offset, -1)),
                meshlib.ROWS_AXIS,
            )
            stacked = stacked.reshape(naxis * K, wp)
            grow = grow.reshape(naxis * K)

            # 3) merged phase 1 on the replicated stacked candidates
            sb = lax.dynamic_slice(stacked, (0, w0), (naxis * K, kw))
            pf, prow_s, _ = phase1_panel(
                stacked, sb, grow < 0, w0, K, cols  # invalid = used
            )

            # map merged pivots (stacked indices) back to global/local rows
            prow_safe = jnp.maximum(prow_s, 0)
            gpiv = jnp.where(prow_s >= 0, grow[prow_safe], -1)
            owned = (prow_s >= 0) & (gpiv >= offset) & (gpiv < offset + rloc)
            local_idx = jnp.where(owned, gpiv - offset, 0)

            used = used | jnp.zeros((rloc,), jnp.bool_).at[
                jnp.where(owned, local_idx, rloc)
            ].set(True, mode="drop")
            gbit = 32 * w0 + bit_ids
            dst = jnp.where(prow_s >= 0, gbit - 1, cols)
            pof = pof.at[dst].set(gpiv)

            # 4) rank-K bulk update — entirely local; mode-0 fused solves
            # use the trailing skip (the single-chip fast path)
            s = selector_from_prow(b_orig, gpiv, owned=owned, local_idx=local_idx)
            a = apply_rank_k_update(a, s, pf, w0 if fused_origin else None)
            return a, used, pof

        a, used, pof = lax.fori_loop(0, panels, panel_body, (a_in, used0, pof0))
        pof = pof[:cols]
        if not fused_origin:
            return a, pof

        # --- fused mode-0 tail: origin from owned pivot rows (psum'd), then
        # per-row parity verification against the ORIGINAL local block ------
        nw32 = 2 * ((cols + 63) // 64)  # u64-aligned like origin_device
        col_ids = jnp.arange(cols, dtype=jnp.int32)
        mine = (pof >= offset) & (pof < offset + rloc)
        lrow = jnp.where(mine, pof - offset, 0)
        bit = (a[lrow, 0] & 1) & mine.astype(jnp.uint32)
        contrib = (
            jnp.zeros((nw32,), jnp.uint32)
            .at[col_ids >> 5]
            .add(bit << (col_ids & 31).astype(jnp.uint32))
        )
        origin32 = lax.psum(contrib, meshlib.ROWS_AXIS)

        local_bad = origin_parity_unsat(a_in, origin32)
        unsat = lax.pmax(local_bad.astype(jnp.int32), meshlib.ROWS_AXIS) > 0
        return origin32, unsat

    out_specs = (P(), P()) if fused_origin else (P(meshlib.ROWS_AXIS, None), P())
    fn = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=P(meshlib.ROWS_AXIS, None),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def rref_rowsharded_tournament(
    a32: np.ndarray,
    cols: int,
    mesh,
    k_panel: int = 256,
    fused_origin: bool = False,
):
    """Sharded tournament RREF; rows % rows-axis == 0 and
    W32 % (k_panel//32) == 0 are the caller's responsibility (see solve).

    fused_origin=True returns (origin32, unsat) instead of (rref, pof):
    trailing phase-2, in-kernel origin extraction, and a psum'd A·[1|x]
    parity verification — the sharded version of rref_origin_blocked."""
    key = (_mesh_key(mesh), cols, k_panel, fused_origin)
    fn = _kernel_cache.get(key)
    if fn is None:
        fn = _kernel_cache[key] = _build(mesh, cols, k_panel, fused_origin)
    sharding = NamedSharding(mesh, P(meshlib.ROWS_AXIS, None))
    return fn(jax.device_put(a32, sharding))


def solve_rowsharded_tournament(
    eqs: np.ndarray,
    cols: int,
    mode: int,
    mesh,
    k_panel: int = 256,
):
    """Drop-in for rowshard_blocked.solve_rowsharded_blocked with
    one-collective-per-panel communication."""
    from ..ops import extract_device

    naxis = mesh.shape[meshlib.ROWS_AXIS]
    kw = k_panel // 32
    # local blocks padded to the single-chip row bucket and the width to
    # whole 128-word tiles (a multiple of kw too), so the phase-2 kernel
    # tiles each shard as it tiles the single-chip matrix
    a32 = packing.pad2d(
        packing.to_u32(eqs),
        row_align=_ROW_BUCKET * naxis,
        word_align=128 if 128 % kw == 0 else kw * 128,
    )
    if mode == 0:
        origin32, unsat = jax.device_get(
            rref_rowsharded_tournament(a32, cols, mesh, k_panel, fused_origin=True)
        )
        if bool(unsat):
            return None
        return packing.from_u32(np.asarray(origin32)[None, :])[0]
    rref32, pof = rref_rowsharded_tournament(a32, cols, mesh, k_panel)
    inconsistent = extract_device.inconsistent_device(rref32)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)
