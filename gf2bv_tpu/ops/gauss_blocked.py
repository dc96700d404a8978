"""Panel-blocked Gauss-Jordan to RREF (v2) — the large-system fast path.

The per-pivot v1 (gauss_jax.py) reads and writes the whole matrix once per
column: ~cols full-matrix passes, hopelessly bandwidth-bound at MT19937
size (19969 x ~52 MB).  This module restructures the elimination the way
M4RI's PLE decomposition does (PAPERS.md: arXiv 1111.6549 / 1006.1744):

Per K-column panel (K = 256 by default):
  phase 1 (thin, sequential, :func:`phase1_panel`): forward-eliminate on the
    (rows, K/32)-word slice only, tracking per-row elimination coefficients
    C; reconstruct each *forward* pivot row at full width as
    ``PF_fwd[j] = A[piv] ^ xor-combo(PF_fwd, C[piv])``; then back-eliminate
    the K pivot rows against each other so PF becomes the panel's *final*
    (intra-panel RREF) pivot rows.
  phase 2 (bulk, :func:`apply_rank_k_update`): one rank-K update of the
    whole matrix.  Identity: with pivot columns c_j and final pivot rows PF,
        row_i_final = row_i_orig ^ sum_j alpha_ij PF[j],
        alpha_ij    = B_orig[i][c_j]  (+1 for i == pivot_row_j)
    because the final pivot rows form the identity on pivot columns.  So the
    update coefficients come straight from the *saved original* panel slice —
    no transformation tracking through the bulk matrix.

The result is bit-identical to v1's RREF (RREF is unique), so extraction is
shared.  Replaces m4ri_solve's PLUQ+TRSM+kernel path
(``/root/reference/gf2bv/_internal.c:309-502``) in one algorithm.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core import packing

# Panel width in bits, and the solver's row bucket and word alignment
# (``_pad(..., word_align=128)`` at the call sites): tuned on another
# machine, to re-measure (ROADMAP S3).
K_PANEL = 256
_G = 32  # selector bits folded into one fused full-matrix pass
_ROW_BUCKET = 256


def rank_k_update_jnp(a, s, pf):
    """a ^= XOR_{jj: s[i] bit jj} pf[jj], the portable jnp formulation.

    a: (rows, wp) u32; s: (rows, kw) u32 selector words; pf: (32*kw, wp).
    One xor-reduce op per selector word keeps the XLA graph small; the
    broadcasted AND fuses into the reduction.  Updates the full width
    (the trailing skip is the kernel engine's alone).
    """
    kw = s.shape[1]
    bshift = jnp.arange(_G, dtype=jnp.uint32)
    for g in range(kw):
        sw = s[:, g]
        bits = (sw[:, None] >> bshift[None, :]) & 1
        mask = (jnp.uint32(0) - bits).astype(jnp.uint32)
        delta = jnp.bitwise_xor.reduce(
            mask[:, :, None] & pf[None, g * _G : (g + 1) * _G, :], axis=1
        )
        a = a ^ delta
    return a


PHASE2_ENGINES = ("jnp", "triton")


def default_phase2() -> str:
    """The phase-2 engine for the default backend — the one place it is
    chosen: the Triton kernel on a GPU, the jnp formulation elsewhere."""
    return "triton" if jax.default_backend() == "gpu" else "jnp"


def apply_rank_k_update(a, s, pf, w0=None, phase2: str | None = None):
    """The phase-2 bulk update with the selected engine.

    ``w0`` (traced scalar, first word of the panel) enables the trailing
    skip on the Triton engine; the jnp engine does the (equally correct)
    full-width update.  Shapes the kernel does not tile take the jnp
    engine."""
    phase2 = phase2 or default_phase2()
    if phase2 not in PHASE2_ENGINES:
        raise ValueError(f"unknown phase-2 engine {phase2!r}")
    if phase2 == "triton":
        from . import triton_update

        if triton_update.tiles(a.shape):
            return triton_update.rank_k_update_triton(a, s, pf, w0)
    return rank_k_update_jnp(a, s, pf)


def phase1_panel(a, b, used, w0, K: int, cols: int):
    """Phase 1 of one K-column panel: forward pivot scan on the thin slice,
    full-width reconstruction of each forward pivot row, then the back pass
    that turns the K pivot rows into the panel's intra-panel RREF.

    a: (rows, wp) u32 (read at the pivot rows only); b: (rows, kw) u32 the
    panel's slice of ``a``; used: (rows,) bool rows already pivots; w0:
    traced word offset of the panel.  The pivot of a column is the unused
    row of lowest index holding it (the tournament solver relies on that
    order).  Returns (pf (K, wp) final pivot rows, prow (K,) int32 pivot
    row of each panel column or -1, used').
    """
    rows, wp = a.shape
    kw = K // 32
    row_ids = lax.broadcasted_iota(jnp.int32, (rows, 1), 0)[:, 0]
    bit_ids = lax.broadcasted_iota(jnp.int32, (K, 1), 0)[:, 0]

    def xor_select(mat, selbits):
        """XOR of mat rows (K, wp) selected by packed selbits (kw,) u32."""
        bits = (selbits[bit_ids >> 5] >> (bit_ids & 31).astype(jnp.uint32)) & 1
        mask = (jnp.uint32(0) - bits).astype(jnp.uint32)  # 0 or all-ones
        return jnp.bitwise_xor.reduce(mat & mask[:, None], axis=0)

    def fwd(jj, c):
        b, cmat, pf, used, prow = c
        gbit = 32 * w0 + jj  # packed bit position of this panel column
        valid = (gbit >= 1) & (gbit <= cols)
        word = jj >> 5
        shift = (jj & 31).astype(jnp.uint32)
        colb = (
            lax.dynamic_index_in_dim(b, word, axis=1, keepdims=False) >> shift
        ) & 1
        cand = (colb == 1) & ~used & valid
        piv = jnp.argmax(cand).astype(jnp.int32)
        has = cand[piv]

        # reconstruct the forward pivot row at full width
        arow = lax.dynamic_index_in_dim(a, piv, axis=0, keepdims=False)
        crow = lax.dynamic_index_in_dim(cmat, piv, axis=0, keepdims=False)
        full = arow ^ xor_select(pf, crow)
        pf = pf.at[jj].set(jnp.where(has, full, jnp.zeros_like(full)))

        # eliminate remaining candidates within the slice + record coeffs
        bpiv = lax.dynamic_index_in_dim(b, piv, axis=0, keepdims=False)
        elim = cand & (row_ids != piv)
        b = jnp.where(elim[:, None], b ^ bpiv[None, :], b)
        cw = lax.dynamic_index_in_dim(cmat, word, axis=1, keepdims=False)
        cw = cw ^ (elim.astype(jnp.uint32) << shift)
        cmat = lax.dynamic_update_slice(cmat, cw[:, None], (0, word))

        used = used | ((row_ids == piv) & has)
        prow = prow.at[jj].set(jnp.where(has, piv, jnp.int32(-1)))
        return b, cmat, pf, used, prow

    c0 = (
        b,
        jnp.zeros((rows, kw), jnp.uint32),
        jnp.zeros((K, wp), jnp.uint32),
        used,
        jnp.full((K,), -1, jnp.int32),
    )
    _, _, pf, used, prow = lax.fori_loop(0, K, fwd, c0)

    def back(s, pf):
        jj = K - 1 - s
        word = w0 + (jj >> 5)
        shift = (jj & 31).astype(jnp.uint32)
        pivoted = prow[jj] >= 0
        colb = (
            lax.dynamic_index_in_dim(pf, word, axis=1, keepdims=False) >> shift
        ) & 1
        elim = (colb == 1) & (bit_ids != jj) & pivoted
        pfrow = lax.dynamic_index_in_dim(pf, jj, axis=0, keepdims=False)
        return jnp.where(elim[:, None], pf ^ pfrow[None, :], pf)

    pf = lax.fori_loop(0, K, back, pf)
    return pf, prow, used


def selector_from_prow(b_orig, prow, owned=None, local_idx=None):
    """Phase-2 selector matrix: S = B_orig masked to pivot columns, with the
    diagonal flipped on each pivot's own row (see module docstring).

    b_orig: (rows, kw) u32 saved panel slice; prow: (K,) int32 pivot row
    indices (-1 = free column).  For the row-sharded solver, ``owned`` masks
    which pivots live in this shard and ``local_idx`` maps them to local row
    indices; default is the single-shard case (all owned, global == local).
    """
    rows, kw = b_orig.shape
    K = prow.shape[0]
    bit_ids = lax.broadcasted_iota(jnp.int32, (K, 1), 0)[:, 0]
    if owned is None:
        owned = prow >= 0
        local_idx = prow
    pivbit = (prow >= 0).astype(jnp.uint32) << (bit_ids & 31).astype(jnp.uint32)
    pm = jnp.zeros((kw,), jnp.uint32).at[bit_ids >> 5].add(pivbit)
    s = b_orig & pm[None, :]
    # flip the diagonal so pivot rows map onto PF themselves; writes for
    # unowned/free columns are dumped into an extra scratch row so they can
    # never clobber a genuine flip (duplicate scatter indices with different
    # values are undefined).
    s_ext = jnp.concatenate([s, jnp.zeros((1, kw), jnp.uint32)], axis=0)
    prow_safe = jnp.where(owned, local_idx, rows)
    wordidx = bit_ids >> 5
    bitval = jnp.where(
        owned, jnp.uint32(1) << (bit_ids & 31).astype(jnp.uint32), 0
    )
    gathered = s_ext[prow_safe, wordidx]
    return s_ext.at[prow_safe, wordidx].set(gathered ^ bitval)[:rows]


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def rref_blocked(
    a: jnp.ndarray,
    cols: int,
    k_panel: int = K_PANEL,
    phase2: str | None = None,
    trailing: bool = False,
):
    """Blocked RREF.  a: (rows, Wp) uint32 with Wp % (k_panel//32) == 0.

    ``phase2`` names the bulk-update engine (:data:`PHASE2_ENGINES`);
    None takes :func:`default_phase2`.

    Returns (rref, pivot_row_of_col, inconsistent) exactly like
    gauss_jax.rref_device.

    ``trailing=True`` (mode-0 fast path) lets the kernel engine skip word
    tiles left of each panel; once the panel has moved past the first
    tile, only that tile (which holds the const WORD, word 0) keeps being
    updated — the other columns left of the live panel (earlier pivot
    columns and free columns) go stale, because a mode-0 origin extraction
    reads nothing but ``rref[pivot_row, word 0]``.  The returned matrix is
    then NOT a full RREF left of the last panel, and the ``inconsistent``
    flag is unreliable — callers must verify the extracted solution against
    the original system instead (rref_origin_blocked does).
    """
    from . import extract_device

    K = k_panel
    kw = K // 32
    rows, wp = a.shape
    # only panels that can contain pivot bits (<= cols) need scanning;
    # words beyond them (width padding, multi-RHS columns) are carried
    # along by the rank-K updates but never host a panel themselves
    panels = min(wp // kw, -(-(1 + cols) // (32 * kw)))
    bit_ids = lax.broadcasted_iota(jnp.int32, (K, 1), 0)[:, 0]
    used0 = jnp.zeros((rows,), jnp.bool_)
    # pof padded by one dump slot for free columns' writes
    pof0 = jnp.full((cols + 1,), -1, jnp.int32)

    def panel_body(t, carry):
        a, used, pof = carry
        w0 = t * kw
        b_orig = lax.dynamic_slice(a, (0, w0), (rows, kw))
        pf, prow, used = phase1_panel(a, b_orig, used, w0, K, cols)
        dst = jnp.where(prow >= 0, 32 * w0 + bit_ids - 1, cols)
        pof = pof.at[dst].set(prow)
        # selector matrix from the SAVED original slice, then the rank-K
        # bulk update
        s = selector_from_prow(b_orig, prow)
        a = apply_rank_k_update(a, s, pf, w0 if trailing else None, phase2)
        return a, used, pof

    a, _, pof = lax.fori_loop(0, panels, panel_body, (a, used0, pof0))
    return a, pof[:cols], extract_device.inconsistent_device(a)


def origin_parity_unsat(a, origin32):
    """Per-row parity of A & [1|x]: any odd row means the candidate origin
    does not satisfy the ORIGINAL system (traceable; shared by the
    single-chip and sharded fused mode-0 paths)."""
    wp = a.shape[1]
    ox = origin32
    if wp > ox.shape[0]:
        ox = jnp.concatenate([ox, jnp.zeros((wp - ox.shape[0],), jnp.uint32)])
    # xfull = packed [const=1 | x]: shift the solution up one bit across words
    lo = jnp.concatenate([jnp.zeros((1,), jnp.uint32), ox[:-1] >> 31])
    xfull = ((ox << 1) | lo).at[0].set((ox[0] << 1) | 1)
    # a narrower than the u64-aligned origin: bits past a's storage cannot
    # participate in A & x, so truncate symmetrically instead of broadcasting
    xfull = xfull[:wp]
    ones = jnp.sum(
        lax.population_count(a & xfull[None, :]).astype(jnp.int32), axis=1
    )
    return jnp.any((ones & 1) == 1)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def rref_origin_blocked(
    a: jnp.ndarray,
    cols: int,
    k_panel: int = K_PANEL,
    phase2: str | None = None,
):
    """Fused RREF + mode-0 extraction in ONE device program.

    Returns (origin32 (Wsol32,) u32, unsat scalar) — the only outputs a
    solve_one needs, so a single dispatch+readback replaces the separate
    rref and origin_device calls.

    Runs the elimination in trailing mode (word tiles left of each panel
    may be skipped), which makes the RREF-based inconsistency flag
    unreliable; the satisfiability verdict instead comes from verifying
    A·[1|x] parity == 0 per row against the ORIGINAL input — strictly
    stronger (it would also catch an elimination bug) and one cheap fused
    matrix pass."""
    from . import extract_device

    rref32, pof, _ = rref_blocked(a, cols, k_panel, phase2, True)
    origin32 = extract_device.origin_device(rref32, pof, cols)
    return origin32, origin_parity_unsat(a, origin32)


def _pad(eqs: np.ndarray, k_panel: int, word_align: int = 1):
    a32 = packing.to_u32(eqs)
    return packing.pad2d(
        a32,
        row_align=_ROW_BUCKET,
        word_align=max(k_panel // 32, word_align),
    )


def _pad_device(a32, k_panel: int, word_align: int = 1):
    """Device-side analog of _pad: zero-pad a (rows, W32) jnp matrix to the
    solver's row-bucket and word alignments without a host round-trip."""
    rows, w32 = a32.shape
    walign = max(k_panel // 32, word_align)
    want_rows = max(_ROW_BUCKET, -(-rows // _ROW_BUCKET) * _ROW_BUCKET)
    want_w = -(-w32 // walign) * walign
    if want_rows == rows and want_w == w32:
        return a32
    return jnp.pad(a32, ((0, want_rows - rows), (0, want_w - w32)))


def solve_blocked(
    eqs: np.ndarray,
    cols: int,
    mode: int,
    k_panel: int = K_PANEL,
    phase2: str | None = None,
):
    """Drop-in replacement for gauss_jax.solve_jax; same return contract."""
    from . import extract_device
    from ..utils import profiling

    with profiling.phase("pad"):
        a32 = _pad(eqs, k_panel, word_align=128)
    with profiling.phase("h2d"):
        a_dev = jnp.asarray(a32)
        a_dev.block_until_ready()
    if mode == 0:
        with profiling.phase("rref+origin"):
            origin32, inconsistent = jax.device_get(
                rref_origin_blocked(a_dev, cols, k_panel, phase2)
            )
        if bool(inconsistent):
            return None
        return packing.from_u32(origin32[None, :])[0]
    with profiling.phase("rref"):
        rref32, pof, inconsistent = rref_blocked(a_dev, cols, k_panel, phase2)
    with profiling.phase("extract"):
        return extract_device.finalize(rref32, pof, inconsistent, cols, mode)
