"""Incremental GF(2) solving: add equations WITHOUT re-eliminating.

The reference factors from scratch on every ``m4ri_solve`` call
(/root/reference/gf2bv/_internal.c:359-502), so the common online-attack
loop — observe a few more PRNG outputs, re-solve, repeat until the
solution space collapses to a point — pays a full PLUQ per round.  Here
the RREF is device-resident and UNIQUE, so appending B rows is three
bounded passes instead of a fresh elimination:

1. reduce the new rows against the existing pivots — order-free, because
   RREF pivot columns are elementary vectors, so one rank-R pass
   ``new ^= S · M`` (S = the new rows' bits at the pivot columns) fully
   reduces them;
2. mutually eliminate the reduced block (<= B tiny rank-1 steps: each
   row's leading live column is cleared from the other new rows — the
   resulting rows are the unique RREF rows of the new quotient space);
3. back-substitute: one rank-B pass clears the new pivot columns from the
   existing matrix, then the new pivot rows land in preallocated slack
   capacity (``lax.dynamic_update_slice`` at a traced offset, so every
   add of a bucket size reuses ONE compiled program).

The maintained invariant is the full (non-trailing) RREF of everything
added so far, bit-identical to a from-scratch elimination — tests pin
that equality, which is what makes the fast path trustworthy.

All state (matrix, pivot maps) stays on device between adds; only the new
equations cross the host boundary.

Why there is no host/native twin (considered, rejected round 4): reducing
B new rows against a dense rank-R RREF streams the whole ~R*nw matrix per
new row (or rebuilds per-panel XOR tables, which costs the same as a bulk
elimination pass), so at flagship scale an incremental host add costs
about as much as the native engine's 0.3 s from-scratch solve.

Speed: scripts/bench_incremental.py times add() against a from-scratch
fused solve at the flagship 19968-var shape (on the GPU: not measured
yet).  The three add passes are full-matrix sweeps without the blocked
solver's panel locality/trailing skips.  Use this class for its ONLINE SEMANTICS — device-resident state across
observation rounds, rank/dimension after every add without re-uploading
or re-eliminating anything, sticky unsat — not for per-round speed at
flagship scale; for raw throughput re-solve from scratch (solve_blocked)
or batch instances via ops/multi_rhs.  (The reference has no incremental
surface at all: one full PLUQ per `m4ri_solve` call,
/root/reference/gf2bv/_internal.c:359-502.)
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core import packing
from ..core.affine import AffineSpace

_B_BUCKETS = (128, 512, 2048)
# Sentinel "no live bit" column index.  A plain int (not a jnp scalar):
# creating a device array at module scope would initialize the JAX backend
# as a side effect of `import gf2bv_tpu`.
_BIG = 1 << 30


def _bucket_rows(n: int) -> int:
    for b in _B_BUCKETS:
        if n <= b:
            return b
    raise ValueError(
        f"add at most {_B_BUCKETS[-1]} equations per call (got {n})"
    )


def _xor_select_update(a, sel_bits, pf):
    """a ^= sel·pf over GF(2).  a: (N, wp) u32; sel_bits: (N, K) 0/1 u32;
    pf: (K, wp) u32, K % 32 == 0.  A lax.scan over 32-row chunks of pf
    keeps the XLA graph size constant in K (the fused mask-and-xor-reduce
    shape is the same one rank_k_update_jnp compiles)."""
    K, wp = pf.shape
    n = a.shape[0]

    def body(acc, i):
        sb = lax.dynamic_slice(sel_bits, (0, 32 * i), (n, 32))
        pfch = lax.dynamic_slice(pf, (32 * i, 0), (32, wp))
        mask = (jnp.uint32(0) - sb).astype(jnp.uint32)
        delta = jnp.bitwise_xor.reduce(
            mask[:, :, None] & pfch[None, :, :], axis=1
        )
        return acc ^ delta, None

    out, _ = lax.scan(body, a, jnp.arange(K // 32))
    return out


def _bits_at(mat, pos):
    """bit ``pos[k]`` of every row: (N, wp) u32, (K,) i32 -> (N, K) u32 0/1.
    Negative positions yield 0."""
    pw = jnp.maximum(pos, 0) >> 5
    ps = (jnp.maximum(pos, 0) & 31).astype(jnp.uint32)
    bits = (mat[:, pw] >> ps[None, :]) & 1
    return jnp.where((pos >= 0)[None, :], bits, 0)


@functools.partial(jax.jit, static_argnums=(5,))
def _add_step(M, pof, pcol, nrows, new, cols: int):
    """One incremental add.  M: (rows_cap, wp) u32 full RREF with zero
    slack rows past ``nrows``; pof: (cols,) i32 variable -> pivot row;
    pcol: (rows_cap,) i32 pivot row -> variable (-1 elsewhere); new:
    (B_pad, wp) u32 packed new equations (zero rows allowed).

    Returns (M', pof', pcol', nrows', unsat, npiv)."""
    rows_cap, wp = M.shape
    B = new.shape[0]

    # -- 1) reduce against existing pivots (one rank-R pass) ---------------
    # keep pcol's -1 sentinel NEGATIVE through the +1 shift: pcol+1 == 0
    # would select the affine bit, and a 0=1 row in M (already-unsat
    # system) would then be XORed into new rows, corrupting rank counts
    red = _xor_select_update(
        new, _bits_at(new, jnp.where(pcol >= 0, pcol + 1, -1)), M
    )

    # -- 2) mutual elimination of the new block ----------------------------
    word_ids = jnp.arange(wp, dtype=jnp.int32)
    bit_ids = jnp.arange(32, dtype=jnp.uint32)
    gbit = 32 * word_ids[:, None] + bit_ids[None, :].astype(jnp.int32)
    live = (gbit >= 1) & (gbit <= cols)  # bit 0 is the affine column

    def lead_of(row):
        bits = ((row[:, None] >> bit_ids[None, :]) & 1) != 0
        return jnp.min(jnp.where(bits & live, gbit, _BIG))

    def elim_body(b, st):
        red, piv = st
        row = lax.dynamic_slice(red, (b, 0), (1, wp))[0]
        lead = lead_of(row)
        has = lead < _BIG
        lw = jnp.where(has, lead >> 5, 0)
        ls = jnp.where(has, lead & 31, 0).astype(jnp.uint32)
        bits = (red[:, lw] >> ls) & 1
        bits = bits.at[b].set(0)
        bits = jnp.where(has, bits, 0)
        red = red ^ ((jnp.uint32(0) - bits)[:, None] & row[None, :])
        piv = piv.at[b].set(jnp.where(has, lead, jnp.int32(-1)))
        return red, piv

    red, piv = lax.fori_loop(
        0, B, elim_body, (red, jnp.full((B,), -1, jnp.int32))
    )

    # a fully-reduced row with no live column but the affine bit set: 0=1
    unsat = jnp.any((piv < 0) & ((red[:, 0] & 1) == 1))

    # -- 3) back-substitute the new pivot columns out of the old matrix ----
    is_piv = piv >= 0
    sel_old = _bits_at(M, piv)  # (rows_cap, B); piv<0 masked inside
    M = _xor_select_update(M, sel_old, red)

    # -- 4) land the new pivot rows in the slack region --------------------
    dst = nrows + jnp.cumsum(is_piv.astype(jnp.int32)) - 1
    dst = jnp.where(is_piv, dst, rows_cap + 1)  # OOB scatter rows drop
    M = M.at[dst].set(jnp.where(is_piv[:, None], red, 0))
    var = jnp.where(is_piv, piv - 1, cols)  # OOB scatter vars drop
    pof = pof.at[var].set(dst)
    pcol = pcol.at[dst].set(var)
    npiv = jnp.sum(is_piv.astype(jnp.int32))
    return M, pof, pcol, nrows + npiv, unsat, npiv


class IncrementalSolver:
    """Online solving over a device-resident RREF (see module docstring).

    >>> inc = IncrementalSolver(system, zeros)
    >>> inc.add(more_zeros)          # cheap: no re-elimination
    >>> inc.dimension                # remaining solution-space dim
    >>> inc.solve_one()              # per-block tuple | None, like system
    """

    def __init__(self, system, zeros=(), *, slack: int = 2048,
                 k_panel: int | None = None):
        eqs = system.get_eqs_packed(list(zeros))
        self._init_packed(system, eqs, system._cols, slack, k_panel)

    @classmethod
    def from_packed(cls, eqs, cols: int, *, slack: int = 2048,
                    k_panel: int | None = None) -> "IncrementalSolver":
        """Build from an already-packed ``(rows, W64)`` uint64 matrix (no
        system object).  ``add_packed`` takes packed rows too; only the raw
        query surface (`solve_raw_*`) is available."""
        self = cls.__new__(cls)
        self._init_packed(None, np.asarray(eqs, np.uint64), cols,
                          slack, k_panel)
        return self

    def _init_packed(self, system, eqs, cols, slack, k_panel):
        from . import extract_device
        from .gauss_blocked import K_PANEL, _pad, rref_blocked

        self.system = system
        self._cols = cols
        k_panel = k_panel or K_PANEL
        if eqs.shape[0]:
            a32 = _pad(eqs, k_panel, word_align=128)
        else:
            want_w = -(-(1 + self._cols) // 32)
            wp = -(-want_w // 128) * 128
            a32 = np.zeros((128, wp), np.uint32)
        rref32, pof, bad = rref_blocked(jnp.asarray(a32), self._cols, k_panel)
        self._unsat = bool(bad)
        rows, wp = rref32.shape
        cap = rows + (-(-slack // 128) * 128)
        self._M = jnp.pad(rref32, ((0, cap - rows), (0, 0)))
        self._pof = pof
        pcol = jnp.full((cap,), -1, jnp.int32)
        pidx = jnp.arange(self._cols, dtype=jnp.int32)
        prow = jnp.where(pof >= 0, pof, cap + 1)  # OOB drops
        self._pcol = pcol.at[prow].set(pidx)
        self._nrows = jnp.asarray(rows, jnp.int32)
        self._rank = int(jnp.sum((pof >= 0).astype(jnp.int32)))
        self._extract = extract_device

    # -- online updates -----------------------------------------------------

    def add(self, zeros) -> "IncrementalSolver":
        """Fold new equations into the maintained RREF.  Returns self."""
        return self.add_packed(self.system.get_eqs_packed(list(zeros)))

    def add_packed(self, eqs) -> "IncrementalSolver":
        """`add` for an already-packed ``(rows, W64)`` uint64 matrix."""
        new32 = packing.to_u32(np.asarray(eqs, np.uint64))
        top = _B_BUCKETS[-1]
        for lo in range(0, new32.shape[0], top):
            self._add_chunk(new32[lo : lo + top])
        return self

    def _add_chunk(self, new32: np.ndarray) -> None:
        wp = self._M.shape[1]
        bpad = _bucket_rows(new32.shape[0])
        buf = np.zeros((bpad, wp), np.uint32)
        # a u64->u32 view can carry one zero tail word past wp; drop it
        new32 = new32[:, :wp]
        buf[: new32.shape[0], : new32.shape[1]] = new32
        if int(self._nrows) + bpad > self._M.shape[0]:
            grow = -(-bpad // 2048) * 2048
            self._M = jnp.pad(self._M, ((0, grow), (0, 0)))
            self._pcol = jnp.pad(self._pcol, (0, grow), constant_values=-1)
        M, pof, pcol, nrows, unsat, npiv = _add_step(
            self._M, self._pof, self._pcol, self._nrows,
            jnp.asarray(buf), self._cols,
        )
        self._M, self._pof, self._pcol, self._nrows = M, pof, pcol, nrows
        self._unsat = self._unsat or bool(unsat)
        self._rank += int(npiv)

    # -- queries ------------------------------------------------------------

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def dimension(self) -> int:
        """Dimension of the current solution space (meaningless if unsat)."""
        return self._cols - self._rank

    @property
    def unsat(self) -> bool:
        return self._unsat

    def solve_raw_one(self):
        if self._unsat:
            return None
        o32 = self._extract.origin_device(self._M, self._pof, self._cols)
        return packing.words_to_int(packing.from_u32(np.asarray(o32)[None])[0])

    def solve_raw_space(self):
        if self._unsat:
            return None
        o32 = self._extract.origin_device(self._M, self._pof, self._cols)
        origin = packing.from_u32(np.asarray(o32)[None])[0]
        basis = self._extract._basis_host_orchestrated(
            self._M, np.asarray(self._pof), self._cols
        )
        return AffineSpace(origin, basis, self._cols)

    def solve_one(self):
        if self.system is None:
            raise TypeError(
                "solve_one needs a system for convert_sol; "
                "from_packed solvers expose solve_raw_one/solve_raw_space"
            )
        raw = self.solve_raw_one()
        return None if raw is None else self.system.convert_sol(raw)
