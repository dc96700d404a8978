"""Incremental solving (ops/incremental.py) vs from-scratch elimination.

The RREF is unique, so after any sequence of adds the maintained matrix,
pivot map, rank, origin, and basis must equal a fresh elimination of the
concatenated equations — the strongest possible oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gf2bv_tpu import LinearSystem
from gf2bv_tpu.core import packing
from gf2bv_tpu.ops.gauss_blocked import _pad, rref_blocked
from gf2bv_tpu.ops.gauss_ref import solve_oracle
from gf2bv_tpu.ops.incremental import IncrementalSolver


def _rand_zeros(lin, rng, n):
    (x,) = lin.gens(lazy=False)
    w = len(x)
    def rbits():
        v = int.from_bytes(rng.bytes(w // 8 + 1), "little") & ((1 << w) - 1)
        return v or 1

    secret = rbits()
    outs = []
    for _ in range(n):
        mask = rbits()
        bit = bin(secret & mask).count("1") & 1
        row = x & mask
        outs.append(row.sum() ^ bit)
    return secret, outs


def _dense_state(inc):
    """(sorted nonzero rows, pof) for order-insensitive RREF comparison."""
    m = np.asarray(inc._M)
    rows = m[m.any(axis=1)]
    order = np.lexsort(rows.T[::-1])
    return rows[order], np.asarray(inc._pof)


def _fresh_state(lin, all_zeros, cols):
    eqs = lin.get_eqs_packed(all_zeros)
    a32 = _pad(eqs, 128, word_align=128)
    rref, pof, bad = rref_blocked(jnp.asarray(a32), cols, 128)
    m = np.asarray(rref)
    rows = m[m.any(axis=1)]
    order = np.lexsort(rows.T[::-1])
    return rows[order], np.asarray(pof), bool(bad)


@pytest.mark.parametrize("w", [48, 200])
def test_incremental_matches_fresh_elimination(w):
    rng = np.random.default_rng(101 + w)
    lin = LinearSystem([w])
    secret, zeros = _rand_zeros(lin, rng, w + 10)

    inc = IncrementalSolver(lin, zeros[: w // 3])
    inc.add(zeros[w // 3 : w // 2])
    inc.add(zeros[w // 2 :])

    got_rows, got_pof = _dense_state(inc)
    want_rows, want_pof, bad = _fresh_state(lin, zeros, w)
    assert not bad and not inc.unsat
    # pad the narrower matrix (fresh elimination may use fewer words)
    ww = max(got_rows.shape[1], want_rows.shape[1])
    got_rows = np.pad(got_rows, ((0, 0), (0, ww - got_rows.shape[1])))
    want_rows = np.pad(want_rows, ((0, 0), (0, ww - want_rows.shape[1])))
    assert np.array_equal(got_rows, want_rows)
    # pof row INDICES legitimately differ (incremental pivots land in the
    # slack region); the pivot-column SET and each column's row content
    # must agree
    assert np.array_equal(got_pof >= 0, want_pof >= 0)
    gm, wm = np.asarray(inc._M), None
    eqs = lin.get_eqs_packed(zeros)
    a32 = _pad(eqs, 128, word_align=128)
    wm = np.asarray(rref_blocked(jnp.asarray(a32), w, 128)[0])
    for c in np.nonzero(want_pof >= 0)[0]:
        g = gm[got_pof[c]][: wm.shape[1]]
        assert np.array_equal(g, wm[want_pof[c]][: g.shape[0]])
    assert inc.solve_one() == (secret,)
    assert inc.rank == int((want_pof >= 0).sum())


def test_incremental_dimension_collapses_and_space():
    rng = np.random.default_rng(7)
    w = 64
    lin = LinearSystem([w])
    secret, zeros = _rand_zeros(lin, rng, w + 8)

    inc = IncrementalSolver(lin, zeros[: w - 10])
    dims = [inc.dimension]
    for k in range(w - 10, len(zeros), 4):
        inc.add(zeros[k : k + 4])
        dims.append(inc.dimension)
    assert dims[0] > dims[-1] == 0  # the space collapses to a point
    assert all(a >= b for a, b in zip(dims, dims[1:]))

    sp = inc.solve_raw_space()
    assert sp.dimension == 0 and sp.get(0) == inc.solve_raw_one()

    # mid-way space must equal the oracle's space
    inc2 = IncrementalSolver(lin, zeros[: w - 10])
    sp2 = inc2.solve_raw_space()
    ref = solve_oracle(lin.get_eqs_packed(zeros[: w - 10]), w)
    assert sp2.dimension == len(ref.basis)
    assert packing.words_to_int(sp2.origin) == packing.words_to_int(
        ref.origin
    )


def test_incremental_unsat_detection():
    lin = LinearSystem([16])
    (x,) = lin.gens(lazy=False)
    inc = IncrementalSolver(lin, [x ^ 0x1234])
    assert not inc.unsat and inc.solve_one() == (0x1234,)
    inc.add([x ^ 0x1235])  # contradicts bit 0
    assert inc.unsat and inc.solve_one() is None
    # adds after unsat stay unsat
    inc.add([x ^ 0x1234])
    assert inc.unsat


def test_incremental_from_empty_and_redundant_adds():
    rng = np.random.default_rng(17)
    w = 40
    lin = LinearSystem([w])
    secret, zeros = _rand_zeros(lin, rng, w + 6)

    inc = IncrementalSolver(lin)  # empty start: dimension = w
    assert inc.dimension == w and inc.rank == 0
    inc.add(zeros)
    assert inc.solve_one() == (secret,)
    r = inc.rank
    inc.add(zeros[:5])  # redundant rows must not change anything
    assert inc.rank == r and inc.solve_one() == (secret,)


def test_incremental_capacity_growth():
    rng = np.random.default_rng(23)
    w = 32
    lin = LinearSystem([w])
    secret, zeros = _rand_zeros(lin, rng, 64)
    inc = IncrementalSolver(lin, zeros[:4], slack=128)
    cap0 = inc._M.shape[0]
    for k in range(4, 64, 8):
        inc.add(zeros[k : k + 8])
    assert inc._M.shape[0] >= cap0  # grew (or sliced in) without breakage
    assert inc.solve_one() == (secret,)


def test_incremental_from_packed_matches_system_path():
    rng = np.random.default_rng(31)
    w = 96
    lin = LinearSystem([w])
    secret, zeros = _rand_zeros(lin, rng, w + 6)

    eqs_a = lin.get_eqs_packed(zeros[:40])
    eqs_b = lin.get_eqs_packed(zeros[40:])
    inc = IncrementalSolver.from_packed(eqs_a, w)
    inc.add_packed(eqs_b)

    ref = IncrementalSolver(lin, zeros[:40]).add(zeros[40:])
    assert inc.rank == ref.rank and not inc.unsat
    assert inc.solve_raw_one() == ref.solve_raw_one()
    with pytest.raises(TypeError):
        inc.solve_one()

def test_incremental_add_after_unsat_init_keeps_rref_exact():
    """A 0=1 row in the INITIAL matrix (solver born unsat) must not corrupt
    the maintained RREF on later adds: pcol's -1 slots may never select the
    affine column during the reduce pass (regression: pcol+1 == 0 read
    bit 0 and XORed the contradiction row into new equations)."""
    rng = np.random.default_rng(77)
    w = 64
    lin = LinearSystem([w])
    _, zeros = _rand_zeros(lin, rng, 30)

    eqs = lin.get_eqs_packed(zeros[:12])
    contradiction = np.zeros((1, eqs.shape[1]), np.uint64)
    contradiction[0, 0] = 1  # the literal 0=1 row
    init = np.concatenate([eqs, contradiction], axis=0)

    inc = IncrementalSolver.from_packed(init, w)
    assert inc.unsat
    inc.add_packed(lin.get_eqs_packed(zeros[12:]))
    assert inc.unsat and inc.solve_raw_one() is None

    # the maintained matrix must still be the unique RREF of everything
    ref = IncrementalSolver.from_packed(
        np.concatenate([init, lin.get_eqs_packed(zeros[12:])], axis=0), w
    )
    got_rows, got_pof = _dense_state(inc)
    want_rows, want_pof = _dense_state(ref)
    assert np.array_equal(got_rows, want_rows)
    # pof row INDICES legitimately differ (incremental pivots land in the
    # slack region); the pivot-column SET must agree
    assert np.array_equal(got_pof >= 0, want_pof >= 0)
    assert inc.rank == ref.rank
