"""Batched blocked solvers (ops/gauss_batched.py) vs the single-system
solver.  RREF is unique, so every per-instance output must be
bit-identical."""

import numpy as np
import pytest

import jax.numpy as jnp

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import gauss_batched
from gf2bv_tpu.ops.gauss_blocked import _pad, rref_blocked, solve_blocked


def _systems(rng, B, rows, cols, with_unsat=False):
    mats = []
    for _ in range(B):
        bits = rng.integers(0, 2, size=(rows, 1 + cols), dtype=np.uint8)
        bits[rows - 4 :] = bits[:4]  # rank deficiency
        mats.append(packing.pack_bits(bits, 1 + cols))
    if with_unsat:
        bits = rng.integers(0, 2, size=(rows, 1 + cols), dtype=np.uint8)
        bits[10] = bits[11]
        bits[10, 0] ^= 1  # contradictory pair
        mats.append(packing.pack_bits(bits, 1 + cols))
    return mats


def test_batched_rref_matches_single():
    rng = np.random.default_rng(23)
    mats = _systems(rng, 3, 300, 200)
    a32s = [_pad(m, 256, word_align=128) for m in mats]
    a = jnp.asarray(np.stack(a32s))
    r_b, pof_b, inc_b = gauss_batched.rref_blocked_batched(a, 200)
    for b, a32 in enumerate(a32s):
        r1, pof1, inc1 = rref_blocked(jnp.asarray(a32), 200)
        assert np.array_equal(np.asarray(r_b)[b], np.asarray(r1))
        assert np.array_equal(np.asarray(pof_b)[b], np.asarray(pof1))
        assert bool(np.asarray(inc_b)[b]) == bool(inc1)


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_batched_matches_solve_blocked(mode):
    rng = np.random.default_rng(29)
    mats = _systems(rng, 3, 280, 190, with_unsat=True)
    got = gauss_batched.solve_batched(mats, 190, mode)
    assert len(got) == len(mats)
    saw_unsat = False
    for g, m in zip(got, mats):
        want = solve_blocked(m, 190, mode)
        if want is None:
            assert g is None
            saw_unsat = True
        elif mode == 0:
            assert np.array_equal(g, want)
        else:
            assert np.array_equal(g[0], want[0])
            assert np.array_equal(g[1], want[1])
    assert saw_unsat  # the planted contradiction must be detected


def test_solve_chained_matches_solve_blocked():
    rng = np.random.default_rng(31)
    mats = _systems(rng, 3, 280, 190, with_unsat=True)
    got = gauss_batched.solve_chained(mats, 190)
    assert len(got) == len(mats)
    saw_unsat = False
    for g, m in zip(got, mats):
        want = solve_blocked(m, 190, 0)
        if want is None:
            assert g is None
            saw_unsat = True
        else:
            assert np.array_equal(g, want)
    assert saw_unsat


def test_solve_batch_routes_wide_mode0_to_chained(monkeypatch):
    """parallel.batch.solve_batch must send mode-0 batches at or above the
    per-pivot crossover through the chained-scan path.  The real constant
    is 2048; it is patched down so the routing logic is exercised at a
    CI-sized shape."""
    from gf2bv_tpu.parallel import batch as pbatch

    monkeypatch.setattr(pbatch, "_PER_PIVOT_MAX_COLS", 190)
    rng = np.random.default_rng(37)
    cols = 190
    mats = _systems(rng, 2, cols + 60, cols)
    called = {}

    real = gauss_batched.solve_chained

    def spy(eq_mats, c, **kw):
        called["n"] = len(eq_mats)
        return real(eq_mats, c, **kw)

    monkeypatch.setattr(gauss_batched, "solve_chained", spy)
    got = pbatch.solve_batch(mats, cols, 0)
    assert called.get("n") == len(mats)
    for g, m in zip(got, mats):
        want = solve_blocked(m, cols, 0)
        assert (g is None) == (want is None)
        if want is not None:
            assert np.array_equal(g, want)


@pytest.mark.parametrize("nb,rows,cols", [(1, 200, 120), (6, 200, 120), (3, 330, 300)])
def test_lax_map_mode1_matches_single(nb, rows, cols):
    """Mode-1 batches run as a lax.map of the single-system RREF plus one
    batched extraction: every (origin, basis) equals its single solve, and
    the planted contradiction comes back None."""
    rng = np.random.default_rng(41 + nb + cols)
    mats = _systems(rng, nb, rows, cols, with_unsat=True)
    got = gauss_batched.solve_batched(mats, cols, 1)
    assert len(got) == len(mats)
    assert got[-1] is None
    for g, m in zip(got, mats):
        want = solve_blocked(m, cols, 1)
        if want is None:
            assert g is None
        else:
            assert np.array_equal(g[0], want[0])
            assert np.array_equal(g[1], want[1])
