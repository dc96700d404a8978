"""Phase-2 rank-K update engines and the solver levels above them.

The Triton kernel (ops/triton_update.py) runs here in Pallas interpret
mode against the jnp formulation and a plain numpy reference; the solver-
level cases run the blocked solver against the oracle (RREF is unique, so
origins and bases must agree bit for bit).  The compiled kernel runs on
the GPU in chip_smoke.py."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import gauss_blocked, triton_update
from gf2bv_tpu.ops.gauss_blocked import rank_k_update_jnp, solve_blocked
from gf2bv_tpu.ops.gauss_ref import solve_oracle
from gf2bv_tpu.ops.triton_update import rank_k_update_triton

from test_solver import random_system


def ref_update(a, sel, pf):
    rows, wp = a.shape
    k = pf.shape[0]
    out = a.copy()
    for i in range(rows):
        s = 0
        for w in range(sel.shape[1]):
            s |= int(sel[i, w]) << (32 * w)
        for jj in range(k):
            if (s >> jj) & 1:
                out[i] ^= pf[jj]
    return out


def _operands(seed, rows, wp, k):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, k // 32), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(k, wp), dtype=np.uint32)
    return a, sel, pf


@pytest.fixture
def triton_interpret(monkeypatch):
    """Route the solver's Triton engine through Pallas interpret mode."""
    monkeypatch.setattr(
        triton_update,
        "rank_k_update_triton",
        functools.partial(rank_k_update_triton, interpret=True),
    )


@pytest.mark.parametrize("rows,wp,k", [(256, 128, 128), (512, 256, 64)])
def test_panel_update_interpret(rows, wp, k):
    a, sel, pf = _operands(rows + wp + k, rows, wp, k)
    got = np.asarray(
        rank_k_update_triton(
            jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), interpret=True
        )
    )
    assert np.array_equal(got, ref_update(a, sel, pf))


@pytest.mark.parametrize("rows,wp,k", [(64, 8, 64), (256, 128, 256)])
def test_jnp_update_matches_reference(rows, wp, k):
    a, sel, pf = _operands(rows * k, rows, wp, k)
    got = np.asarray(
        rank_k_update_jnp(jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf))
    )
    assert np.array_equal(got, ref_update(a, sel, pf))


@pytest.mark.parametrize("w0_tiles", [0.5, 2.25, 4])
def test_triton_update_trailing_interpret(w0_tiles):
    """Trailing mode: column tiles wholly left of w0 keep their contents,
    except the first tile (the const word 0), which is updated like every
    tile at or right of the panel."""
    tw = triton_update.TW
    a, sel, pf = _operands(13, 2 * triton_update.TR, 6 * tw, 64)
    full = np.asarray(
        rank_k_update_jnp(jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf))
    )
    w0 = int(w0_tiles * tw)
    got = np.asarray(
        rank_k_update_triton(
            jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), jnp.int32(w0),
            interpret=True,
        )
    )
    live = max(w0 // tw * tw, tw)  # first word of the first live tile past 0
    assert np.array_equal(got[:, :tw], full[:, :tw])  # tile 0: updated
    assert np.array_equal(got[:, tw:live], a[:, tw:live])  # dead: skipped
    assert np.array_equal(got[:, live:], full[:, live:])  # live


@pytest.mark.parametrize(
    "shape,fits",
    [
        ((20224, 640), True),
        ((256, 8), False),
        ((triton_update.TR * 3 // 2, triton_update.TW), False),
    ],
)
def test_triton_tiling_predicate(shape, fits):
    assert triton_update.tiles(shape) == fits


def test_engine_choice(monkeypatch):
    """default_phase2 is the jnp engine off the GPU; an explicit "triton"
    request takes the kernel only on shapes it tiles; unknown names raise."""
    assert jax.default_backend() == "cpu"
    assert gauss_blocked.default_phase2() == "jnp"
    calls = []

    def spy(a, s, pf, w0=None):
        calls.append(a.shape)
        return rank_k_update_triton(a, s, pf, w0, interpret=True)

    monkeypatch.setattr(triton_update, "rank_k_update_triton", spy)
    a, sel, pf = _operands(3, 64, 128, 64)
    want = ref_update(a, sel, pf)
    for shape_a, engine, n_calls in (
        (a, "jnp", 0), (a, "triton", 1), (a[: triton_update.TR // 2], "triton", 1),
    ):
        got = gauss_blocked.apply_rank_k_update(
            jnp.asarray(shape_a), jnp.asarray(sel[: len(shape_a)]),
            jnp.asarray(pf), phase2=engine,
        )
        assert np.array_equal(np.asarray(got), want[: len(shape_a)])
        assert len(calls) == n_calls
    with pytest.raises(ValueError):
        gauss_blocked.apply_rank_k_update(
            jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), phase2="mxu"
        )


def _planted(seed, rows, cols, dep):
    """Consistent random system whose last ``dep`` rows repeat the first."""
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    if dep:
        coeff[rows - dep :] = coeff[:dep]
    rhs = (coeff @ secret) % 2
    return packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)


def _deficit_shape():
    """More rows than one scan window where the first rows only touch the
    first 8 columns and the tail rows carry the rest: the late columns'
    pivots sit far down the matrix."""
    rng = np.random.default_rng(99)
    cols, head = 40, 768 + 32
    rows = head + 32
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = np.zeros((rows, cols), dtype=np.uint8)
    coeff[:head, :8] = rng.integers(0, 2, size=(head, 8))
    coeff[head:, :] = rng.integers(0, 2, size=(32, cols))
    rhs = (coeff @ secret) % 2
    return packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)


_SOLVER_CASES = {
    "rank_deficit_80x70": lambda: random_system(
        np.random.default_rng(3), 80, 70, rank_deficit=4)[0],
    "rank_deficit_90x75": lambda: random_system(
        np.random.default_rng(7), 90, 75, rank_deficit=5)[0],
    "dup10_150x75": lambda: _planted(21, 150, 75, 10),
    "dup5_150x75": lambda: _planted(41, 150, 75, 5),
    "dup5_300x200": lambda: _planted(42, 300, 200, 5),
    "dup5_150x75_b": lambda: _planted(51, 150, 75, 5),
    "dup5_300x200_b": lambda: _planted(52, 300, 200, 5),
    "dup10_150x75_b": lambda: _planted(31, 150, 75, 10),
    "full_300x200": lambda: _planted(32, 300, 200, 0),
    "deficit_fallback_832x40": _deficit_shape,
    "full_150x75": lambda: _planted(45, 150, 75, 0),
    "dup6_300x200": lambda: _planted(61, 300, 200, 6),
    "rank_deficit_100x80": lambda: random_system(
        np.random.default_rng(62), 100, 80, rank_deficit=3)[0],
}


@pytest.mark.parametrize("case", sorted(_SOLVER_CASES))
def test_blocked_solver_jnp_vs_oracle(case):
    eqs = _SOLVER_CASES[case]()
    cols = int(case.split("x")[-1].split("_")[0])
    ref = solve_oracle(eqs, cols)
    origin, basis = solve_blocked(eqs, cols, 1, phase2="jnp")
    assert packing.words_to_int(origin) == packing.words_to_int(ref.origin)
    assert packing.rows_to_ints(basis) == packing.rows_to_ints(ref.basis)


@pytest.mark.parametrize("seed,rows,cols", [(5, 40, 30), (6, 300, 200), (7, 96, 250)])
def test_phase1_panel_vs_oracle(seed, rows, cols):
    """One panel covering every column: phase 1's pivot rows are the whole
    RREF, so its nonzero rows (in panel-column order) are the oracle's."""
    from gf2bv_tpu.ops.gauss_ref import rref_packed

    eqs, _ = random_system(np.random.default_rng(seed), rows, cols, rank_deficit=3)
    a32 = gauss_blocked._pad(eqs, 256)
    assert a32.shape[1] == 8  # one 256-bit panel
    a = jnp.asarray(a32)
    pf, prow, used = gauss_blocked.phase1_panel(
        a, a, jnp.zeros((a32.shape[0],), bool), 0, 256, cols
    )
    pf, prow, used = map(np.asarray, (pf, prow, used))
    rref, pivots = rref_packed(eqs, 1 + cols)
    want = packing.to_u32(rref[: len(pivots)])
    got = pf[prow >= 0][:, : want.shape[1]]
    assert np.array_equal(got, want)
    assert np.flatnonzero(prow >= 0).tolist() == pivots  # bit j = column j
    assert sorted(np.flatnonzero(used).tolist()) == sorted(prow[prow >= 0].tolist())


@pytest.mark.parametrize("engine", ["jnp", "triton"])
def test_trailing_solve_e2e_interpret(engine, triton_interpret):
    """End-to-end mode-0 solve through rref_origin_blocked at a width where
    the trailing kernel skips tiles, against the oracle; plus the unsat
    verdict through the parity verification."""
    cols = 12300  # wp pads to 512 words -> later panels skip dead tiles
    rows = 320
    rng = np.random.default_rng(3)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)

    a32 = gauss_blocked._pad(eqs, 256, word_align=128)
    origin32, unsat = gauss_blocked.rref_origin_blocked(
        jnp.asarray(a32), cols, 256, engine
    )
    assert not bool(unsat)
    ref = solve_oracle(eqs, cols, mode=0)
    got = packing.words_to_int(packing.from_u32(np.asarray(origin32)[None, :])[0])
    assert got == packing.words_to_int(ref.origin)

    # unsat variant: duplicate a row with flipped RHS
    bits2 = bits.copy()
    bits2[-1] = bits2[0]
    bits2[-1, 0] ^= 1
    a32 = gauss_blocked._pad(packing.pack_bits(bits2, 1 + cols), 256, word_align=128)
    _, unsat2 = gauss_blocked.rref_origin_blocked(jnp.asarray(a32), cols, 256, engine)
    assert bool(unsat2)


@pytest.mark.parametrize("engine", ["jnp", "triton"])
def test_blocked_mode0_two_tiles_vs_oracle(engine, triton_interpret):
    """Fused mode-0 at 256 words (later panels skip the dead tiles between
    tile 0 and the panel), with a planted unsat."""
    rng = np.random.default_rng(77)
    cols = 8190
    rows = 300
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    coeff[rows - 4 :] = coeff[:4]  # dependent rows
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1).astype(np.uint8)
    eqs = packing.pack_bits(bits, 1 + cols)
    a32 = gauss_blocked._pad(eqs, 256, word_align=128)
    assert a32.shape[1] == 256

    origin32, unsat = jax.device_get(
        gauss_blocked.rref_origin_blocked(jnp.asarray(a32), cols, 256, engine)
    )
    assert not bool(unsat)
    ref = solve_oracle(eqs, cols, mode=0)
    assert packing.words_to_int(
        packing.from_u32(origin32[None, :])[0]
    ) == packing.words_to_int(ref.origin)

    bits_bad = np.concatenate([bits, bits[:1]], axis=0)
    bits_bad[-1, 0] ^= 1
    a32b = gauss_blocked._pad(packing.pack_bits(bits_bad, 1 + cols), 256, word_align=128)
    _, unsat_b = jax.device_get(
        gauss_blocked.rref_origin_blocked(jnp.asarray(a32b), cols, 256, engine)
    )
    assert bool(unsat_b)


def test_triton_engine_full_rref_interpret(triton_interpret):
    """Mode-1 blocked RREF through the Triton engine (no trailing skip)
    equals the jnp engine's matrix, pivot map and verdict."""
    eqs = _planted(61, 300, 200, 6)
    a = jnp.asarray(gauss_blocked._pad(eqs, 128, word_align=128))
    got = gauss_blocked.rref_blocked(a, 200, 128, "triton")
    want = gauss_blocked.rref_blocked(a, 200, 128, "jnp")
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
