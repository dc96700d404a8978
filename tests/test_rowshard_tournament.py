"""Tournament-pivoting sharded solver: the final RREF is unique, so origin
and kernel basis must match the single-chip solver bit-for-bit on the
8-device virtual CPU mesh."""

import numpy as np
import pytest

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import solver
from gf2bv_tpu.parallel import mesh as meshlib
from gf2bv_tpu.parallel.rowshard_tournament import solve_rowsharded_tournament

from test_solver import random_system


@pytest.fixture(scope="module")
def mesh_rows():
    return meshlib.make_mesh(batch=1, rows=8)


@pytest.mark.parametrize(
    "rows,cols,deficit",
    [(64, 48, 0), (48, 60, 5), (200, 150, 7)],
)
def test_tournament_matches_single(mesh_rows, rows, cols, deficit):
    rng = np.random.default_rng(2000 + rows + cols)
    eqs, _ = random_system(rng, rows, cols, rank_deficit=deficit)

    single = solver.solve(eqs, cols, 1, backend="jax")
    sharded = solve_rowsharded_tournament(eqs, cols, 1, mesh_rows, k_panel=64)
    assert (sharded is None) == (single is None)
    origin, basis = sharded
    assert packing.words_to_int(origin) == single.origin
    assert packing.rows_to_ints(basis) == list(single.basis)


def test_tournament_inconsistent(mesh_rows):
    rng = np.random.default_rng(5)
    eqs, _ = random_system(rng, 40, 32, inconsistent=True)
    assert solve_rowsharded_tournament(eqs, 32, 0, mesh_rows, k_panel=64) is None


def test_tournament_cross_shard_pivots(mesh_rows):
    """Columns whose only nonzero rows live in late shards force the merged
    scan to pick pivots across shard boundaries."""
    rng = np.random.default_rng(9)
    cols = 96
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = np.zeros((2048, cols), dtype=np.uint8)
    # shard i (256 rows each on the padded 2048-row block) covers only
    # columns [12*i, 96): early columns exist ONLY in early shards and each
    # shard is needed for full rank
    for i in range(8):
        rows_i = slice(256 * i, 256 * i + 32)
        coeff[rows_i, 12 * i :] = rng.integers(0, 2, size=(32, cols - 12 * i))
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)

    single = solver.solve(eqs, cols, 1, backend="oracle")
    sharded = solve_rowsharded_tournament(eqs, cols, 1, mesh_rows, k_panel=64)
    assert (sharded is None) == (single is None)
    origin, basis = sharded
    assert packing.words_to_int(origin) == single.origin
    assert packing.rows_to_ints(basis) == list(single.basis)


def test_solve_sharded_facade(mesh_rows):
    from gf2bv_tpu.parallel import solve_sharded

    rng = np.random.default_rng(12)
    eqs, _ = random_system(rng, 64, 48)
    want = solver.solve(eqs, 48, 0, backend="oracle")
    got = solve_sharded(eqs, 48, 0, mesh_rows, k_panel=64)
    assert packing.words_to_int(got) == want
    # single-device rows axis routes to the blocked kernel
    mesh1 = meshlib.make_mesh(batch=8, rows=1)
    got1 = solve_sharded(eqs, 48, 0, mesh1, k_panel=64)
    assert packing.words_to_int(got1) == want


@pytest.mark.parametrize("deficit,unsat", [(0, False), (5, False), (0, True)])
def test_tournament_fused_mode0(mesh_rows, deficit, unsat):
    """Fused mode-0 path (trailing update + in-kernel origin + psum'd
    verification) must agree with the oracle, incl. unsat detection."""
    rng = np.random.default_rng(3000 + deficit + unsat)
    eqs, _ = random_system(rng, 96, 70, rank_deficit=deficit, inconsistent=unsat)
    got = solve_rowsharded_tournament(eqs, 70, 0, mesh_rows, k_panel=64)
    want = solver.solve(eqs, 70, 0, backend="oracle")
    if want is None:
        assert got is None
    else:
        assert packing.words_to_int(got) == want


@pytest.mark.parametrize("mode", [0, 1])
def test_tournament_underdetermined_multishard_pivots(mesh_rows, mode):
    """Round-4 regression: gathering locally-ELIMINATED candidates (instead
    of the raw elected rows) silently dropped matrix rank whenever a local
    elimination combo involved a slot that lost the merged election —
    underdetermined systems around 2000 cols lost pivots and mode 0
    reported false unsat.  Pin an affected shape (rows < cols, multiple
    panels, pivots owned across all 8 shards)."""
    rng = np.random.default_rng(11)
    cols, rows = 1700, 1636
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    eqs = packing.pack_bits(
        np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols
    )
    want = solver.solve(eqs, cols, mode, backend="oracle")
    got = solve_rowsharded_tournament(eqs, cols, mode, mesh_rows)
    assert want is not None and got is not None
    if mode == 0:
        assert packing.words_to_int(got) == want
    else:
        assert packing.words_to_int(got[0]) == want.origin
        assert packing.rows_to_ints(got[1]) == list(want.basis)
