"""Mesh-sharded multi-RHS (parallel/multi_rhs_sharded.py) vs the
single-device path.  RREF is unique and the coefficient matrix is shared,
so per-instance origins/unsat and the mode-1 basis must be bit-identical;
the design claims ZERO collectives (replicated matrix, sharded instances),
which the HLO test pins."""

import numpy as np
import pytest

import jax

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import multi_rhs
from gf2bv_tpu.parallel import mesh as meshlib
from gf2bv_tpu.parallel.multi_rhs_sharded import solve_multi_rhs_sharded

COLS = 300


def _structure(rng, rows=340):
    bits = rng.integers(0, 2, size=(rows, 1 + COLS), dtype=np.uint8)
    bits[rows - 3 :] = bits[:3]  # slight rank deficiency
    a = packing.pack_bits(bits, 1 + COLS)
    from gf2bv_tpu.ops.gauss_blocked import _pad

    return bits, _pad(a, 256, word_align=128)


def _instances(rng, bits, nb):
    """Per-instance affine columns: random solutions -> consistent rhs,
    with a few planted unsats."""
    rows = bits.shape[0]
    rhs = np.zeros((nb, rows), np.uint8)
    for k in range(nb):
        x = rng.integers(0, 2, size=COLS).astype(np.uint8)
        rhs[k] = (bits[:, 1:] @ x) % 2
        if k % 7 == 3:  # planted unsat: flip one duplicated row's bit
            rhs[k, rows - 1] ^= 1
    return rhs


@pytest.mark.parametrize("mode", [0, 1])
def test_sharded_matches_single_device(mode):
    rng = np.random.default_rng(0x5A5)
    bits, a32 = _structure(rng)
    nb = 41  # uneven over 8 devices: 6 per device, trailing shard short
    rhs = _instances(rng, bits, nb)

    mesh = meshlib.make_mesh(batch=jax.device_count(), rows=1)
    got = solve_multi_rhs_sharded(a32, COLS, rhs, mode, mesh=mesh)
    want = multi_rhs.solve_multi_rhs(a32, COLS, rhs, mode)
    assert len(got) == len(want) == nb
    saw_unsat = saw_sat = False
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            saw_unsat = True
        elif mode == 0:
            assert g == w
            saw_sat = True
        else:
            assert np.array_equal(g.origin, w.origin)
            assert np.array_equal(g.basis, w.basis)
            saw_sat = True
    assert saw_unsat and saw_sat


def test_sharded_mode1_shares_one_basis():
    rng = np.random.default_rng(0x7B1)
    # UNDERdetermined (rows < cols) so the kernel basis is non-empty and
    # the sharing claim is non-vacuous
    bits, a32 = _structure(rng, rows=280)
    rhs = _instances(rng, bits, 17)
    mesh = meshlib.make_mesh(batch=jax.device_count(), rows=1)
    cache: dict = {}
    got = solve_multi_rhs_sharded(
        a32, COLS, rhs, 1, mesh=mesh, basis_cache=cache
    )
    assert "basis" in cache  # built once, via the caller-held cache
    for sp in got:
        if sp is not None:  # every space aliases the one shared buffer
            assert np.shares_memory(sp._basis, cache["basis"])


def test_sharded_solver_emits_no_collectives():
    """The scaling claim is structural: replicated matrix + sharded
    instances need NO cross-device communication.  Compile the kernel and
    assert the HLO contains no collective ops at all."""
    from gf2bv_tpu.parallel import multi_rhs_sharded as mrs

    mesh = meshlib.make_mesh(batch=jax.device_count(), rows=1)
    rng = np.random.default_rng(1)
    _, a32 = _structure(rng)
    rows_pad, wp = a32.shape
    bw_d = 1
    fn = mrs._build(mesh, COLS, wp, bw_d, 256)
    import jax.numpy as jnp

    rhs = jnp.zeros((rows_pad, mesh.shape[meshlib.BATCH_AXIS] * bw_d),
                    jnp.uint32)
    hlo = fn.lower(jnp.asarray(a32), rhs).compile().as_text()
    for op in ("all-gather", "all-reduce", "collective-permute",
               "reduce-scatter", "all-to-all"):
        assert op not in hlo, f"unexpected collective {op} in sharded HLO"


def test_sharded_rejects_rows_mesh():
    rng = np.random.default_rng(2)
    bits, a32 = _structure(rng)
    rhs = _instances(rng, bits, 4)
    if jax.device_count() < 2:
        pytest.skip("needs >= 2 devices")
    mesh = meshlib.make_mesh(batch=jax.device_count() // 2, rows=2)
    with pytest.raises(ValueError, match="batch axis"):
        solve_multi_rhs_sharded(a32, COLS, rhs, 0, mesh=mesh)


def test_captured_batch_routes_through_mesh():
    """CapturedTrace.solve_raw_batch(mesh=...) == the unsharded batch,
    end-to-end through the public capture/bind surface."""
    import random

    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.crypto.lfsr import GaloisLFSR

    WIDTH, TAPS = 48, (1 << 47) | (1 << 20) | 0b1011
    lin = LinearSystem([WIDTH])

    def model(gens, p):
        (x,) = gens
        sym = GaloisLFSR(WIDTH, TAPS, x)
        return [sym() ^ p[i] for i in range(60)]

    tmpl = lin.capture(model)
    batch = []
    for k in range(11):
        key = random.Random(900 + k).getrandbits(WIDTH) | 1
        s = GaloisLFSR(WIDTH, TAPS, key)
        batch.append([s() for _ in range(60)])

    mesh = meshlib.make_mesh(batch=jax.device_count(), rows=1)
    got = tmpl.solve_raw_batch(batch, 0, mesh=mesh)
    want = tmpl.solve_raw_batch(batch, 0)
    assert got == want
    assert sum(r is not None for r in got) == len(batch)


def test_sweep_routes_through_mesh():
    """solve_one_sweep(mesh=...) == the unsharded sweep, end-to-end
    through the public API (candidates sharded, direct-packed blocks)."""
    import random

    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.crypto.lfsr import GaloisLFSR

    WIDTH, TAPS = 56, (1 << 55) | (1 << 23) | 0b1011
    key = random.Random(77).getrandbits(WIDTH) | 1
    stream = GaloisLFSR(WIDTH, TAPS, key)
    observed = [stream() for _ in range(50)]

    lin = LinearSystem([WIDTH])
    (x,) = lin.gens()
    sym = GaloisLFSR(WIDTH, TAPS, x)
    zeros = [sym() ^ o for o in observed]
    guesses = [x[i] for i in range(WIDTH - 7, WIDTH)]  # 128 candidates

    mesh = meshlib.make_mesh(batch=jax.device_count(), rows=1)
    got = lin.solve_one_sweep(zeros, guesses, mesh=mesh)
    want = lin.solve_one_sweep(zeros, guesses)
    assert got == want
    assert any(s is not None and s[0] == key for s in got)
