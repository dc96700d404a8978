"""CPU-only hosts auto-route to the native C engine.

On a box whose JAX is pinned to the host CPU (no accelerator), ``auto``
backend resolution prefers the native M4R-family engine — XLA's CPU code
for the device paths is 1-2 orders of magnitude slower there.  The
suite at large keeps GF2BV_TPU_CPU_NATIVE=0 (conftest) so the device code
paths stay covered on the virtual mesh; these tests exercise the routing
knob and the native lazy fast path explicitly.  RREF uniqueness makes every
backend bit-comparable (the repo-wide test pattern).
"""

import numpy as np
import pytest

from gf2bv_tpu import LinearSystem, QuadraticSystem, _native
from gf2bv_tpu.ops import lazy_solve, solver

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="no native engine (gcc missing)"
)


@pytest.fixture
def cpu_native(monkeypatch):
    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "1")
    yield
    lazy_solve.clear_cache()


def _trace(sys_):
    x, y = sys_.gens()
    return [
        (x ^ (x >> 7) ^ (x << 13) ^ y.zeroext(31)) ^ 0xDEADBEEF12345,
        (y ^ (y << 3) ^ (y >> 11)) ^ 0x1CE,
    ]


def test_auto_prefers_native_on_cpu(cpu_native):
    # conftest pins jax_platforms="cpu", so _cpu_pinned() is True here
    assert solver._resolve_backend(None, 50) == "native"
    assert solver._resolve_backend(None, 50_000) == "native"
    assert solver._resolve_backend("auto", 50) == "native"
    # explicit backends are never overridden
    assert solver._resolve_backend("jax", 50) == "jax"
    assert solver._resolve_backend("blocked", 50) == "blocked"


def test_auto_knob_off(monkeypatch):
    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "0")
    assert solver._resolve_backend(None, 50) == "jax"
    assert solver._resolve_backend(None, 50_000) == "blocked"


def test_lazy_native_matches_jax_modes(cpu_native):
    s_nat = LinearSystem([64, 33])
    s_jax = LinearSystem([64, 33], backend="jax")
    z_nat, z_jax = _trace(s_nat), _trace(s_jax)

    assert lazy_solve._backend_for(s_nat) == "native"
    r_nat = s_nat.solve_raw_one(z_nat)
    r_jax = s_jax.solve_raw_one(z_jax)
    assert r_nat == r_jax and r_nat is not None

    a_nat = s_nat.solve_raw_space(z_nat)
    a_jax = s_jax.solve_raw_space(z_jax)
    assert a_nat.dimension == a_jax.dimension
    assert a_nat.origin == a_jax.origin
    assert sorted(a_nat.basis) == sorted(a_jax.basis)

    # second mode-1 solve of the same structure reuses the cached basis
    cs = lazy_solve.cached_system(s_nat, z_nat)
    assert "basis" in cs.basis_cache
    a_nat2 = s_nat.solve_raw_space(z_nat)
    assert a_nat2.basis == a_nat.basis and a_nat2.origin == a_nat.origin


def test_lazy_native_literal_one_unsat(cpu_native):
    s = LinearSystem([16])
    (x,) = s.gens()
    zeros = [x ^ (x >> 5) ^ 3, (x ^ x) ^ 1]  # second row is the literal 1
    assert s.solve_raw_one(zeros) is None
    assert s.solve_raw_space(zeros) is None


def test_lazy_native_unsat_rank(cpu_native):
    # contradictory equations that survive the literal-1 early-out and
    # must be caught by the elimination itself (mode-0 parity verification)
    s = LinearSystem([8])
    (x,) = s.gens()
    zeros = [x ^ 0x55, x ^ 0xAA]  # x == 0x55 and x == 0xAA
    assert s.solve_raw_one(zeros) is None
    assert s.solve_raw_space(zeros) is None


def test_captured_native_batch(cpu_native):
    import secrets

    s = LinearSystem([64])
    tmpl = s.capture(
        lambda gens, p: [
            (gens[0] ^ (gens[0] >> 9) ^ (gens[0] << 21)) ^ p[0]
        ]
    )
    cs = lazy_solve.cached_system(s, tmpl.zeros)
    assert cs.backend == "native" and cs.a_dev is None

    secrets_ = [secrets.randbits(64) for _ in range(9)]

    def outs(v):
        return [(v ^ (v >> 9) ^ (v << 21)) & ((1 << 64) - 1)]

    batch = tmpl.solve_raw_batch([outs(v) for v in secrets_], mode=0)
    singles = [tmpl.solve_raw_one(outs(v)) for v in secrets_]
    assert batch == singles
    spaces = tmpl.solve_raw_batch([outs(v) for v in secrets_], mode=1)
    for sp, r in zip(spaces, singles):
        assert sp is not None and sp.origin == r  # full-rank: origin == sol


def test_batch_systems_host_route(cpu_native):
    # solve_batch_systems loops host engines per system (no stacked device
    # program); results must match the device-vmapped route bit-for-bit
    from gf2bv_tpu.parallel.batch import solve_batch_systems

    def zeros_batch(S):
        x, = S.gens()
        return [
            [(x ^ (x >> 3) ^ (x << 7)) ^ (0xA5A5 + 17 * k)] for k in range(5)
        ] + [[(x ^ x) ^ 1]]  # literal-1 instance -> None

    s_nat = LinearSystem([48])
    s_jax = LinearSystem([48], backend="jax")
    for mode in (0, 1):
        got = solve_batch_systems(s_nat, zeros_batch(s_nat), mode=mode)
        want = solve_batch_systems(s_jax, zeros_batch(s_jax), mode=mode)
        assert got[-1] is None and want[-1] is None
        assert any(g is not None for g in got[:-1])
        for g, w in zip(got[:-1], want[:-1]):
            assert (g is None) == (w is None)
            if g is None:
                continue
            if mode == 0:
                assert g == w
            else:
                assert g.origin == w.origin and g.basis == w.basis


def test_quad_lazy_native_matches_blocked(cpu_native):
    # recover 6 secret bits from their pairwise products + a linear row
    # (the test_quadratic.py small-solve shape, driven through the lazy
    # native route vs explicit jax)
    n = 6
    secret = 0b101101
    sbits = [(secret >> i) & 1 for i in range(n)]

    def zeros_for(q):
        (x,) = q.gens()
        zeros = []
        for i in range(n):
            for j in range(i):
                zeros.append(q.mul_bit(x[i], x[j]) ^ (sbits[i] & sbits[j]))
        zeros.append(x ^ secret)
        return zeros

    q_nat = QuadraticSystem([n])
    q_jax = QuadraticSystem([n], backend="jax")
    sol_nat = q_nat.solve_one(zeros_for(q_nat))
    sol_jax = q_jax.solve_one(zeros_for(q_jax))
    assert sol_nat == sol_jax == (secret,)


def test_mt19937_full_flagship_native(cpu_native):
    """The FULL 19968-variable flagship recovery in CI: the native route
    makes it seconds on one CPU core, where the XLA-CPU emulation needs
    minutes (the device twin stays @slow for real hardware / bench.py)."""
    import random

    from gf2bv_tpu.crypto.mt import MT19937

    rand = random.Random(3142)
    st = tuple(rand.getstate()[1][:-1])
    out = [rand.getrandbits(32) for _ in range(624)]

    lin = LinearSystem([32] * 624)
    mt = lin.gens()
    rng = MT19937(list(mt))
    zeros = [rng.getrandbits(32) ^ o for o in out] + [mt[0] ^ 0x80000000]
    sol = lin.solve_one(zeros)
    assert sol == st


def test_mt19937_captured_batch_flagship_native(cpu_native):
    """Flagship SERVING shape in CI: capture the MT19937 template once,
    recover several full states from ONE host elimination (multi-RHS)."""
    import random

    from gf2bv_tpu.crypto.mt import MT19937

    lin = LinearSystem([32] * 624)

    def model(gens, p):
        rng = MT19937(list(gens))
        zeros = [rng.getrandbits(32) ^ p[k] for k in range(624)]
        zeros.append(gens[0] ^ 0x80000000)
        return zeros

    tmpl = lin.capture(model)
    cs = lazy_solve.cached_system(lin, tmpl.zeros)
    assert cs.backend == "native"

    states, outs = [], []
    for seed in (41, 42, 43):
        r = random.Random(seed)
        states.append(tuple(r.getstate()[1][:-1]))
        outs.append([r.getrandbits(32) for _ in range(624)])
    got = tmpl.solve_raw_batch(outs, mode=0)
    for g, st in zip(got, states):
        assert g is not None
        assert tuple((g >> (32 * i)) & 0xFFFFFFFF for i in range(624)) == st


def test_solve_native_aff_bits_semantics():
    rng = np.random.default_rng(7)
    rows, cols = 40, 30
    w = (1 + cols + 63) // 64
    eqs = rng.integers(0, 1 << 63, (rows, w), dtype=np.uint64)
    eqs &= np.uint64((1 << (1 + cols)) - 1)
    aff = rng.integers(0, 2, rows, dtype=np.uint8)

    swapped = eqs.copy()
    swapped[:, 0] = (swapped[:, 0] & ~np.uint64(1)) | aff

    for mode in (0, 1):
        a = _native.solve_native(eqs, cols, mode, aff_bits=aff)
        b = _native.solve_native(swapped, cols, mode)
        if b is None:
            assert a is None
        elif mode == 0:
            assert np.array_equal(a, b)
        else:
            assert np.array_equal(a[0], b[0])
            assert np.array_equal(a[1], b[1])
