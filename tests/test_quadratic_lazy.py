"""The reference's OWN quadratic idiom — a Python loop of per-bit
``mul_bit`` over full-width quadratic gens
(``/root/reference/examples/nlfsr.py:49-57``) — must be both correct and
cheap on the lazy path: products record mulq nodes and
the whole zeros list materializes in one shared walk at solve time.
"""

import numpy as np
import pytest

from gf2bv_tpu import QuadraticSystem
from gf2bv_tpu.core.lazy import LazyBitVec
from gf2bv_tpu.crypto.lfsr import FibonacciLFSR, GaloisLFSR

N_STATE = 16
MASK = 0xD295  # near-full-rank annihilator system (solution dim 1)
SELECT = (1, 3, 6, 10, 12)


def combiner(x0, x1, x2, x3, x4):
    return (x0 * x1) ^ (x0 * x1 * x3 * x4) ^ x0 ^ x1 ^ x2


def annihilator_zero(qsys, x0, x1, x2):
    """annihilator(x) = x0*x1 ^ x0 ^ x1*x2 ^ x1 ^ x2 ^ 1 (== 0 whenever
    the combiner output is 1) — the reference example's equation shape."""
    return qsys.mul_bit(x0, x1) ^ x0 ^ qsys.mul_bit(x1, x2) ^ x1 ^ x2 ^ 1


def _concrete_outputs(LFSR, init, nout):
    lfsr = LFSR(N_STATE, MASK, init)
    outs = []
    for _ in range(nout):
        lfsr()
        x = [(lfsr.state >> i) & 1 for i in SELECT]
        outs.append(combiner(*x))
    return outs


def _zeros_ref_idiom(qsys, out, lazy: bool):
    (x,) = qsys.gens(lazy=lazy)
    lfsr_sys = GaloisLFSR(N_STATE, MASK, x)
    zeros = []
    for o in out:
        lfsr_sys()
        if o == 1:
            x0, x1, x2 = [lfsr_sys.state[i] for i in SELECT[:3]]
            zeros.append(annihilator_zero(qsys, x0, x1, x2))
    return zeros


def test_ref_idiom_records_lazily_and_matches_eager_matrix():
    rng = np.random.default_rng(5)
    init = int(rng.integers(1, 1 << N_STATE))
    out = _concrete_outputs(GaloisLFSR, init, 120)

    qsys = QuadraticSystem([N_STATE])
    lazy_zeros = _zeros_ref_idiom(qsys, out, lazy=True)
    assert all(isinstance(z, LazyBitVec) for z in lazy_zeros)
    eager_zeros = _zeros_ref_idiom(qsys, out, lazy=False)

    got = qsys.get_eqs_packed(lazy_zeros)
    want = qsys.get_eqs_packed(eager_zeros)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("LFSR", [GaloisLFSR, FibonacciLFSR])
def test_ref_idiom_nlfsr_recovery(LFSR):
    """The reference example end-to-end at test scale: quadratic
    annihilator attack recovers the register through solve_all AND
    solve_one, written exactly like /root/reference/examples/nlfsr.py."""
    rng = np.random.default_rng(int(LFSR is FibonacciLFSR))
    init = int(rng.integers(1, 1 << N_STATE))
    nout = 600  # >> 16 + 120 monomials
    out = _concrete_outputs(LFSR, init, nout)

    qsys = QuadraticSystem([N_STATE])
    (x,) = qsys.gens()  # lazy by default now
    lfsr_sys = LFSR(N_STATE, MASK, x)
    zeros = []
    for o in out:
        lfsr_sys()
        if o == 1:
            x0, x1, x2 = [lfsr_sys.state[i] for i in SELECT[:3]]
            zeros.append(annihilator_zero(qsys, x0, x1, x2))

    sols = list(qsys.solve_all(zeros))
    assert (init,) in sols
    got = qsys.solve_one(zeros)
    assert got in sols


def test_lazy_bit_assert_matches_eager():
    qsys = QuadraticSystem([8])
    (xl,) = qsys.gens(lazy=True)
    (xe,) = qsys.gens(lazy=False)
    a_l = xl[2] ^ xl[5] ^ 1
    a_e = xe[2] ^ xe[5] ^ 1
    for v in (0, 1):
        zl = qsys.bit_assert(a_l, v)
        ze = qsys.bit_assert(a_e, v)
        assert np.array_equal(
            qsys.get_eqs_packed(zl), qsys.get_eqs_packed(ze)
        ), v


def test_lazy_bit_assert_guess_solve():
    """bit_assert-driven guessing through the lazy path: pin two state
    bits, solve, and check only the matching guess succeeds."""
    n = 10
    rng = np.random.default_rng(12)
    secret = int(rng.integers(1, 1 << n))
    qsys = QuadraticSystem([n])
    (x,) = qsys.gens()
    sb = [(secret >> i) & 1 for i in range(n)]
    base = [
        qsys.mul_bit(x[i], x[j]) ^ (sb[i] & sb[j])
        for i in range(n)
        for j in range(i)
    ]
    # leave bits 0..1 unconstrained linearly; pin them by guessing
    base += [x[i] ^ sb[i] for i in range(2, n)]
    hits = []
    for g0 in (0, 1):
        for g1 in (0, 1):
            zeros = list(base)
            zeros += qsys.bit_assert(x[0], g0)
            zeros += qsys.bit_assert(x[1] ^ x[0], g1 ^ g0)
            sol = qsys.solve_one(zeros)
            if sol is not None:
                hits.append((g0, g1, sol))
    assert len(hits) == 1
    g0, g1, sol = hits[0]
    assert (g0, g1) == (sb[0], sb[1])
    assert sol == (secret,)
