"""QuadraticSystem semantics, differentially tested against the reference's
big-int formulas (``/root/reference/gf2bv/__init__.py:306-332`` reimplemented
below as the oracle for mul_bit)."""

import numpy as np
import pytest

from gf2bv_tpu import QuadraticSystem
from gf2bv_tpu.core import packing


def ref_mul_bit(n, a, b):
    """The reference's _mul_bit_slow on big-int masks (__init__.py:306-332)."""
    clm = (1 << (1 + n)) - 1
    v = (a & clm) & b
    abits = [(a >> (1 + i)) & 1 for i in range(n)]
    bbits = [(b >> (1 + i)) & 1 for i in range(n)]
    mi = 1 + n
    for i in range(n):
        for j in range(i):
            if (abits[i] & bbits[j]) ^ (abits[j] & bbits[i]):
                v |= 1 << mi
            mi += 1
    return v


@pytest.mark.parametrize("n", [4, 9, 32])
def test_mul_bit_vs_reference_formula(n):
    rng = np.random.default_rng(n)
    qsys = QuadraticSystem([n])
    nbits = qsys._nbits
    for _ in range(20):
        a = int(rng.integers(0, 1 << (1 + n)))
        b = int(rng.integers(0, 1 << (1 + n)))
        arow = packing.int_to_words(a, nbits)
        brow = packing.int_to_words(b, nbits)
        got = packing.words_to_int(qsys._mul_bit_rows(arow, brow))
        assert got == ref_mul_bit(n, a, b)


def test_mul_bit_slow_in_library_oracle():
    """The always-available slow path must agree with the fast kernel on
    arbitrary (even affine) operands."""
    rng = np.random.default_rng(99)
    qsys = QuadraticSystem([12])
    nbits = qsys._nbits
    from gf2bv_tpu import BitVec

    for _ in range(25):
        a = BitVec([int(rng.integers(0, 1 << 13))], nbits)
        b = BitVec([int(rng.integers(0, 1 << 13))], nbits)
        fast = qsys.mul_bit(a, b)
        slow = qsys._mul_bit_slow(a, b)
        assert np.array_equal(fast.rows, slow.rows)


def test_mul_bit_api():
    qsys = QuadraticSystem([4])
    (x,) = qsys.gens()
    p = qsys.mul_bit(x[0], x[1])
    # x1*x2 -> quad monomial (i=1, j=0) = first quad column 1+4
    assert p._bits == (1 << 5,)
    with pytest.raises(ValueError):
        qsys.mul_bit(x, x)


def test_mul_bits_vectorized_matches_scalar():
    n = 8
    rng = np.random.default_rng(5)
    qsys = QuadraticSystem([n])
    nbits = qsys._nbits
    a_masks = [int(rng.integers(0, 1 << (1 + n))) for _ in range(6)]
    b_masks = [int(rng.integers(0, 1 << (1 + n))) for _ in range(6)]
    from gf2bv_tpu import BitVec

    av = BitVec(packing.ints_to_rows(a_masks, nbits), nbits)
    bv = BitVec(packing.ints_to_rows(b_masks, nbits), nbits)
    got = qsys.mul_bits(av, bv)._bits
    want = tuple(ref_mul_bit(n, a, b) for a, b in zip(a_masks, b_masks))
    assert got == want


def test_check_lin_match_quad():
    n = 4
    qsys = QuadraticSystem([n])
    lin = 0b1011
    bits = [(lin >> i) & 1 for i in range(n)]
    quad = 0
    mi = 0
    for i in range(n):
        for j in range(i):
            quad |= (bits[i] & bits[j]) << mi
            mi += 1
    assert qsys._check_lin_match_quad(lin, quad)
    assert not qsys._check_lin_match_quad(lin, quad ^ 1)


def test_bit_assert_matches_reference_formula():
    n = 5
    qsys = QuadraticSystem([n])
    (x,) = qsys.gens()
    a_mask = (1 << 1) ^ (1 << 3)  # x0 ^ x2
    for v in (0, 1):
        got = [bv._bits[0] for bv in qsys.bit_assert(x[0] ^ x[2], v)]
        want = [a_mask ^ v]
        for i in range(1, 1 + n):
            b = 1 << i
            if a_mask == b:
                continue
            p = ref_mul_bit(n, a_mask, b)
            want.append(p if v == 0 else p ^ b)
        assert got == want


def test_bit_assert_skips_equal_basis_bit():
    n = 3
    qsys = QuadraticSystem([n])
    (x,) = qsys.gens()
    got = qsys.bit_assert(x[1], 1)
    # a == basis bit 2 -> that consistency eq is skipped (ref :358-359)
    assert len(got) == 1 + (n - 1)


@pytest.mark.parametrize("backend", ["oracle", "jax"])
def test_quadratic_solve_small(backend):
    # tiny nonlinear system: recover 6 secret bits from quadratic outputs
    n = 6
    rng = np.random.default_rng(9)
    secret = int(rng.integers(1, 1 << n))
    sbits = [(secret >> i) & 1 for i in range(n)]

    qsys = QuadraticSystem([n], backend=backend)
    (x,) = qsys.gens()
    zeros = []
    for i in range(n):
        for j in range(i):
            prod = qsys.mul_bit(x[i], x[j])
            zeros.append(prod ^ (sbits[i] & sbits[j]))
    zeros.append(x ^ secret)
    (sol,) = qsys.solve_one(zeros)
    assert sol == secret


def test_quadratic_convert_sol_filters_spurious():
    n = 3
    qsys = QuadraticSystem([n])
    # lin = 0b011 -> x1x0 = 1, x2x0 = 0, x2x1 = 0 -> quad = 0b001
    assert qsys.convert_sol(0b001_011) == (0b011,)
    assert qsys.convert_sol(0b000_011) is None


def test_quadratic_gens_hides_quad_block():
    qsys = QuadraticSystem([4, 4])
    gens = qsys.gens()
    assert len(gens) == 2
    assert qsys._lin_size == 8
    assert qsys._quad_size == 28


def test_quadratic_pickle():
    import pickle

    qsys = QuadraticSystem([5])
    q2 = pickle.loads(pickle.dumps(qsys))
    assert q2._quad_sizes == [5]
    assert q2._quad_size == 10


def test_quadratic_multi_block_sizes():
    # QuadraticSystem with multiple sizes (reference nlfsr_ex.py:22)
    qsys = QuadraticSystem([5, 3])
    lo, hi = qsys.gens()
    x = lo.concat(hi)
    secret = 0b10110101
    zeros = [x ^ secret]
    for i in range(8):
        for j in range(i):
            zeros.append(
                qsys.mul_bit(x[i], x[j]) ^ (((secret >> i) & (secret >> j)) & 1)
            )
    sol = qsys.solve_one(zeros)
    assert sol == (secret & 0b11111, secret >> 5)
    assert qsys.evaluate(x, sol) == secret


def test_quadratic_solve_one_batch_uses_consistency_filter():
    """A raw mode-0 point can fail the quadratic filter; solve_one_batch
    must route through spaces + first-consistent-point like solve_one
    (the same shape as test_quadratic_solve_small, batched)."""
    n = 6
    rng = np.random.default_rng(9)
    secrets_ = [int(rng.integers(1, 1 << n)) for _ in range(3)]

    qsys = QuadraticSystem([n])
    (x,) = qsys.gens()
    batch = []
    for secret in secrets_:
        sbits = [(secret >> i) & 1 for i in range(n)]
        zeros = []
        for i in range(n):
            for j in range(i):
                zeros.append(qsys.mul_bit(x[i], x[j]) ^ (sbits[i] & sbits[j]))
        zeros.append(x ^ secret)
        batch.append(zeros)

    got = qsys.solve_one_batch(batch)
    assert [g for g in got] == [(s,) for s in secrets_]


def test_solve_one_batch_max_dimension_threaded():
    """A batch instance whose space has dim > 16 must (a) raise an
    instance-annotated DimensionTooLargeError at the default guard and
    (b) solve when max_dimension is raised (the
    nlfsr_ex-style guessing workload hits dim 17 the moment a guess
    under-constrains)."""
    from gf2bv_tpu import DimensionTooLargeError

    n = 8  # 8 + 28 = 36 monomial columns
    rng = np.random.default_rng(17)
    secret = int(rng.integers(1, 1 << n))
    qsys = QuadraticSystem([n])
    (x,) = qsys.gens()

    # 19 random linear constraints on the 36 monomials, all satisfied by
    # the lifted secret -> solution space dim = 36 - rank ~ 17
    sbits = [(secret >> i) & 1 for i in range(n)]
    mono = list(sbits)
    for i in range(n):
        for j in range(i):
            mono.append(sbits[i] & sbits[j])
    zeros = []
    while len(zeros) < 19:
        sel = rng.integers(0, 2, size=len(mono))
        if not sel.any():
            continue
        parts = [x[i] for i in range(n)] + [
            qsys.mul_bit(x[i], x[j]) for i in range(n) for j in range(i)
        ]
        acc = None
        for s, p in zip(sel, parts):
            if s:
                acc = p if acc is None else acc ^ p
        rhs = int(np.dot(sel, mono) % 2)
        zeros.append(acc ^ rhs)

    space = qsys.solve_raw_space(zeros)
    assert space.dimension == 17  # deterministic given the seed

    with pytest.raises(DimensionTooLargeError) as ei:
        qsys.solve_one_batch([zeros])
    assert "batch instance 0" in str(ei.value)
    assert ei.value.space.dimension == 17

    (sol,) = qsys.solve_one_batch([zeros], max_dimension=17)
    assert sol is not None
    assert qsys.evaluate(x, sol) == secret


def test_unknown_backend_raises():
    import pytest as _pytest

    from gf2bv_tpu import LinearSystem

    lin = LinearSystem([8], backend="orcale")
    (v,) = lin.gens(lazy=False)
    with _pytest.raises(ValueError, match="unknown backend"):
        lin.solve_one([v ^ 3])
    # 'auto' resolves instead of being treated as a backend name
    lin2 = LinearSystem([8], backend="auto")
    (w,) = lin2.gens(lazy=False)
    assert lin2.solve_one([w ^ 3]) == (3,)
