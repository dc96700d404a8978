"""Capture/bind (re-trace-free solving): a model recorded once with Param
placeholders must solve every instance bit-identically to a fresh direct
trace, without re-running the model."""

import pickle
import random

import numpy as np
import pytest

from gf2bv_tpu import CapturedTrace, LinearSystem
from gf2bv_tpu.core.lazy import Param, ParamSpace
from gf2bv_tpu.crypto.lfsr import FibonacciLFSR, GaloisLFSR
from gf2bv_tpu.crypto.xoshiro import Xoshiro256starstar

MASK = 0xD670201BAC7515352A273372B2A95B23 & ((1 << 64) - 1)


def _lfsr_template(LFSR, n=64, nout=96):
    lin = LinearSystem([n])

    def model(gens, p):
        (s0,) = gens
        reg = LFSR(n, MASK, s0)
        return [reg() ^ p[i] for i in range(nout)]

    return lin, lin.capture(model)


def _lfsr_outputs(LFSR, init, n=64, nout=96):
    reg = LFSR(n, MASK, init)
    return [reg() for _ in range(nout)]


@pytest.mark.parametrize("LFSR", [GaloisLFSR, FibonacciLFSR])
def test_captured_lfsr_matches_direct_solve_across_instances(LFSR):
    lin, tmpl = _lfsr_template(LFSR)
    rnd = random.Random(42)
    for _ in range(3):
        init = rnd.getrandbits(64) | 1
        outs = _lfsr_outputs(LFSR, init)
        # no re-trace: only the values are bound
        assert tmpl.solve_one(outs) == (init,)

        # bit-identical to a fresh direct trace
        (s0,) = lin.gens()
        reg = LFSR(64, MASK, s0)
        direct = lin.solve_one([reg() ^ o for o in outs])
        assert direct == (init,)


def test_captured_solve_all_space_matches_direct():
    lin = LinearSystem([16])

    def model(gens, p):
        (v,) = gens
        # 12 constraints -> dim-4 space
        return [v[i] ^ v[i + 4] ^ p[i] for i in range(12)]

    tmpl = lin.capture(model)
    rnd = random.Random(7)
    secret = rnd.getrandbits(16)
    vals = [((secret >> i) ^ (secret >> (i + 4))) & 1 for i in range(12)]

    space_t = tmpl.solve_raw_space(vals)
    (v,) = lin.gens()
    space_d = lin.solve_raw_space([v[i] ^ v[i + 4] ^ c for i, c in enumerate(vals)])
    assert space_t.dimension == space_d.dimension
    assert space_t.origin == space_d.origin
    assert space_t.basis == space_d.basis
    assert set(tmpl.solve_all(vals)) == set(
        lin.solve_all([v[i] ^ v[i + 4] ^ c for i, c in enumerate(vals)])
    )


def test_captured_unsat_returns_none():
    lin = LinearSystem([8])

    def model(gens, p):
        (v,) = gens
        return [v[0] ^ p[0], v[0] ^ p[1]]

    tmpl = lin.capture(model)
    assert tmpl.solve_one([0, 1]) is None  # v0=0 AND v0=1
    assert tmpl.solve_one([1, 1]) == (1,)
    # literal-1 early-out: a dropped zero-coefficient row with affine bit
    def model2(gens, p):
        (v,) = gens
        return [v[0] ^ v[0] ^ p[0], v ^ p[1]]

    tmpl2 = lin.capture(model2)
    assert tmpl2.solve_one([1, 5]) is None
    assert tmpl2.solve_one([0, 5]) == (5,)


def test_captured_trace_pickles_iteratively():
    # a trace chain much deeper than the recursion limit
    lin = LinearSystem([32])

    def model(gens, p):
        (v,) = gens
        acc = v
        for i in range(3000):
            acc = (acc >> 1) ^ (acc & 0x7FFFFFFF) ^ ((i * 7) & 1)
        return [acc ^ p[0]]

    tmpl = lin.capture(model)
    blob = pickle.dumps(tmpl)
    tmpl2 = pickle.loads(blob)
    assert isinstance(tmpl2, CapturedTrace)
    assert tmpl2.nparams == 1
    val = 0xDEADBEEF
    # both templates must agree with each other exactly
    assert tmpl.solve_raw_one([val]) == tmpl2.solve_raw_one([val])
    # and with the direct trace
    (v,) = lin.gens()
    acc = v
    for i in range(3000):
        acc = (acc >> 1) ^ (acc & 0x7FFFFFFF) ^ ((i * 7) & 1)
    assert tmpl2.solve_raw_one([val]) == lin.solve_raw_one([acc ^ val])


def test_captured_xoshiro_roundtrip():
    lin = LinearSystem([64] * 4)

    def model(gens, p):
        x = Xoshiro256starstar(list(gens))
        return [x.step() ^ p[i] for i in range(10)]

    tmpl = lin.capture(model)
    rnd = random.Random(3)
    st = [rnd.getrandbits(64) for _ in range(4)]
    x = Xoshiro256starstar(list(st))
    outs = [x() for _ in range(10)]
    helper = Xoshiro256starstar([0, 0, 0, 0])
    pre = [helper.untemper(o) for o in outs]
    assert tmpl.solve_one(pre) == tuple(st)


def test_param_errors():
    lin = LinearSystem([8])
    tmpl = lin.capture(lambda g, p: [g[0] ^ p[0], g[0][:4] ^ p[2]])
    assert tmpl.nparams == 3
    with pytest.raises(ValueError, match="3 param slots"):
        tmpl.solve_one([1, 2])
    # unbound materialization is refused with a clear message
    with pytest.raises(ValueError, match="unbound Param"):
        _ = tmpl.zeros[0].rows
    # eager zeros are rejected at capture time
    with pytest.raises(TypeError, match="non-lazy"):
        CapturedTrace(lin, [lin.gens(lazy=False)[0]], 0)

    ps = ParamSpace()
    assert isinstance(ps[5], Param)
    assert ps.count == 6
    with pytest.raises(IndexError):
        ps[-1]


def test_captured_quadratic_template():
    """Params flow through mulq-bearing traces: a quadratic model captured
    once re-solves for different product values without re-tracing."""
    from gf2bv_tpu import QuadraticSystem

    n = 6
    qsys = QuadraticSystem([n])

    def model(gens, p):
        (x,) = gens
        zeros = [
            qsys.mul_bit(x[i], x[j]) ^ p[k]
            for k, (i, j) in enumerate(
                (i, j) for i in range(n) for j in range(i)
            )
        ]
        zeros.append(x ^ p[n * (n - 1) // 2])
        return zeros

    tmpl = qsys.capture(model)
    rnd = random.Random(6)
    for _ in range(3):
        secret = rnd.getrandbits(n) | 1
        sb = [(secret >> i) & 1 for i in range(n)]
        vals = [sb[i] & sb[j] for i in range(n) for j in range(i)]
        vals.append(secret)
        assert next(tmpl.solve_all(vals), None) == (secret,)


def test_captured_quadratic_solve_one_routes_through_filter():
    """CapturedTrace.solve_one on a QuadraticSystem must route through
    solve_all like QuadraticSystem.solve_one does: with an underdetermined
    space the raw mode-0 origin (free vars = 0) generically fails the
    lin/quad consistency check, and returning None for a satisfiable
    instance would be a silent wrong answer (review fix, round 3)."""
    from gf2bv_tpu import QuadraticSystem

    n = 5
    qsys = QuadraticSystem([n])
    pairs = [(i, j) for i in range(n) for j in range(i)]

    def model(gens, p):
        (x,) = gens
        # quad constraints only -> the linear block is free (dim >= n)
        return [
            qsys.mul_bit(x[i], x[j]) ^ p[k] for k, (i, j) in enumerate(pairs)
        ]

    tmpl = qsys.capture(model)
    secret = 0b10110
    sb = [(secret >> i) & 1 for i in range(n)]
    vals = [sb[i] & sb[j] for (i, j) in pairs]

    sol = tmpl.solve_one(vals)
    assert sol is not None
    assert sol in set(tmpl.solve_all(vals))
    # the recovered point must actually satisfy every product constraint
    (s,) = sol
    for (i, j), v in zip(pairs, vals):
        assert ((s >> i) & 1) & ((s >> j) & 1) == v


def test_captured_quadratic_host_backend_mixed_widths():
    """Host-backend fallback must pad narrow (pure-linear) rows to the full
    monomial width before stacking with mulq rows (review fix, round 3)."""
    from gf2bv_tpu import QuadraticSystem

    n = 6
    qsys = QuadraticSystem([n], backend="oracle")

    def model(gens, p):
        (x,) = gens
        zeros = [
            qsys.mul_bit(x[i], x[j]) ^ p[k]
            for k, (i, j) in enumerate(
                (i, j) for i in range(n) for j in range(i)
            )
        ]
        zeros.append(x ^ p[n * (n - 1) // 2])  # narrow pure-linear row
        return zeros

    tmpl = qsys.capture(model)
    secret = 0b110101
    sb = [(secret >> i) & 1 for i in range(n)]
    vals = [sb[i] & sb[j] for i in range(n) for j in range(i)]
    vals.append(secret)
    assert tmpl.solve_one(vals) == (secret,)


def test_captured_bit_assert_guess_sweep():
    """The SOUND captured guess-sweep idiom: bit_assert on a constant-free
    bit with the guess in v — one captured structure per guess value,
    per-instance observations bound through Params (review follow-up,
    round 3).  A Param-carrying bit_assert TARGET is refused loudly: the
    reference's mask-AND product formula is only sound for a fixed affine
    part."""
    from gf2bv_tpu import QuadraticSystem

    n = 5
    qsys = QuadraticSystem([n])
    pairs = [(i, j) for i in range(n) for j in range(i)]

    def make_model(guess):
        def model(gens, p):
            (x,) = gens
            zeros = [
                qsys.mul_bit(x[i], x[j]) ^ p[k]
                for k, (i, j) in enumerate(pairs)
            ]
            zeros += [x[i] ^ p[len(pairs) + i - 1] for i in range(1, n)]
            zeros += qsys.bit_assert(x[0], guess)  # guess is structural
            return zeros

        return model

    tmpls = [qsys.capture(make_model(g)) for g in (0, 1)]
    rnd = random.Random(11)
    for _ in range(3):
        secret = rnd.getrandbits(n) | 0b10
        sb = [(secret >> i) & 1 for i in range(n)]
        vals = [sb[i] & sb[j] for (i, j) in pairs]
        vals += [sb[i] for i in range(1, n)]
        hits = [
            (g, tmpls[g].solve_one(vals)) for g in (0, 1)
        ]
        good = [(g, s) for g, s in hits if s is not None]
        assert good == [(sb[0], (secret,))]

    # Param-carrying target: refused with guidance, not silent garbage
    def bad_model(gens, p):
        (x,) = gens
        return qsys.bit_assert(x[0] ^ p[0], 0)

    with pytest.raises(ValueError, match="constant-free"):
        qsys.capture(bad_model)


def test_oracle_backend_fallback_path():
    lin = LinearSystem([24], backend="oracle")

    def model(gens, p):
        (v,) = gens
        reg = GaloisLFSR(24, 0b110010101, v)
        zs = [reg() ^ p[i] for i in range(40)]
        # duplicated parity row with its own slot: binding different values
        # to p[40] and p[41] makes the instance provably unsatisfiable
        zs.append(v.sum() ^ p[40])
        zs.append(v.sum() ^ p[41])
        return zs

    tmpl = lin.capture(model)
    init = 0x8AF31D
    reg = GaloisLFSR(24, 0b110010101, init)
    outs = [reg() for _ in range(40)]
    par = bin(init).count("1") & 1
    assert tmpl.solve_one(outs + [par, par]) == (init,)
    # unsat through the fallback path too: contradictory duplicate rows
    assert tmpl.solve_one(outs + [par, par ^ 1]) is None
