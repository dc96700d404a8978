"""Nonlinearly-filtered LFSR attack via a quadratic annihilator.

Workload parity with ``/root/reference/examples/nlfsr.py``: a 128-bit LFSR
filtered through a 5-tap combiner; whenever the keystream bit is 1, the
annihilator of the combiner vanishes on the tap bits, giving one quadratic
equation; linearization over 128 + 8128 monomials solves the state.

Device-idiomatic trace: the LFSR is traced once against a *narrow* linear
system (129-bit rows), the three tap-bit streams are stacked into wide
BitVecs, and all annihilator rows are produced by two batched ``mul_bits``
calls — no per-output O(n^2) monomial expansion.
"""

import _bootstrap  # noqa: F401  (repo-root imports + persistent compile cache)

import itertools
import secrets

import numpy as np

from gf2bv_tpu import BitVec, LinearSystem, QuadraticSystem
from gf2bv_tpu.crypto.lfsr import FibonacciLFSR, GaloisLFSR

WIDTH = 128
TAPS = 0xD670201BAC7515352A273372B2A95B23
SELECT = (13, 24, 35, 46, 57)


def combiner(x0, x1, x2, x3, x4):
    """The filtering function (balanced: emits 1 half the time)."""
    return (x0 * x1) ^ (x0 * x1 * x3 * x4) ^ x0 ^ x1 ^ x2


def annihilator(x0, x1, x2):
    """g with g * combiner == 0: whenever the combiner outputs 1, this
    degree-2 form over the first three taps is 0."""
    return (x0 * x1) ^ x0 ^ (x1 * x2) ^ x1 ^ x2 ^ 1


def check_annihilator():
    for bits in itertools.product((0, 1), repeat=5):
        if combiner(*bits):
            assert annihilator(*bits[:3]) == 0


def keystream(lfsr_cls, state, nsteps):
    reg = lfsr_cls(WIDTH, TAPS, state)
    out = []
    for _ in range(nsteps):
        reg()
        out.append(combiner(*((reg.state >> i) & 1 for i in SELECT)))
    return out


def trace_tap_streams(lfsr_cls, nsteps, sizes=(WIDTH,)):
    """Run the LFSR symbolically over a narrow linear system and collect
    the three annihilator tap bits of every step as nsteps-wide BitVecs."""
    lin = LinearSystem(sizes)
    reg = lfsr_cls(WIDTH, TAPS, BitVec.stack(lin.gens()))
    streams = ([], [], [])
    for _ in range(nsteps):
        reg()
        for bits, tap in zip(streams, SELECT[:3]):
            bits.append(reg.state[tap])
    return tuple(BitVec.stack(bits) for bits in streams)


def annihilator_rows(qsys, x0, x1, x2):
    """All annihilator equations at once: two batched quadratic products
    plus the linear and constant terms, at full monomial width."""
    ones = (1 << len(x0)) - 1
    return (
        qsys.mul_bits(x0, x1)
        ^ qsys.mul_bits(x1, x2)
        ^ qsys.lift(x0)
        ^ qsys.lift(x1)
        ^ qsys.lift(x2)
        ^ ones
    )


def attack(lfsr_cls, nsteps=2**14 + 1000):
    print(f"--- {lfsr_cls.__name__} ---")
    secret = secrets.randbits(WIDTH)
    print(f"secret    {secret:0{WIDTH}b}")
    out = np.array(keystream(lfsr_cls, secret, nsteps), dtype=bool)

    # the O(n^2) monomial expansion runs ON DEVICE from the narrow tap
    # streams (~400 KB upload), and the equation matrix never comes back:
    # solve_all_packed / solve_one_packed consume it device-resident
    from gf2bv_tpu.ops import quad_device

    qsys = QuadraticSystem([WIDTH])
    x0, x1, x2 = trace_tap_streams(lfsr_cls, nsteps)
    eqs = quad_device.quad_rows(
        qsys,
        pairs=[(x0, x1), (x1, x2)],  # the annihilator's quadratic terms
        linear=[x0, x1, x2],
        const=(1 << nsteps) - 1,
    )
    import jax.numpy as jnp

    # bucket-pad the selection (duplicate equations are inert under RREF)
    # so the gather/solve shapes quantize and the compiled executables are
    # reused across runs with different keystreams
    sel = np.flatnonzero(out)
    want = -(-len(sel) // 256) * 256
    sel = np.concatenate([sel, np.full(want - len(sel), sel[0])])
    eqs_sel = eqs[jnp.asarray(sel)]  # device gather; matrix stays on device
    print(f"{int(out.sum())} equations from {nsteps} outputs")

    solutions = [s for (s,) in qsys.solve_all_packed(eqs_sel)]
    for s in solutions:
        print(f"recovered {s:0{WIDTH}b}")
    assert solutions and all(s == secret for s in solutions)

    (one,) = qsys.solve_one_packed(eqs_sel)
    assert one == secret


if __name__ == "__main__":
    check_annihilator()
    attack(GaloisLFSR)
    attack(FibonacciLFSR)
