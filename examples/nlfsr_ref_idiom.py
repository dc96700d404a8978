"""The NLFSR attack driven through the PER-BIT ``mul_bit`` idiom.

`examples/nlfsr.py` is the device-idiomatic version of this attack (narrow
tap streams, batched device expansion).  This file solves the identical
workload the way a user migrating from the reference would naturally write
it — full-width quadratic gens, a plain Python loop stepping the symbolic
register, one `mul_bit`-built annihilator equation appended per keystream
1 (the style of ``/root/reference/examples/nlfsr.py:49-57``).  The lazy
engine makes that style fast without any rewrite: each `mul_bit` records a
``mulq`` node, and the whole zeros list materializes at solve time in one
shared walk with a single batched monomial expansion on the XLA CPU
backend (core/lazy.materialize_many -> ops/quad_device.mul_bits_batch).

All workload parameters and the combiner/annihilator pair are imported
from examples/nlfsr.py — the two files ARE the same attack, expressed in
the two idioms.
"""

import _bootstrap  # noqa: F401  (repo-root imports + persistent compile cache)

import secrets
import time

from nlfsr import SELECT, TAPS, WIDTH, annihilator, check_annihilator, keystream

from gf2bv_tpu import QuadraticSystem
from gf2bv_tpu.crypto.lfsr import FibonacciLFSR, GaloisLFSR

NSTEPS = 2**14 + 1000


def trace_zeros_per_bit(qsys, lfsr_cls, out):
    """The migration-path trace: step the symbolic register in Python and
    emit one annihilator row per keystream 1, bit products via mul_bit.
    Everything here only RECORDS; the heavy lifting happens at solve."""
    (x,) = qsys.gens()  # lazy by default
    reg = lfsr_cls(WIDTH, TAPS, x)
    zeros = []
    for o in out:
        reg()
        if o:
            t0, t1, t2 = (reg.state[i] for i in SELECT[:3])
            # annihilator(t0, t1, t2) == 0 whenever the combiner emitted 1;
            # same algebra as nlfsr.annihilator, over symbolic bits
            zeros.append(
                qsys.mul_bit(t0, t1) ^ qsys.mul_bit(t1, t2)
                ^ t0 ^ t1 ^ t2 ^ 1
            )
    return zeros


def run(lfsr_cls):
    print(f"--- {lfsr_cls.__name__} (per-bit idiom) ---")
    secret = secrets.randbits(WIDTH)
    print(f"secret    {secret:0{WIDTH}b}")
    out = keystream(lfsr_cls, secret, NSTEPS)

    qsys = QuadraticSystem([WIDTH])
    t0 = time.perf_counter()
    zeros = trace_zeros_per_bit(qsys, lfsr_cls, out)
    print(f"{len(zeros)} equations recorded in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    solutions = [s for (s,) in qsys.solve_all(zeros)]
    print(f"solve_all {time.perf_counter() - t0:.2f}s")
    assert solutions and all(s == secret for s in solutions)

    t0 = time.perf_counter()
    (one,) = qsys.solve_one(zeros)
    print(f"solve_one {time.perf_counter() - t0:.2f}s")
    assert one == secret
    print(f"recovered {one:0{WIDTH}b}")


if __name__ == "__main__":
    check_annihilator()
    # sanity: the traced algebra equals the imported annihilator
    for v in range(8):
        b = [(v >> i) & 1 for i in range(3)]
        traced = (b[0] & b[1]) ^ (b[1] & b[2]) ^ b[0] ^ b[1] ^ b[2] ^ 1
        assert traced == annihilator(*b)
    run(GaloisLFSR)
    run(FibonacciLFSR)
    print("ok")
