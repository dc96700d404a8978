"""Differential validation of the device solver against the numpy oracle on the
full MT19937 system.

Plays the role of ``/root/reference/examples/sage_mt.py`` (which
cross-validates against Sage's solve_right): the same 19968-var system is
solved by the device Gauss-Jordan and by the slow host oracle, and the raw
solution ints must match bit-for-bit.  Note: the oracle on a 19968^2 system
takes minutes on CPU; pass a smaller bs-derived sample count to go faster."""

import _bootstrap  # noqa: F401  (repo-root imports + persistent compile cache)

import random

from gf2bv_tpu import LinearSystem
from gf2bv_tpu.core import packing
from gf2bv_tpu.crypto.mt import MT19937
from gf2bv_tpu.ops.gauss_ref import solve_oracle
from gf2bv_tpu.utils.timing import timeit


def oracle_test(bs=32):
    rand = random.Random(1234)
    effective_bs = ((bs - 1) & bs) or bs
    out = [rand.getrandbits(bs) for _ in range(624 * 32 // effective_bs)]

    lin = LinearSystem([32] * 624)
    mt = lin.gens()

    rng = MT19937(list(mt))
    zeros = [rng.getrandbits(bs) ^ o for o in out] + [mt[0] ^ 0x80000000]
    eqs = lin.get_eqs_packed(zeros)
    print("dim", eqs.shape)

    with timeit("device solve_raw_one"):
        ss = lin.solve_raw_one(zeros)
    with timeit("numpy oracle"):
        ref = solve_oracle(eqs, lin.cols)

    assert ref.consistent
    assert ss == packing.words_to_int(ref.origin), "solver disagrees with oracle"
    print("bit-exact match")


if __name__ == "__main__":
    oracle_test()
