"""NLFSR attack, extended: trace caching + guessed-bit recovery + batching.

Workload parity with ``/root/reference/examples/nlfsr_ex.py``: only 2**14
outputs (so the solution space can exceed the enumeration guard), a
multi-block QuadraticSystem([65, 63]), an on-disk cache of the
input-independent symbolic trace, and — when DimensionTooLargeError fires —
a 2-bit ``bit_assert`` bruteforce over x[0] and x[1]^x[2]^x[87].  This
engine's addition: all four guess subsystems solve as ONE batched device call.
"""

import _bootstrap  # noqa: F401  (repo-root imports + persistent compile cache)

import gzip
import itertools
import pickle
import secrets
from pathlib import Path as _Path

import numpy as np

from nlfsr import WIDTH, annihilator_rows, keystream, trace_tap_streams

from gf2bv_tpu import BitVec, DimensionTooLargeError, QuadraticSystem
from gf2bv_tpu.crypto.lfsr import FibonacciLFSR, GaloisLFSR
from gf2bv_tpu.parallel.batch import solve_batch_systems

NSTEPS = 2**14  # fewer outputs than nlfsr.py -> under-determined on purpose


def cached_annihilator_rows(qsys, lfsr_cls) -> BitVec:
    """The symbolic trace is input-independent, so it is traced once per
    LFSR class and cached on disk (packed rows pickle, gzip)."""
    path = _Path(__file__).parent / f"trace_{lfsr_cls.__name__}.pkl.gz"
    try:
        with gzip.open(path, "rb") as fh:
            rows = pickle.load(fh)
        assert len(rows) == NSTEPS
        print("trace cache hit")
    except Exception:
        print("tracing (cold)...")
        taps = trace_tap_streams(lfsr_cls, NSTEPS, sizes=(65, 63))
        rows = annihilator_rows(qsys, *taps)
        with gzip.open(path, "wb") as fh:
            pickle.dump(rows, fh)
    return rows


def first_consistent(qsys, space):
    """First enumerated point that passes the quadratic consistency filter."""
    if space is None or space.dimension > 16:
        return None
    for raw in space:
        point = qsys.convert_sol(raw)
        if point is not None:
            return point
    return None


def attack(lfsr_cls, *, batched_guessing=True):
    print(f"--- {lfsr_cls.__name__} ---")
    qsys = QuadraticSystem([65, 63])
    x = qsys.lift(BitVec.stack(qsys.gens()))
    rows = cached_annihilator_rows(qsys, lfsr_cls)

    secret = secrets.randbits(WIDTH)
    print(f"secret    {secret:0{WIDTH}b}")
    out = np.array(keystream(lfsr_cls, secret, NSTEPS), dtype=bool)
    zeros = [rows[np.flatnonzero(out)]]
    print(f"{int(out.sum())} equations")

    try:
        point = qsys.solve_one(zeros)
    except DimensionTooLargeError as err:
        print(f"underdetermined ({err}); guessing 2 bits")
        guesses = list(itertools.product((0, 1), repeat=2))
        systems = [
            zeros
            + qsys.bit_assert(x[0], g0)
            + qsys.bit_assert(x[1] ^ x[2] ^ x[87], g1)
            for g0, g1 in guesses
        ]
        if batched_guessing:
            # all guess subsystems in one vmapped device solve
            spaces = solve_batch_systems(qsys, systems, mode=1)
            results = [first_consistent(qsys, sp) for sp in spaces]
        else:
            results = [qsys.solve_one(sys_zeros) for sys_zeros in systems]

        hits = 0
        for (g0, g1), point in zip(guesses, results):
            if point is None:
                continue
            value = qsys.evaluate(x, point)
            print(f"guess {g0}{g1} -> {value:0{WIDTH}b}")
            assert value == secret
            assert value & 1 == g0
            assert ((value >> 1) ^ (value >> 2) ^ (value >> 87)) & 1 == g1
            hits += 1
        assert hits
    else:
        value = qsys.evaluate(x, point)
        print(f"fully determined -> {value:0{WIDTH}b}")
        assert value == secret


if __name__ == "__main__":
    attack(GaloisLFSR)
    attack(FibonacciLFSR)
