"""Lazy-quadratic record-floor measurement.

The ref-idiom NLFSR workload (examples/nlfsr_ref_idiom.py — per-bit
``mul_bit`` in a Python loop, the migration path from
/root/reference/examples/nlfsr.py:49-57) missed round-3's <= 1.5 s
host-cost target.  This script quantifies WHERE the remaining cost lives,
node by node, so the decision (optimize vs ledger) rests on numbers:

1. the workload: record wall, node count, materialize wall, solve wall;
2. record decomposition: per-node blake2b hashing vs Expr object creation
   vs the recording call dispatch — measured by re-running the same trace
   with hashing stubbed out;
3. the Python floor: creating the same number of minimal __slots__
   objects through one function call each (what a zero-overhead recorder
   would still pay).

Run CPU-pinned (the workload is host-side): python scripts/bench_lazy_record.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import random


def log(*a):
    print(*a, flush=True)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")  # host workload
    import numpy as np

    from nlfsr import WIDTH, keystream
    from nlfsr_ref_idiom import NSTEPS, trace_zeros_per_bit

    from gf2bv_tpu import QuadraticSystem
    from gf2bv_tpu.core import lazy
    from gf2bv_tpu.crypto.lfsr import GaloisLFSR

    secret = random.Random(11).getrandbits(WIDTH)
    out = keystream(GaloisLFSR, secret, NSTEPS)

    # -- 1. the workload ----------------------------------------------------
    qsys = QuadraticSystem([WIDTH])
    t0 = time.perf_counter()
    zeros = trace_zeros_per_bit(qsys, GaloisLFSR, out)
    t_rec = time.perf_counter() - t0
    nodes = sum(1 for _ in lazy.postorder([z._expr for z in zeros]))
    log(f"record: {t_rec:.2f} s, {len(zeros)} zeros, {nodes} DAG nodes "
        f"({t_rec / nodes * 1e6:.1f} us/node)")

    t0 = time.perf_counter()
    lazy.materialize_pending(zeros)
    mats = [z.rows for z in zeros]
    t_mat = time.perf_counter() - t0
    log(f"materialize: {t_mat:.2f} s ({t_mat / nodes * 1e6:.1f} us/node)")

    t0 = time.perf_counter()
    (one,) = qsys.solve_one(zeros)
    t_solve = time.perf_counter() - t0
    assert one == secret
    log(f"solve_one: {t_solve:.2f} s   TOTAL {t_rec + t_mat + t_solve:.2f} s")

    # -- 2. record decomposition: hashing vs object creation ----------------
    import hashlib

    real_blake2b = hashlib.blake2b

    class _FakeDigest:
        __slots__ = ()

        def digest(self):
            return b"\x00" * 12

    _fake = _FakeDigest()

    def fake_blake2b(*a, **kw):
        return _fake

    hashlib.blake2b = fake_blake2b
    lazy.hashlib.blake2b = fake_blake2b
    try:
        qsys2 = QuadraticSystem([WIDTH])
        t0 = time.perf_counter()
        trace_zeros_per_bit(qsys2, GaloisLFSR, out)
        t_nohash = time.perf_counter() - t0
    finally:
        hashlib.blake2b = real_blake2b
        lazy.hashlib.blake2b = real_blake2b
    log(f"record w/ hashing stubbed: {t_nohash:.2f} s -> hashing = "
        f"{(t_rec - t_nohash):.2f} s ({(t_rec - t_nohash) / t_rec * 100:.0f}%"
        f" of record)")

    # -- 3. the Python floor -------------------------------------------------
    class MiniExpr:
        __slots__ = ("op", "args", "aux", "width", "nbits", "shash", "aff0")

        def __init__(self, op, args, aux, width, nbits):
            self.op = op
            self.args = args
            self.aux = aux
            self.width = width
            self.nbits = nbits
            self.shash = b""
            self.aff0 = args[0].aff0 if args else True

    def make(op, args, aux, width):
        return MiniExpr(op, args, aux, width, 8258)

    root = MiniExpr("leaf", (), None, WIDTH, 8258)
    t0 = time.perf_counter()
    n = nodes
    cur = root
    for _ in range(n):
        cur = make("xor", (cur,), None, WIDTH)
    t_floor = time.perf_counter() - t0
    log(f"python floor ({n} minimal __slots__ nodes through one call each): "
        f"{t_floor:.2f} s ({t_floor / n * 1e6:.1f} us/node)")

    log(
        "decomposition: record = floor "
        f"{t_floor:.2f} + hashing {t_rec - t_nohash:.2f} + recorder logic "
        f"{t_nohash - t_floor:.2f} s; materialize adds {t_mat:.2f} s of "
        "per-node numpy eval (the eager-eval floor)"
    )


if __name__ == "__main__":
    main()
