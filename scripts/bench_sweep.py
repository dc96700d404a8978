"""Hardware timing of guess sweeps.

Three shapes, each against the reference idiom ("for each guess:
re-solve", one full factorization per candidate,
/root/reference/gf2bv/_internal.c:359-502):

A. examples/guess_sweep.py shape: 96-bit Galois LFSR, 84 system bits,
   4096 candidates over the 12 free state bits (LinearSystem
   solve_one_sweep -> one augmented elimination).
B. Flagship truncated-output MT19937 sweep: 624 outputs (dim ~31 from
   mt[0]'s low bits), 4096 candidates pinning 12 of the free state
   bits at the 19968-var shape.
C. nlfsr_ex guess shape: the 2-bit bit_assert bruteforce (4 candidate
   subsystems at 8257 cols) via the vmapped batched solver — bit_assert's
   consistency rows are candidate-dependent, so this is the sweep form
   that path takes (core/system.py solve_one_sweep scope note).

Run on a machine with a GPU: python scripts/bench_sweep.py
"""

import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gf2bv_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()


def log(*a):
    print(*a, flush=True)


def best_of(fn, n=3):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def bench_lfsr_sweep():
    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.crypto.lfsr import GaloisLFSR

    WIDTH, TAPS = 96, (1 << 95) | (1 << 81) | (1 << 17) | 0b101
    key = random.Random(5).getrandbits(WIDTH) | 1
    stream = GaloisLFSR(WIDTH, TAPS, key)
    observed = [stream() for _ in range(84)]

    lin = LinearSystem([WIDTH])
    (x,) = lin.gens()
    sym = GaloisLFSR(WIDTH, TAPS, x)
    zeros = [sym() ^ o for o in observed]
    guesses = [x[i] for i in range(WIDTH - 12, WIDTH)]

    sols = lin.solve_one_sweep(zeros, guesses)  # warm (compile + caches)
    assert any(s is not None and s[0] == key for s in sols)
    t, ts = best_of(lambda: lin.solve_one_sweep(zeros, guesses))
    log(f"A. LFSR sweep: 4096 candidates in {t:.3f} s "
        f"({4096 / t:,.0f} cand/s)  runs={[round(x, 3) for x in ts]}")

    # reference idiom: one candidate = one fresh solve (same public API)
    one, _ = best_of(
        lambda: lin.solve_one(zeros + [guesses[0] ^ 1]), n=3
    )
    log(f"   per-guess re-solve: {one:.4f} s/cand -> sweep speedup "
        f"{one * 4096 / t:,.0f}x")


def bench_mt_sweep():
    import numpy as np

    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.crypto.mt import MT19937

    rand = random.Random(3142)
    st = tuple(rand.getstate()[1][:-1])
    out = [rand.getrandbits(32) for _ in range(624)]

    lin = LinearSystem([32] * 624)
    words = lin.gens()
    sym = MT19937(list(words))
    zeros = [sym.getrandbits(32) ^ o for o in out]
    # dim ~31: mt[0] contributes only its MSB; guess 12 of its low bits
    guesses = [words[0][i] for i in range(12)]
    true_low = tuple((st[0] >> i) & 1 for i in range(12))

    t0 = time.perf_counter()
    sols = lin.solve_one_sweep(zeros, guesses)
    log(f"B. MT sweep cold (incl. compile/upload): "
        f"{time.perf_counter() - t0:.1f} s")
    k_true = sum(b << i for i, b in enumerate(true_low))
    assert sols[k_true] is not None
    assert sols[k_true][1:] == st[1:]  # words 1.. are fully determined
    t, ts = best_of(lambda: lin.solve_one_sweep(zeros, guesses), n=2)
    log(f"B. MT19937 flagship sweep: 4096 candidates @ 19968 cols in "
        f"{t:.3f} s ({4096 / t:,.0f} cand/s)  runs={[round(x, 3) for x in ts]}")
    one, _ = best_of(lambda: lin.solve_one(zeros), n=2)
    log(f"   per-guess re-solve: {one:.4f} s/cand -> sweep speedup "
        f"{one * 4096 / t:,.0f}x")


def bench_nlfsr_guess_batch():
    """nlfsr_ex guess shape (ref examples/nlfsr_ex.py:69-93): the 2-bit
    bit_assert bruteforce — 4 candidate subsystems at 1+128+8128 cols.
    bit_assert's consistency rows are candidate-dependent, so this sweep
    takes the vmapped batched-solver form (core/system.py scope note)."""
    import itertools

    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
    from nlfsr import annihilator_rows, keystream, trace_tap_streams

    from gf2bv_tpu import BitVec, QuadraticSystem
    from gf2bv_tpu.crypto.lfsr import GaloisLFSR
    from gf2bv_tpu.parallel.batch import solve_batch_systems

    NSTEPS = 2**14
    qsys = QuadraticSystem([65, 63])
    x = qsys.lift(BitVec.stack(qsys.gens()))
    t0 = time.perf_counter()
    taps = trace_tap_streams(GaloisLFSR, NSTEPS, sizes=(65, 63))
    rows = annihilator_rows(qsys, *taps)
    log(f"C. NLFSR trace (host): {time.perf_counter() - t0:.1f} s")

    secret = random.Random(9).getrandbits(128)
    out = np.array(keystream(GaloisLFSR, secret, NSTEPS), dtype=bool)
    zeros = [rows[np.flatnonzero(out)]]
    systems = [
        zeros
        + qsys.bit_assert(x[0], g0)
        + qsys.bit_assert(x[1] ^ x[2] ^ x[87], g1)
        for g0, g1 in itertools.product((0, 1), repeat=2)
    ]

    spaces = solve_batch_systems(qsys, systems, mode=1)  # warm
    assert any(sp is not None for sp in spaces)
    t, ts = best_of(lambda: solve_batch_systems(qsys, systems, mode=1), n=2)
    log(f"C. nlfsr_ex guess batch: 4 subsystems @ 8257 cols in {t:.3f} s "
        f"({4 / t:.1f} cand/s)  runs={[round(x, 3) for x in ts]}")
    # solve_all is a generator (reference semantics) — the honest sequential
    # per-candidate cost is the mode-1 solve it wraps, one per candidate
    one, _ = best_of(lambda: qsys.solve_raw_space(systems[0]), n=2)
    log(f"   sequential per-candidate mode-1 solve: {one:.3f} s/cand -> "
        f"batch speedup {one * 4 / t:.1f}x")


def main():
    import jax

    log(f"devices: {jax.devices()}")
    if "--only-nlfsr" not in sys.argv:
        bench_lfsr_sweep()
        bench_mt_sweep()
    if "--nlfsr" in sys.argv or "--only-nlfsr" in sys.argv:
        bench_nlfsr_guess_batch()


if __name__ == "__main__":
    main()
