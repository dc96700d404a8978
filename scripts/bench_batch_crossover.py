"""Batched-solver crossover sweep.

`parallel.batch.solve_batch` routes cols >= _PER_PIVOT_MAX_COLS to the
blocked family and below it to the vmapped per-pivot kernel.  This sweeps
cols x route on the device and prints solves/s so the routing constant
cites a measurement:

  per-pivot : vmapped gauss_jax.rref_device (the small-system kernel);
              timed as RREF + inconsistency readback (mode-0 extraction
              for this route is a separate host-driven pass)
  chained   : solve_chained — lax.scan of the fused single-system blocked
              solver (includes extraction + per-batch origin D2H)

Warm best-of-3.

Run on a machine with a GPU: python scripts/bench_batch_crossover.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from gf2bv_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import jax
import jax.numpy as jnp

from gf2bv_tpu.core import packing


def log(*a):
    print(*a, flush=True)


def best_of(fn, n=3):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def make_systems(rng, nb, cols):
    rows = cols + 32
    mats = []
    for _ in range(nb):
        secret = rng.integers(0, 2, size=cols).astype(np.uint8)
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        rhs = (coeff @ secret) % 2
        bits = np.concatenate([rhs[:, None], coeff], axis=1)
        mats.append(packing.pack_bits(bits, 1 + cols))
    return mats


def main():
    log(f"devices: {jax.devices()}")
    rng = np.random.default_rng(0xC505)

    from gf2bv_tpu.ops import gauss_batched
    from gf2bv_tpu.parallel.batch import _rref_batched, pack_batch

    for cols in (256, 512, 1024, 2048, 4096):
        nb = {256: 256, 512: 128, 1024: 64, 2048: 16, 4096: 8}[cols]
        mats = make_systems(rng, nb, cols)
        row = [f"cols={cols:5d} B={nb:4d}"]

        # -- per-pivot vmapped -------------------------------------------
        try:
            a = jnp.asarray(pack_batch(mats, cols))
            np.asarray(a[0, 0, :1])

            def pp():
                r, pof, inc = _rref_batched(a, cols)
                np.asarray(inc[:1])

            pp()
            row.append(f"per-pivot {nb / best_of(pp):9.0f}/s")
        except Exception as e:
            row.append(f"per-pivot FAIL {type(e).__name__}")

        # -- device-chained fused single-system solves --------------------
        try:
            def ch():
                gauss_batched.solve_chained(mats, cols)

            ch()
            row.append(f"chained {nb / best_of(ch):9.0f}/s")
        except Exception as e:
            row.append(f"chained FAIL {type(e).__name__}")

        log("  ".join(row))


if __name__ == "__main__":
    main()
