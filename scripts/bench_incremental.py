"""Hardware timing of IncrementalSolver adds at flagship (MT19937) shape.

Measures what the online-attack loop actually pays per new batch of
equations, against the from-scratch alternative (a full fused solve,
~0.1 s warm).  The reference pays a fresh PLUQ per `m4ri_solve` call
(/root/reference/gf2bv/_internal.c:359-502); here an add is three bounded
passes over the device-resident RREF.

Run on a machine with a GPU: python scripts/bench_incremental.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from gf2bv_tpu.ops.incremental import IncrementalSolver
from gf2bv_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

COLS = 19968
ROWS = COLS + 64  # overdetermined, rank ~= COLS


def rand_rows(rng, n):
    w64 = -(-(1 + COLS) // 64)
    m = rng.integers(0, 1 << 63, size=(n, w64), dtype=np.uint64) * 2 + 1
    # clear bits past cols
    top = (1 + COLS) % 64
    if top:
        m[:, -1] &= (np.uint64(1) << np.uint64(top)) - np.uint64(1)
    return m


def sync(inc):
    inc._M.block_until_ready()


def main():
    import jax

    print("devices:", jax.devices(), flush=True)
    rng = np.random.default_rng(0xD4)

    t0 = time.perf_counter()
    inc = IncrementalSolver.from_packed(rand_rows(rng, ROWS - 4096), COLS,
                                        slack=8192)
    sync(inc)
    t_init = time.perf_counter() - t0
    print(f"init elimination ({ROWS - 4096} rows): {t_init:.3f} s  "
          f"rank={inc.rank}", flush=True)

    for b in (128, 512, 2048):
        # warm compile for this bucket
        inc.add_packed(rand_rows(rng, b))
        sync(inc)
        times = []
        for _ in range(3):
            rows = rand_rows(rng, b)
            t0 = time.perf_counter()
            inc.add_packed(rows)
            sync(inc)
            times.append(time.perf_counter() - t0)
        print(f"add B={b:5d}: min {min(times)*1e3:8.1f} ms  "
              f"(all: {[f'{t*1e3:.1f}' for t in times]})  rank={inc.rank}",
              flush=True)

    print(f"dimension now: {inc.dimension}  unsat={inc.unsat}", flush=True)

    # -- from-scratch alternative at the same total shape -------------------
    # (what the reference's per-call PLUQ idiom would pay per round,
    #  /root/reference/gf2bv/_internal.c:359-502)
    import jax.numpy as jnp

    from gf2bv_tpu.core import packing
    from gf2bv_tpu.ops import gauss_blocked

    a32 = gauss_blocked._pad(rand_rows(rng, ROWS), gauss_blocked.K_PANEL,
                             word_align=128)
    a_dev = jnp.asarray(a32)
    np.asarray(a_dev[0, :1])
    def scratch():
        gauss_blocked.rref_origin_blocked(a_dev, COLS)[1].block_until_ready()

    scratch()  # warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        scratch()
        ts.append(time.perf_counter() - t0)
    print(f"from-scratch fused mode-0 solve (same shape): "
          f"min {min(ts)*1e3:.1f} ms", flush=True)

    # -- online-attack loop shape: observe -> add -> check rank -------------
    # fresh solver seeded short of full rank; each round folds 128 new rows
    # and reads the maintained rank (the host int is updated by add itself)
    inc2 = IncrementalSolver.from_packed(rand_rows(rng, COLS - 640), COLS,
                                         slack=8192)
    sync(inc2)
    inc2.add_packed(rand_rows(rng, 128))  # warm the 128 bucket
    sync(inc2)
    print(f"online loop start: rank={inc2.rank} dim={inc2.dimension}",
          flush=True)
    round_times = []
    while inc2.dimension > 0 and len(round_times) < 12:
        rows = rand_rows(rng, 128)
        t0 = time.perf_counter()
        inc2.add_packed(rows)
        sync(inc2)
        round_times.append(time.perf_counter() - t0)
        print(f"  round {len(round_times)}: {round_times[-1]*1e3:7.1f} ms  "
              f"rank={inc2.rank} dim={inc2.dimension}", flush=True)
    if round_times:
        print(f"online loop: {len(round_times)} rounds, "
              f"median {sorted(round_times)[len(round_times)//2]*1e3:.1f} ms"
              f"/round (vs {min(ts)*1e3:.1f} ms from-scratch per round)",
              flush=True)


if __name__ == "__main__":
    main()
