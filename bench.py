"""Headline benchmark: MT19937 19968-var state recovery (solve_one) on a GPU.

Wall-clock of the fused device solve of the 19968-variable system traced
from 624 MT19937 outputs, the reference harness's own workload
(``/root/reference/examples/mt.py:29-36``: bs=32 plus the known-MSB
equation), and the serving paths around it: the public API, the captured
trace, a B=256 multi-RHS batch and a 4096-candidate guess sweep.

The system is built on the device (crypto/mt_jax.py, bit-exact vs the host
trace), so only the 624 observed words cross the host boundary.  Every
time ends in ``block_until_ready``.  The run fails when JAX finds no GPU.

Prints the device on stderr and exactly ONE JSON line on stdout.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import sys
import time

os.environ["JAX_PLATFORMS"] = "cuda"

# the reference publishes no numbers; BASELINE.md sizes M4RI single-core
# at this shape as seconds-scale
M4RI_BASELINE_EST_S = 2.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _best(fn, n: int = 3) -> float:
    import jax

    jax.block_until_ready(fn())  # warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def bench_mt19937():
    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax import lax

    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.core import packing
    from gf2bv_tpu.crypto import mt_jax
    from gf2bv_tpu.crypto.mt import MT19937
    from gf2bv_tpu.ops import gauss_blocked

    rand = random.Random(3142)
    st = tuple(rand.getstate()[1][:-1])
    out = [rand.getrandbits(32) for _ in range(624)]
    outs32 = jnp.asarray(np.asarray(out, dtype=np.uint32))

    def build(o=outs32):
        e = mt_jax.mt19937_system_device(o, 32, 624)
        return jnp.pad(e, ((0, -e.shape[0] % 256), (0, 0)))

    eqs = build()
    origin32, unsat = jax.device_get(gauss_blocked.rref_origin_blocked(eqs, mt_jax.COLS))
    assert not bool(unsat)
    v = packing.words_to_int(packing.from_u32(origin32[None, :])[0])
    assert tuple((v >> (32 * i)) & 0xFFFFFFFF for i in range(624)) == st

    trace_s = _best(build)
    solve_s = _best(lambda: gauss_blocked.rref_origin_blocked(eqs, mt_jax.COLS))
    log(f"device trace {trace_s:.4f} s; solve_one (fused device solve) {solve_s:.4f} s")

    # N trace+solve iterations chained inside ONE jit via lax.scan: no host
    # involvement between solves
    nchain = 4

    @jax.jit
    def solve_many(outs_b):
        def body(carry, o):
            return carry, gauss_blocked.rref_origin_blocked(build(o), mt_jax.COLS)[0]

        return lax.scan(body, 0, outs_b)[1]

    outs_b = jnp.stack([outs32] * nchain)
    chain_s = _best(lambda: solve_many(outs_b)) / nchain
    log(f"device-chained trace+solve {chain_s:.4f} s/solve")

    # public API through the lazy trace engine (device-cached coefficient
    # matrix, per-solve affine delta) and the captured trace
    lin = LinearSystem([32] * 624)
    words = lin.gens()
    sym = MT19937(list(words))
    zeros = [sym.getrandbits(32) ^ o for o in out] + [words[0] ^ 0x80000000]
    assert lin.solve_one(zeros) == st
    api_s = _best(lambda: lin.solve_one(zeros))

    def mt_model(ws, p):
        s = MT19937(list(ws))
        return [s.getrandbits(32) ^ p[i] for i in range(624)] + [ws[0] ^ 0x80000000]

    tmpl = lin.capture(mt_model)
    assert tmpl.solve_one(out) == st
    tmpl_s = _best(lambda: tmpl.solve_one(out))
    log(f"public-API solve_one {api_s:.4f} s; captured-trace solve_one {tmpl_s:.4f} s")

    nb = 256
    batch, states = [], []
    for k in range(nb):
        r = random.Random(91_000 + k)
        states.append(tuple(r.getstate()[1][:-1]))
        batch.append([r.getrandbits(32) for _ in range(624)])
    assert tmpl.solve_one_batch(batch) == states
    batch_s = _best(lambda: tmpl.solve_one_batch(batch))
    log(f"captured multi-RHS batch B={nb}: {batch_s:.4f} s = "
        f"{nb / batch_s:.1f} recoveries/s")

    guesses = [words[0][i] for i in range(12)]
    k_true = sum(((st[0] >> i) & 1) << i for i in range(12))
    sweep = lin.solve_one_sweep(zeros, guesses)
    assert sweep[k_true] == st and sum(x is not None for x in sweep) == 1
    sweep_s = _best(lambda: lin.solve_one_sweep(zeros, guesses), 2)
    log(f"guess sweep: 4096 candidates in {sweep_s:.4f} s")

    return {
        "solve_s": solve_s,
        "trace_s": trace_s,
        "chain_s": chain_s,
        "api_s": api_s,
        "tmpl_s": tmpl_s,
        "batch_rate": nb / batch_s,
        "sweep_s": sweep_s,
    }


def main():
    from gf2bv_tpu.utils import device
    from gf2bv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    devs = device.require_gpu()
    log(json.dumps(device.device_record(devs)))
    log(device.card_line())
    r = bench_mt19937()
    print(json.dumps({
        "metric": "mt19937_19968var_solve_one_wall_clock",
        "value": r["solve_s"],
        "unit": "s",
        "vs_baseline": M4RI_BASELINE_EST_S / r["solve_s"],
        "device": device.device_record(devs),
        "detail": {
            "trace_s": r["trace_s"],
            "device_chained_solves_per_s": 1 / r["chain_s"],
            "public_api_solve_one_s": r["api_s"],
            "captured_trace_solve_one_s": r["tmpl_s"],
            "multi_rhs_recoveries_per_s_b256": r["batch_rate"],
            "sweep_candidates_per_s_flagship": 4096 / r["sweep_s"],
            "baseline": "M4RI single-core estimate 2.0 s (BASELINE.md; "
                        "the reference publishes no numbers)",
        },
    }))


if __name__ == "__main__":
    main()
