"""Scaling benchmarks beyond the driver's single headline metric.

Measures (a) batched solves/s on the available devices (the data-parallel
axis: N independent same-shape systems per device step) and (b) row-sharded
solve time vs single-device on the same system.  With one device the
multi-device numbers come from whatever mesh JAX offers (a virtual CPU
mesh validates the scaling shape, not absolute speed).

Prints one JSON line per measurement on stdout.
"""

from __future__ import annotations

import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_batched(n_sys=1024, rows=320, cols=256, reps=5):
    # n_sys must be large enough to amortize the per-batch fixed cost (the
    # 256 sequential pivot steps run once per batch regardless of B).
    # rows=320 matches the native-C bar workload recorded in BASELINE.md.
    import numpy as np

    import jax
    from gf2bv_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    from gf2bv_tpu.core import packing
    from gf2bv_tpu.parallel import batch as pbatch
    from gf2bv_tpu.parallel import mesh as meshlib

    rng = np.random.default_rng(0)
    mats = []
    for _ in range(n_sys):
        secret = rng.integers(0, 2, size=cols).astype(np.uint8)
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        rhs = (coeff @ secret) % 2
        bits = np.concatenate([rhs[:, None], coeff], axis=1)
        mats.append(packing.pack_bits(bits, 1 + cols))

    mesh = meshlib.make_mesh()  # all devices on the batch axis
    # warm-up
    res = pbatch.solve_batch(mats, cols, 0, mesh=mesh)
    assert all(r is not None for r in res)
    t0 = time.perf_counter()
    for _ in range(reps):
        pbatch.solve_batch(mats, cols, 0, mesh=mesh)
    dt = (time.perf_counter() - t0) / reps
    rate = n_sys / dt
    print(
        json.dumps(
            {
                "metric": f"batched_solves_per_s_{cols}cols_{jax.device_count()}dev",
                "value": round(rate, 1),
                "unit": "solves/s",
                "vs_baseline": None,
            }
        )
    )

    # device-only rate: batch pre-uploaded, rref + batched origin, one tiny
    # readback; the native C bar on this workload is ~3.2k solves/s/core
    # (BASELINE.md)
    import jax.numpy as jnp

    from gf2bv_tpu.ops import extract_device

    a = jnp.asarray(pbatch.pack_batch(mats, cols))
    r32, pof, _ = pbatch._rref_batched(a, cols)
    o = extract_device._origin_batch(r32, pof, cols)
    _ = np.asarray(o[0, :1])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        r32, pof, _ = pbatch._rref_batched(a, cols)
        o = extract_device._origin_batch(r32, pof, cols)
        _ = np.asarray(o[0, :1])
        best = min(best, time.perf_counter() - t0)
    # NOTE on boundaries: this rate is DEVICE-ONLY (batch pre-uploaded,
    # B-amortized, single-element readback); the 3245 solves/s bar is the
    # native C engine's END-TO-END single-core rate on the same 320x256
    # workload (BASELINE.md "native C batch bar").  The upload-inclusive
    # rate is printed too.
    NATIVE_E2E_RATE = 3245.0  # solves/s/core, BASELINE.md round-2 table
    t0 = time.perf_counter()
    a2 = jnp.asarray(pbatch.pack_batch(mats, cols))
    r32, pof, _ = pbatch._rref_batched(a2, cols)
    o = extract_device._origin_batch(r32, pof, cols)
    _ = np.asarray(o[0, :1])
    upload_incl = n_sys / (time.perf_counter() - t0)
    print(
        json.dumps(
            {
                "metric": f"batched_device_rate_{cols}cols",
                "value": round(n_sys / best, 1),
                "unit": "solves/s (device-only)",
                "vs_baseline": round(n_sys / best / NATIVE_E2E_RATE, 2),
                "detail": {
                    "boundary": "device-only rate vs native C end-to-end "
                    "single-core rate (3245/s, BASELINE.md)",
                    "upload_inclusive_rate": round(upload_incl, 1),
                },
            }
        )
    )
    return rate


def bench_rowsharded(rows=4096, cols=2048):
    import numpy as np

    import jax

    from gf2bv_tpu.core import packing
    from gf2bv_tpu.ops import solver
    from gf2bv_tpu.parallel import mesh as meshlib
    from gf2bv_tpu.parallel.rowshard_blocked import solve_rowsharded_blocked

    rng = np.random.default_rng(1)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)

    n = jax.device_count()
    mesh = meshlib.make_mesh(batch=1, rows=n)
    got = solve_rowsharded_blocked(eqs, cols, 0, mesh)  # warm-up + correctness
    want = solver.solve(eqs, cols, 0, backend="jax")
    assert packing.words_to_int(got) == want

    t0 = time.perf_counter()
    solve_rowsharded_blocked(eqs, cols, 0, mesh)
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.solve(eqs, cols, 0, backend="jax")
    single_s = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "metric": f"rowsharded_blocked_{cols}cols_{n}dev_vs_single",
                "value": round(sharded_s, 4),
                "unit": "s",
                "vs_baseline": round(single_s / sharded_s, 3),
            }
        )
    )




def bench_enumeration(dim=20, cols=256):
    """On-device affine-space enumeration rate (replaces the reference's
    sequential Gray-code iterator, _internal.c:61-175)."""
    import numpy as np

    import jax.numpy as jnp

    from gf2bv_tpu.ops.enumerate import enumerate_points

    rng = np.random.default_rng(2)
    w32 = -(-cols // 32)
    origin = jnp.asarray(rng.integers(0, 2**32, w32, dtype=np.uint32))
    basis = jnp.asarray(rng.integers(0, 2**32, (dim, w32), dtype=np.uint32))
    chunk = 65536
    total = 1 << dim
    out = enumerate_points(origin, basis, jnp.uint32(0), jnp.uint32(0), chunk, True)
    _ = np.asarray(out[0, :1])  # warm + force
    t0 = time.perf_counter()
    outs = [
        enumerate_points(
            origin, basis, jnp.uint32(s & 0xFFFFFFFF), jnp.uint32(s >> 32), chunk, True
        )
        for s in range(0, total, chunk)
    ]
    for o in outs:
        _ = np.asarray(o[0, :1])
    dt = time.perf_counter() - t0
    rate = total / dt
    print(
        json.dumps(
            {
                "metric": f"affine_enumeration_points_per_s_dim{dim}",
                "value": round(rate),
                "unit": "points/s",
                "vs_baseline": None,
            }
        )
    )


if __name__ == "__main__":
    import jax

    log(f"devices: {jax.devices()}")
    bench_batched()
    bench_rowsharded()
    bench_enumeration()
