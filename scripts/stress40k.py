"""Beyond-flagship stress: a 39936-variable dense random system (2x the
MT19937 headline, 206 MB packed) built ON DEVICE (random A via threefry,
planted secret, b = A@x by popcount parity) and solved with the fused
mode-0 path.  Checks exact secret recovery and prints warm wall-clock.

Run: python scripts/stress40k.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import time

import numpy as np

import jax

from gf2bv_tpu.utils.cache import enable_persistent_cache
enable_persistent_cache()

import jax.numpy as jnp

from gf2bv_tpu.ops import gauss_blocked

COLS = 39936
ROWS = 40192


def main():
    rng = np.random.default_rng(0)
    secret_bits = jnp.asarray(rng.integers(0, 2, size=COLS).astype(np.uint32))
    wp = -(-(1 + COLS) // 32 // 128) * 128

    @jax.jit
    def build():
        key = jax.random.PRNGKey(0)
        a = jax.random.bits(key, (ROWS, wp), jnp.uint32)
        valid = (
            jnp.arange(wp)[:, None] * 32 + jnp.arange(32)[None, :]
        ) < (1 + COLS)
        wordmask = jnp.sum(
            valid.astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32)[None, :],
            axis=1,
        )
        a = a & wordmask[None, :]
        a = a.at[:, 0].set(a[:, 0] & ~jnp.uint32(1))  # clear const bit
        pos = 1 + jnp.arange(COLS)
        xw = jnp.zeros((wp,), jnp.uint32).at[pos >> 5].add(
            secret_bits << (pos & 31).astype(jnp.uint32)
        )
        par = (
            jnp.sum(
                jax.lax.population_count(a & xw[None, :]).astype(jnp.int32),
                axis=1,
            )
            & 1
        )
        return a.at[:, 0].set(a[:, 0] | par.astype(jnp.uint32))

    a_dev = build()
    _ = np.asarray(a_dev[0, :1])
    print(f"built on device: {a_dev.shape} "
          f"({a_dev.shape[0] * a_dev.shape[1] * 4 / 1e6:.0f} MB)",
          file=sys.stderr)

    t0 = time.perf_counter()
    o32, unsat = gauss_blocked.rref_origin_blocked(a_dev, COLS)
    _ = np.asarray(o32[:1])
    print(f"cold solve (incl compile): {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    t0 = time.perf_counter()
    o32, unsat = gauss_blocked.rref_origin_blocked(a_dev, COLS)
    o32h, unsath = jax.device_get((o32, unsat))
    dt = time.perf_counter() - t0
    assert not bool(unsath)
    got = (
        np.asarray(o32h)[np.arange(COLS) >> 5]
        >> (np.arange(COLS) & 31).astype(np.uint32)
    ) & 1
    assert np.array_equal(
        got.astype(np.uint8), np.asarray(secret_bits, dtype=np.uint8)
    ), "secret mismatch"
    print(f"warm solve: {dt:.3f}s — {COLS}-var system, secret recovered exactly")


if __name__ == "__main__":
    main()
