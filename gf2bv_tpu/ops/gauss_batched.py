"""Many flagship-size systems in one device program.

The batch axis for wide systems (independent MT19937-scale recoveries per
device); small systems keep using the vmapped per-pivot kernel
(parallel/batch.py), which wins below the blocked threshold.

* mode 0 — :func:`solve_chained`: a device-chained ``lax.scan`` of the
  single-system fused solver (gauss_blocked.rref_origin_blocked).  One
  dispatch and one stacked (B, W32) origin readback per batch.
* mode 1 — :func:`solve_batched`: a ``lax.map`` of the single-system
  blocked RREF (:func:`rref_blocked_batched`), then one batched
  extraction (extract_device.finalize_batch).

Every per-instance result is bit-identical to a single solve (RREF is
unique).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core import packing
from .gauss_blocked import K_PANEL, _ROW_BUCKET, rref_blocked, rref_origin_blocked


def padded_batch_dims(rows_max: int, w64: int) -> tuple[int, int]:
    """(rows_pad, wp32): the per-system dims the batched solvers actually
    allocate — the ONE place this arithmetic lives, so callers' memory
    estimates (parallel/batch.py's device-OOM guard) stay in lock-step."""
    rows_pad = max(_ROW_BUCKET, -(-rows_max // _ROW_BUCKET) * _ROW_BUCKET)
    walign = max(K_PANEL // 32, 128)
    wp = -(-(2 * w64) // walign) * walign
    return rows_pad, wp


def _stack(eq_mats):
    """A list of packed (rows_i, W64) systems, or a (B, rows, W32) array,
    as one zero-padded (B, rows_pad, wp) u32 device array."""
    if not isinstance(eq_mats, (list, tuple)):
        return jnp.asarray(eq_mats, jnp.uint32)
    rows_max = max(m.shape[0] for m in eq_mats)
    rows_pad, wp = padded_batch_dims(rows_max, eq_mats[0].shape[1])
    a = np.zeros((len(eq_mats), rows_pad, wp), np.uint32)
    for i, m in enumerate(eq_mats):
        a32 = packing.to_u32(m)
        a[i, : a32.shape[0], : a32.shape[1]] = a32
    return jnp.asarray(a)


@functools.partial(jax.jit, static_argnums=(1, 2))
def rref_blocked_batched(a: jnp.ndarray, cols: int, k_panel: int = K_PANEL):
    """Blocked RREF of each system of a (B, rows, wp) u32 stack, one after
    another in one program.  Returns (rref (B, rows, wp), pof (B, cols),
    inconsistent (B,)), each entry equal to gauss_blocked.rref_blocked's."""
    return lax.map(lambda m: rref_blocked(m, cols, k_panel), a)


def solve_batched(eq_mats, cols: int, mode: int):
    """Batched large-system solve (host entry, gauss_blocked.solve_blocked
    contract per instance): eq_mats is a list of packed (rows_i, W64)
    systems or a (B, rows, W32) array.  Returns one entry per system."""
    from . import extract_device

    if mode == 0:
        return solve_chained(eq_mats, cols)
    rref32, pof, inconsistent = rref_blocked_batched(_stack(eq_mats), cols)
    return extract_device.finalize_batch(rref32, pof, inconsistent, cols, mode)


# LRU-bounded: each entry retains a compiled executable sized by the full
# (B, rows_pad, wp) batch shape, so a caller sweeping batch sizes must not
# accumulate one program per shape for the process lifetime (the lazy
# trace cache is bounded the same way, ops/lazy_solve.py).
_CHAIN_CACHE_MAX = 8
_chain_cache: dict = {}


def solve_chained(eq_mats, cols: int):
    """Mode-0 batch as a device-chained ``lax.scan`` of the SINGLE-system
    fused solver (gauss_blocked.rref_origin_blocked per step): one
    dispatch, one stacked (B, W32) origin readback.  Input/return contract
    matches ``solve_batched`` mode 0.
    """
    a = _stack(eq_mats)
    key = (a.shape, cols)
    fn = _chain_cache.pop(key, None)
    if fn is None:

        def chained(a):
            def body(carry, ai):
                return carry, rref_origin_blocked(ai, cols)

            _, (origins, unsat) = lax.scan(body, 0, a)
            return origins, unsat

        fn = jax.jit(chained)
    _chain_cache[key] = fn  # (re)insert at the tail = most recently used
    while len(_chain_cache) > _CHAIN_CACHE_MAX:
        _chain_cache.pop(next(iter(_chain_cache)))
    origins, unsat = jax.device_get(fn(a))
    return [
        None if bool(unsat[b]) else packing.from_u32(origins[b][None, :])[0]
        for b in range(a.shape[0])
    ]
