"""Device-cached solving for lazily traced systems.

Pairs with core/lazy.py to give every model the flagship fast path through
the PUBLIC API (``LinearSystem.solve_one``), not just the hand-written
MT19937 program (crypto/mt_jax.py):

* The packed coefficient matrix of a traced zeros list is input-independent
  (XOR constants only touch the affine column), so it is materialized once
  per trace STRUCTURE, uploaded once, and cached on the device keyed by the
  DAG's structural hash.
* Per solve, only the tiny per-row affine delta crosses the host boundary
  (rows/8 bytes, ~2.5 KB for MT19937), and one fused jit XORs it into the
  affine column and runs the solver — the same single-dispatch shape as the
  hand-built fast path.

Reference semantics preserved: all-zero traced rows are dropped, a row that
reduces to the literal 1 makes the system unsatisfiable before any device
work (``/root/reference/gf2bv/__init__.py:214-233``), and the outputs are
identical to the eager route (RREF is unique).
"""

from __future__ import annotations

import functools
import os
from collections import OrderedDict

import numpy as np

import jax
import jax.numpy as jnp

from ..core import lazy, packing
from ..core.affine import AffineSpace
from ..core.lazy import LazyBitVec

_MAX_CACHED = int(os.environ.get("GF2BV_TPU_TRACE_CACHE", "4"))
_CACHE: "OrderedDict[bytes, _CachedSystem]" = OrderedDict()


class _CachedSystem:
    __slots__ = (
        "a_dev", "a_host", "kept", "kept_mask", "struct_aff", "widths",
        "rows_padded", "backend", "basis_cache",
    )


def _backend_for(system) -> str:
    from . import solver

    return solver._resolve_backend(system._backend, system._cols)


def eligible(system, zeros) -> bool:
    return (
        bool(zeros)
        and all(isinstance(z, LazyBitVec) for z in zeros)
        and _backend_for(system) in ("blocked", "jax", "native")
    )


def clear_cache() -> None:
    _CACHE.clear()


def _build(system, exprs, key) -> _CachedSystem:
    from .gauss_blocked import K_PANEL, _pad
    from .gauss_jax import _pad_rows

    cs = _CachedSystem()
    cs.backend = _backend_for(system)
    cs.widths = [e.width for e in exprs]

    mats = lazy.materialize_many(exprs, strip_consts=True)
    nw = packing.nwords64(1 + system._cols)
    stacked = np.concatenate(lazy.pad_mats_to_words(mats, nw), axis=0)
    cs.struct_aff = (stacked[:, 0] & np.uint64(1)).astype(np.uint8)
    # coefficient-nonzero test without copying the ~50 MB stacked matrix
    cs.kept_mask = (stacked[:, 0] & ~np.uint64(1)) != 0
    if stacked.shape[1] > 1:
        cs.kept_mask |= stacked[:, 1:].any(axis=1)
    cs.kept = np.flatnonzero(cs.kept_mask)

    eqs = stacked[cs.kept]  # struct affine bits stay in the matrix
    if cs.backend == "native":
        # host C engine: cache the stacked uint64 matrix as-is; each solve
        # swaps only the affine column (rref_native's aff_bits) and the
        # mode-1 kernel basis is affine-independent, so it is built once
        cs.a_host = np.ascontiguousarray(eqs)
        cs.basis_cache = {}
        cs.rows_padded = eqs.shape[0]
        cs.a_dev = None
    else:
        if cs.backend == "blocked":
            a32 = _pad(eqs, K_PANEL, word_align=128)
        else:
            a32 = _pad_rows(packing.to_u32(eqs), system._cols)
        cs.rows_padded = a32.shape[0]
        cs.a_dev = jnp.asarray(np.ascontiguousarray(a32))

    _CACHE[key] = cs
    while len(_CACHE) > _MAX_CACHED:
        _CACHE.popitem(last=False)
    return cs


@functools.partial(jax.jit, static_argnums=(2,))
def _fused0_blocked(a, delta, cols):
    from .gauss_blocked import rref_origin_blocked

    return rref_origin_blocked(a.at[:, 0].set(a[:, 0] ^ delta), cols)


@functools.partial(jax.jit, static_argnums=(2,))
def _fused1_blocked(a, delta, cols):
    from .gauss_blocked import rref_blocked

    return rref_blocked(a.at[:, 0].set(a[:, 0] ^ delta), cols)


@functools.partial(jax.jit, static_argnums=(2,))
def _fused0_jax(a, delta, cols):
    from .gauss_jax import rref_origin_device

    return rref_origin_device(a.at[:, 0].set(a[:, 0] ^ delta), cols)


@functools.partial(jax.jit, static_argnums=(2,))
def _fused1_jax(a, delta, cols):
    from .gauss_jax import rref_device

    return rref_device(a.at[:, 0].set(a[:, 0] ^ delta), cols)


def _affine_vector(exprs, widths, env=None) -> np.ndarray:
    """Stacked per-row affine bits for THIS instance, (total_rows,) uint8."""
    vals = lazy.affine_many(exprs, env)
    parts = [packing.mask_bits(w, v) for v, w in zip(vals, widths)]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def cached_system(system, zeros) -> "_CachedSystem":
    """The device-cached coefficient structure for a lazy zeros list,
    building (and LRU-inserting) it on first sight."""
    exprs = [z._expr for z in zeros]
    # the backend is part of the key: a cache hit must not keep a stale
    # backend after a GF2BV_TPU_BACKEND change
    key = lazy.struct_key(
        exprs, extra=lazy._ints(system._cols) + _backend_for(system).encode()
    )
    cs = _CACHE.get(key)
    if cs is None:
        cs = _build(system, exprs, key)
    else:
        _CACHE.move_to_end(key)
    return cs


def solve_lazy(system, zeros, mode: int, env=None):
    """The fused fast path.  Same return contract as ops.solver.solve.
    ``env`` binds captured-trace Params (core/lazy.Param) per instance."""
    from . import extract_device

    cols = system._cols
    exprs = [z._expr for z in zeros]
    cs = cached_system(system, zeros)

    aff = _affine_vector(exprs, cs.widths, env)
    # a dropped (zero-coefficient) row with its affine bit set is the
    # literal 1 -> unsatisfiable before any device work (ref :231-233)
    if np.any(aff & ~cs.kept_mask):
        return None

    if cs.backend == "native":
        from .._native import solve_native

        res = solve_native(
            cs.a_host, cols, mode, aff_bits=aff[cs.kept],
            basis_cache=cs.basis_cache,
        )
        if res is None:
            return None
        if mode == 0:
            return packing.words_to_int(res)
        return AffineSpace(res[0], res[1], cols)

    delta = (aff[cs.kept] ^ cs.struct_aff[cs.kept]).astype(np.uint32)
    if delta.shape[0] < cs.rows_padded:
        delta = np.pad(delta, (0, cs.rows_padded - delta.shape[0]))
    delta_dev = jnp.asarray(delta)

    if mode == 0:
        if cs.backend == "blocked":
            origin32, unsat = jax.device_get(
                _fused0_blocked(cs.a_dev, delta_dev, cols)
            )
        else:
            origin32, unsat = jax.device_get(
                _fused0_jax(cs.a_dev, delta_dev, cols)
            )
        if bool(unsat):
            return None
        return packing.words_to_int(packing.from_u32(origin32[None, :])[0])

    if cs.backend == "blocked":
        rref32, pof, inc = _fused1_blocked(cs.a_dev, delta_dev, cols)
    else:
        rref32, pof, inc = _fused1_jax(cs.a_dev, delta_dev, cols)
    raw = extract_device.finalize(rref32, pof, inc, cols, mode)
    if raw is None:
        return None
    return AffineSpace(raw[0], raw[1], cols)
