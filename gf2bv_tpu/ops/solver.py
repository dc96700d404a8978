"""Solver dispatch: route a packed GF(2) system to a backend.

The device-facing analog of the reference's single native entry point
``m4ri_solve(eqs, cols, mode)`` (``/root/reference/gf2bv/_internal.c:359``):

* mode 0 -> one particular solution as a raw int, or None if unsatisfiable
* mode 1 -> the full affine solution space, or None if unsatisfiable

Backends:
* ``jax``     — Gauss-Jordan on the default JAX device, gauss_jax.py
* ``blocked`` — panel-blocked elimination (large systems), gauss_blocked.py
* ``native``  — the C engine on the host CPU, _native/
* ``oracle``  — slow host numpy reference, gauss_ref.py

``auto`` (or None) picks blocked for large systems, jax otherwise — unless
the process is pinned to the host CPU (no accelerator), where the native C
engine beats XLA's CPU code for the device paths by 1-2 orders of
magnitude and is picked instead (opt out: GF2BV_TPU_CPU_NATIVE=0, which the
test suite sets so the device code paths stay covered on the virtual-device
mesh).  On a GPU the device paths are always taken.  Unknown backend names
raise instead of silently running the wrong engine.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import packing
from ..core.affine import AffineSpace

# Column count at or above which the panel-blocked solver wins over the
# per-pivot loop (the per-pivot loop is latency-bound at ~cols sequential
# steps; blocking amortizes them K_PANEL at a time).  Tuned on another
# machine, to re-measure (ROADMAP S3).
_BLOCKED_THRESHOLD = 1024

_BACKENDS = ("jax", "blocked", "native", "oracle")


def _cpu_pinned() -> bool:
    """True iff JAX runs on the host CPU.  Never initializes a backend when
    an accelerator platform is CONFIGURED (probing an unreachable
    accelerator can hang; ``import gf2bv_tpu`` and backend resolution must
    never do that) — but with platforms unset (auto-detect) and no backend
    initialized yet, asking jax.default_backend() is safe and is exactly
    what the imminent solve would do anyway; deciding from its answer keeps
    routing consistent for the whole process."""
    import jax

    p = jax.config.jax_platforms
    if p == "cpu":
        return True
    if p:  # an accelerator is explicitly configured: never probe it here
        return False
    try:
        from jax._src import xla_bridge

        db = xla_bridge._default_backend
        if db is not None:
            return db.platform == "cpu"
    except Exception:
        return False
    try:
        return jax.default_backend() == "cpu"
    except Exception:
        return False


def _cpu_prefers_native() -> bool:
    if os.environ.get("GF2BV_TPU_CPU_NATIVE", "1") == "0":
        return False
    if not _cpu_pinned():
        return False
    from .. import _native

    return _native.available()


def _resolve_backend(backend: str | None, cols: int) -> str:
    b = backend or os.environ.get("GF2BV_TPU_BACKEND")
    if not b or b == "auto":
        if _cpu_prefers_native():
            return "native"
        return "blocked" if cols >= _BLOCKED_THRESHOLD else "jax"
    if b not in _BACKENDS:
        raise ValueError(
            f"unknown backend {b!r}; expected one of {('auto',) + _BACKENDS}"
        )
    return b


def _auto_backend(cols: int) -> str:
    """Backward-compat shim: the resolved default backend for ``cols``."""
    return _resolve_backend(None, cols)


def solve(eqs: np.ndarray, cols: int, mode: int, backend: str | None = None):
    """eqs: packed (rows, W64) uint64 over 1+cols bits (bit 0 = const)."""
    from ..utils import profiling

    backend = _resolve_backend(backend, cols)
    with profiling.phase(f"solve[{backend}]"):
        return _solve(eqs, cols, mode, backend)


def solve_packed(eqs, cols: int, mode: int, backend: str | None = None):
    """Like :func:`solve`, but also accepts a DEVICE-resident (rows, W32)
    uint32 matrix (e.g. from ops/quad_device.py) — the system is then padded
    and solved without any host round-trip for the matrix data."""
    import jax
    import jax.numpy as jnp

    if isinstance(eqs, np.ndarray):
        eqs64 = eqs if eqs.dtype == np.uint64 else packing.from_u32(eqs)
        return solve(eqs64, cols, mode, backend)

    backend = _resolve_backend(backend, cols)
    from . import extract_device

    if backend not in ("blocked", "jax"):
        # host-only backends: pull the matrix back once
        return solve(packing.from_u32(np.asarray(eqs)), cols, mode, backend)

    if backend == "blocked":
        from .gauss_blocked import (
            K_PANEL, _pad_device, rref_blocked, rref_origin_blocked,
        )

        # 128-word alignment: see gauss_blocked.K_PANEL
        a = _pad_device(jnp.asarray(eqs, jnp.uint32), K_PANEL, 128)
        if mode == 0:
            origin32, unsat = jax.device_get(rref_origin_blocked(a, cols))
            if bool(unsat):
                return None
            return packing.words_to_int(packing.from_u32(origin32[None, :])[0])
        rref32, pof, inc = rref_blocked(a, cols)
    else:
        from .gauss_jax import _ROW_BUCKET, rref_device, rref_origin_device

        a = jnp.asarray(eqs, jnp.uint32)
        want = max(_ROW_BUCKET, -(-a.shape[0] // _ROW_BUCKET) * _ROW_BUCKET)
        if want != a.shape[0]:
            a = jnp.pad(a, ((0, want - a.shape[0]), (0, 0)))
        if mode == 0:
            origin32, unsat = jax.device_get(rref_origin_device(a, cols))
            if bool(unsat):
                return None
            return packing.words_to_int(packing.from_u32(origin32[None, :])[0])
        rref32, pof, inc = rref_device(a, cols)

    raw = extract_device.finalize(rref32, pof, inc, cols, mode)
    if raw is None:
        return None
    return AffineSpace(raw[0], raw[1], cols)


def _solve(eqs: np.ndarray, cols: int, mode: int, backend: str):

    if backend == "oracle":
        from .gauss_ref import solve_oracle

        res = solve_oracle(eqs, cols, mode)
        if not res.consistent:
            return None
        raw = (res.origin, res.basis)
    elif backend == "native":
        from .._native import solve_native

        raw = solve_native(eqs, cols, mode)
        if raw is None:
            return None
    elif backend == "blocked":
        from .gauss_blocked import solve_blocked

        raw = solve_blocked(eqs, cols, mode)
        if raw is None:
            return None
    else:
        from .gauss_jax import solve_jax

        raw = solve_jax(eqs, cols, mode)
        if raw is None:
            return None

    if mode == 0:
        origin = raw[0] if isinstance(raw, tuple) else raw
        return packing.words_to_int(origin)
    origin, basis = raw
    return AffineSpace(origin, basis, cols)
