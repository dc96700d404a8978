"""ctypes loader for the native host engine (native.c).

Plays the role of the reference's C extension + libm4ri on hosts without an
accelerator (``/root/reference/gf2bv/_internal.c:359-502`` / ``setup.py:55-73``) —
a from-scratch M4R-family engine, no m4ri code.

Builds the shared library variants on demand (single-file gcc compiles,
cached next to the source keyed by mtime) and exposes numpy-friendly
wrappers.  Everything
degrades gracefully: ``lib()`` returns None if no compiler is available and
callers fall back to the pure-numpy/JAX paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "native.c"
# Two engine variants: the bulk-update macro-panel width (NSUB 8-bit
# tables per pass) trades per-panel overhead against matrix sweeps, and
# the optimum is shape-dependent — measured single-core: NSUB=2 wins below
# a few thousand columns, NSUB=8 at flagship scale (scripts/bench_native.py
# + the MT19937 numbers in BASELINE.md).  `lib()` picks by column count.
_NSUB_SMALL, _NSUB_LARGE = 2, 8
_NSUB_SPLIT_COLS = 4096
_LIBS: dict = {}  # nsub -> CDLL | False


def _compile(nsub: int, so: Path) -> None:
    """gcc into a private file next to ``so``, then rename it into place:
    concurrent processes (pytest workers) never load a half-written
    library."""
    part = so.with_name(f"{so.stem}.{os.getpid()}.part.so")
    cmd = [
        "gcc", "-O3", "-march=native", "-funroll-loops", "-fopenmp",
        f"-DNSUB={nsub}", "-shared", "-fPIC", "-o", str(part), str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(part, so)
    finally:
        part.unlink(missing_ok=True)


def _build(nsub: int) -> Path | None:
    so = _HERE / f"libgf2native_n{nsub}.so"
    if so.exists() and so.stat().st_mtime >= _SRC.stat().st_mtime:
        return so
    try:
        _compile(nsub, so)
        return so
    except Exception:
        # read-only package dir or missing gcc: try a temp dir
        try:
            tmp = Path(tempfile.gettempdir()) / (
                f"libgf2native_n{nsub}_{os.getuid()}.so"
            )
            _compile(nsub, tmp)
            return tmp
        except Exception:
            return None


def lib(cols: int | None = None) -> ctypes.CDLL | None:
    """The engine variant for a system of ``cols`` columns (default: the
    flagship/large variant)."""
    nsub = _NSUB_SMALL if (cols is not None and cols < _NSUB_SPLIT_COLS) \
        else _NSUB_LARGE
    L = _LIBS.get(nsub)
    if L is None:
        so = _build(nsub)
        if so is None:
            L = False
        else:
            L = ctypes.CDLL(str(so))
            L.gf2_rref.restype = ctypes.c_int64
            L.gf2_rref.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,
            ]
            L.gf2_inconsistent.restype = ctypes.c_int
            L.gf2_inconsistent.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            L.gf2_verify.restype = ctypes.c_int
            L.gf2_verify.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            L.gf2_enumerate.restype = None
            L.gf2_enumerate.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p,
            ]
        _LIBS[nsub] = L
    return L or None


def available() -> bool:
    # probe BOTH variants: solve paths pick by column count, so a guard
    # that only checked one could pass while the other build fails
    return lib() is not None and lib(1) is not None


def rref_native(eqs: np.ndarray, cols: int, trailing: bool = False,
                aff_bits: np.ndarray | None = None):
    """In-place-free native RREF.  eqs: (rows, W64) uint64 packed.

    Returns (rref (rows, W64), pof (cols,) int32, inconsistent bool|None).
    trailing=True is the mode-0 fast path (~2x less memory traffic): the
    matrix is then NOT a full RREF in the free columns and satisfiability is
    NOT determined — the flag comes back as None (never False) and callers
    must verify the candidate solution (see solve_native).
    ``aff_bits``: optional (rows,) per-instance affine bits that REPLACE
    bit 0 of each row (the lazy-trace fast path keeps one structural matrix
    cached and swaps only this column per solve, ops/lazy_solve.py)."""
    L = lib(cols)
    assert L is not None, "native backend unavailable (no gcc?)"
    rows, w = eqs.shape
    a = np.empty((rows, w + 1), dtype=np.uint64)  # +1 pad word for strip8
    a[:, :w] = eqs
    a[:, w] = 0  # only the pad column needs zeroing (np.zeros pays a
    # full-matrix clear, ~15 ms at flagship shape)
    if aff_bits is not None:
        a[:, 0] = (a[:, 0] & ~np.uint64(1)) | (
            np.asarray(aff_bits, np.uint64) & np.uint64(1)
        )
    pof = np.full(cols, -1, dtype=np.int32)
    used = np.zeros(rows, dtype=np.uint8)
    L.gf2_rref(
        a.ctypes.data, rows, w + 1, cols, pof.ctypes.data, used.ctypes.data,
        int(trailing),
    )
    inconsistent = None if trailing else bool(
        L.gf2_inconsistent(a.ctypes.data, rows, w + 1, cols)
    )
    return a[:, :w], pof, inconsistent


def enumerate_native(
    origin: np.ndarray, basis: np.ndarray, start: int, count: int, gray: bool
) -> np.ndarray:
    """Batched affine enumeration on the host (OpenMP)."""
    L = lib()
    assert L is not None
    w = origin.shape[0]
    out = np.empty((count, w), dtype=np.uint64)
    basis = np.ascontiguousarray(basis, dtype=np.uint64)
    origin = np.ascontiguousarray(origin, dtype=np.uint64)
    L.gf2_enumerate(
        origin.ctypes.data, basis.ctypes.data, basis.shape[0], w,
        ctypes.c_uint64(start), count, int(gray), out.ctypes.data,
    )
    return out


def solve_native(eqs: np.ndarray, cols: int, mode: int,
                 aff_bits: np.ndarray | None = None,
                 basis_cache: dict | None = None):
    """m4ri_solve-shaped entry on the native engine (solver.py contract).

    mode 0 runs the trailing update (~2x faster) and verifies the candidate
    origin against the ORIGINAL system by row parity (exactly the device
    fused-path contract); mode 1 needs the free columns and does the full
    update.

    ``aff_bits``: per-instance affine bits replacing bit 0 of each row (see
    rref_native) — the verification then checks against the replaced column.
    ``basis_cache``: caller-held dict; the mode-1 kernel basis depends only
    on the coefficient columns (never on the affine column), so repeated
    solves of one cached structure build it once (ops/lazy_solve.py)."""
    from ..core import packing
    from ..ops import extract

    rref, pof, inconsistent = rref_native(
        eqs, cols, trailing=(mode == 0), aff_bits=aff_bits
    )
    if inconsistent:
        return None
    pivot_cols = np.nonzero(pof >= 0)[0].astype(np.int64) + 1
    pivot_rows = rref[pof[pivot_cols - 1]]
    origin = extract.build_origin(pivot_rows, pivot_cols, cols)
    if mode == 0:
        xfull = packing.int_to_words(
            (packing.words_to_int(origin) << 1) | 1, 1 + cols
        )
        eqs = np.ascontiguousarray(eqs)
        xfull = np.ascontiguousarray(xfull[: eqs.shape[1]])
        affp = (
            np.ascontiguousarray(aff_bits, np.uint8)
            if aff_bits is not None else None
        )
        L2 = lib(cols)
        ok = L2.gf2_verify(
            eqs.ctypes.data, eqs.shape[0], eqs.shape[1], xfull.shape[0],
            xfull.ctypes.data,
            affp.ctypes.data if affp is not None else None,
        )
        if not ok:
            return None  # unsat (or any engine bug): origin does not satisfy
        return origin
    if basis_cache is not None:
        if "basis" not in basis_cache:
            basis_cache["basis"] = extract.build_basis(
                pivot_rows, pivot_cols, cols
            )
        return origin, basis_cache["basis"]
    return origin, extract.build_basis(pivot_rows, pivot_cols, cols)


def solve_multi_rhs_native(eqs: np.ndarray, cols: int, rhs_bits: np.ndarray,
                           mode: int = 0, basis_cache: dict | None = None):
    """Host multi-RHS: solve the SAME coefficient matrix for many affine
    columns with ONE ``gf2_rref`` — the native twin of
    ``ops.multi_rhs.solve_multi_rhs`` (same contract: the matrix's own
    bit-0 affine column is inert and ignored; one entry per instance, a raw
    int / AffineSpace / None; all mode-1 instances share one basis).

    The appended per-instance RHS words sit past the coefficient words, so
    the elimination carries them along untouched by pivot selection; the
    reference pays one full PLUQ per instance (``_internal.c:359-502``).
    ``basis_cache``: caller-held dict so chunk loops over the same matrix
    build the (chunk-invariant) mode-1 basis at most once.
    """
    from ..core import packing
    from ..core.affine import AffineSpace
    from ..ops import extract

    L = lib(cols)
    assert L is not None, "native backend unavailable (no gcc?)"
    eqs = np.asarray(eqs, np.uint64)
    rows, w = eqs.shape
    rhs_bits = np.asarray(rhs_bits, np.uint8)
    B = rhs_bits.shape[0]
    assert rhs_bits.shape[1] == rows, "one affine bit per row per instance"
    bw = (B + 63) // 64

    # np.empty + explicit region fills: every word is assigned below, and
    # zeroing 50 MB first costs ~25 ms at flagship shape
    a = np.empty((rows, w + bw + 1), dtype=np.uint64)  # +1 pad word
    a[:, :w] = eqs
    a[:, w + bw] = 0
    a[:, 0] &= ~np.uint64(1)  # inert own-affine column
    # instance k's bit -> word w + (k>>6), bit k&63 (little-endian host);
    # pack in 512-instance chunks so the strided pack stays cache-resident
    # (the same fix as ops/multi_rhs._pack_rhs)
    rhs8 = np.zeros((rows, bw * 8), dtype=np.uint8)
    for lo in range(0, B, 512):
        pk = np.packbits(rhs_bits[lo : lo + 512], axis=0, bitorder="little")
        rhs8[:, lo // 8 : lo // 8 + pk.shape[0]] = pk.T
    a[:, w : w + bw] = rhs8.view(np.uint64)

    pof = np.full(cols, -1, dtype=np.int32)
    used = np.zeros(rows, dtype=np.uint8)
    L.gf2_rref(a.ctypes.data, rows, a.shape[1], cols,
               pof.ctypes.data, used.ctypes.data, 0)

    pivot_cols = np.nonzero(pof >= 0)[0].astype(np.int64) + 1
    prows = a[pof[pivot_cols - 1]] if pivot_cols.size else a[:0]

    # instance k unsatisfiable <=> some row with an empty coefficient part
    # still carries its RHS bit (the multi-column 0*x = 1)
    dead = ~a[:, :w].any(axis=1)
    if dead.any():
        unsat_words = np.bitwise_or.reduce(a[dead, w : w + bw], axis=0)
    else:
        unsat_words = np.zeros(bw, dtype=np.uint64)

    # origin_k: RHS-column-k bits of the pivot rows, scattered to pivot cols
    bits = np.unpackbits(
        prows[:, w : w + bw].copy().view(np.uint8), axis=1,
        bitorder="little",
    )[:, :B]  # (rank, B)
    xs = np.zeros((B, cols), dtype=np.uint8)
    if pivot_cols.size:
        xs[:, pivot_cols - 1] = bits.T
    origins = packing.pack_bits(xs, cols)  # (B, Wsol)

    bcache = basis_cache if basis_cache is not None else {}
    out = []
    for k in range(B):
        if (int(unsat_words[k >> 6]) >> (k & 63)) & 1:
            out.append(None)
            continue
        if mode == 0:
            out.append(packing.words_to_int(origins[k]))
        else:
            if "basis" not in bcache:
                bcache["basis"] = extract.build_basis(
                    prows, pivot_cols, cols
                )
            out.append(AffineSpace(origins[k], bcache["basis"], cols))
    return out
