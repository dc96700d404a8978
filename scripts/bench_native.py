"""Single-core native-engine sweep over the macro-panel width (-DNSUB).

Times gf2_rref at the MT19937 flagship shape (20224 x 19969) for NSUB in
{1, 2, 4, 8} — NSUB*8-column macro-panels with NSUB fused XOR tables per
bulk pass.  The bulk update is memory-bandwidth-bound, so sweeps over the
matrix scale ~1/NSUB until table reads (NSUB * 256 * W words, cache-
resident) stop being free.  The reference pays the equivalent cost inside
libm4ri's mzd_echelonize_m4ri (/root/reference/gf2bv/_internal.c:359-502).

Pure host benchmark — no accelerator needed.  Run: python scripts/bench_native.py
"""

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "gf2bv_tpu" / "_native" / "native.c"

ROWS, COLS = 20224, 19969  # MT19937 system shape (624*32 + guard, 19968+1)


def build(nsub: int) -> ctypes.CDLL:
    so = Path(tempfile.gettempdir()) / f"libgf2native_nsub{nsub}.so"
    subprocess.run(
        ["gcc", "-O3", "-march=native", "-funroll-loops", "-fopenmp",
         f"-DNSUB={nsub}", "-shared", "-fPIC", "-o", str(so), str(SRC)],
        check=True, capture_output=True, timeout=120,
    )
    L = ctypes.CDLL(str(so))
    L.gf2_rref.restype = ctypes.c_int64
    L.gf2_rref.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return L


def run(L, a_src, trailing: int):
    rows, w_alloc = a_src.shape
    a = a_src.copy()
    pof = np.full(COLS, -1, dtype=np.int32)
    used = np.zeros(rows, dtype=np.uint8)
    t0 = time.perf_counter()
    rank = L.gf2_rref(a.ctypes.data, rows, w_alloc, COLS,
                      pof.ctypes.data, used.ctypes.data, trailing)
    return time.perf_counter() - t0, rank, a


def main():
    rng = np.random.default_rng(0xC0)
    nw = (1 + COLS + 63) // 64
    a = rng.integers(0, 1 << 63, size=(ROWS, nw + 1), dtype=np.uint64) * 2 + 1
    a[:, -1] = 0  # pad word
    top = (1 + COLS) % 64
    if top:
        a[:, nw - 1] &= (np.uint64(1) << np.uint64(top)) - np.uint64(1)

    ref_rref = None
    for nsub in (1, 2, 4, 8):
        L = build(nsub)
        t_tr, rank_tr, _ = run(L, a, trailing=1)
        t_full, rank_full, rref = run(L, a, trailing=0)
        # cross-variant bit-exactness: full RREF is unique
        status = ""
        if ref_rref is None:
            ref_rref = rref
        elif not np.array_equal(rref, ref_rref):
            status = "  ** MISMATCH vs NSUB=1 **"
        print(f"NSUB={nsub}: trailing {t_tr:6.3f} s  full {t_full:6.3f} s  "
              f"rank={rank_tr}/{rank_full}{status}", flush=True)


if __name__ == "__main__":
    main()
