"""Phase attribution of the flagship guess sweep (round 5).

The warm flagship sweep (bench_sweep.py section B) costs far more than
the augmented elimination inside it; this breaks the warm call into its host/transfer/device phases so the optimization target is a
measurement, not a guess:

  build     : materialize guesses + concatenate base/guess rows (host)
  upload    : jnp.asarray of the padded ~50 MB coefficient matrix (H2D)
  rhs       : (B, rows) affine-column build + _pack_rhs (host) + upload
  solve     : augmented elimination + multi-column extraction (device)
  readback  : origins32/unsat D2H
  to_int    : packed origin words -> Python ints (per candidate)
  convert   : LinearSystem.convert_sol per candidate (bigint split loop)

Run on a machine with a GPU: python scripts/bench_sweep_phases.py
"""

import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from gf2bv_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()


def log(*a):
    print(*a, flush=True)


class T:
    def __init__(self):
        self.t = time.perf_counter()
        self.phases = []

    def mark(self, name):
        now = time.perf_counter()
        self.phases.append((name, now - self.t))
        self.t = now


def main():
    import jax
    import jax.numpy as jnp

    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.core import packing
    from gf2bv_tpu.core.lazy import materialize_pending, pad_mats_to_words
    from gf2bv_tpu.crypto.mt import MT19937
    from gf2bv_tpu.ops import multi_rhs
    from gf2bv_tpu.ops.gauss_blocked import K_PANEL, _pad

    log(f"devices: {jax.devices()}")

    rand = random.Random(3142)
    out = [rand.getrandbits(32) for _ in range(624)]
    lin = LinearSystem([32] * 624)
    words = lin.gens()
    sym = MT19937(list(words))
    zeros = [sym.getrandbits(32) ^ o for o in out]
    guesses = [words[0][i] for i in range(12)]

    # one public-API warm pass so every executable is compiled/cached
    t0 = time.perf_counter()
    lin.solve_one_sweep(zeros, guesses)
    log(f"public-API warm pass: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lin.solve_one_sweep(zeros, guesses)
    log(f"public-API warm pass 2: {time.perf_counter() - t0:.2f} s")

    # -- phase-attributed replay of the same warm call ----------------------
    for rep in range(2):
        t = T()
        base = lin.get_eqs_packed(zeros)
        t.mark("get_eqs_packed(base)")
        guesses2 = list(guesses)
        materialize_pending(guesses2)
        gmats = []
        for g in guesses2:
            rows_g = pad_mats_to_words([g.rows], lin._nw)[0]
            nz = np.nonzero(rows_g.any(axis=1))[0]
            gmats.append(rows_g[nz])
        gmat = np.concatenate(gmats, axis=0)
        eqs = np.concatenate([base, gmat], axis=0)
        G, rows = gmat.shape[0], eqs.shape[0]
        t.mark("guess rows + concat")

        a_dev = jnp.asarray(_pad(eqs, K_PANEL, word_align=128))
        np.asarray(a_dev[0, :1])
        t.mark("upload coeff matrix")

        B = 1 << G
        ks = np.arange(B, dtype=np.uint64)
        bits = (
            (ks[:, None] >> np.arange(G, dtype=np.uint64)[None, :]) & 1
        ).astype(np.uint8)
        base_aff = (eqs[:, 0] & np.uint64(1)).astype(np.uint8)
        rhs = np.broadcast_to(base_aff, (B, rows)).copy()
        rhs[:, rows - G:] ^= bits
        t.mark("rhs bits build")

        bw = multi_rhs._bw_for(B)
        rhs_dev = jnp.asarray(
            multi_rhs._pack_rhs(rhs, a_dev.shape[0], bw)
        )
        np.asarray(rhs_dev[:1, :1])
        t.mark("rhs pack + upload")

        rref32, pof, origins_dev, unsat_dev = multi_rhs.solve_multi_rhs_device(
            a_dev, lin._cols, rhs_dev, bw
        )
        np.asarray(unsat_dev[:1])
        t.mark("device solve")

        origins32, unsat_words = jax.device_get((origins_dev, unsat_dev))
        t.mark("origins D2H")

        raws = []
        for k in range(B):
            if (unsat_words[k >> 5] >> (k & 31)) & 1:
                raws.append(None)
                continue
            origin = packing.from_u32(origins32[k][None, :])[0]
            raws.append(packing.words_to_int(origin))
        t.mark("words -> int")

        sols = [None if r is None else lin.convert_sol(r) for r in raws]
        t.mark("convert_sol")

        total = sum(d for _, d in t.phases)
        log(f"replay {rep}: total {total:.3f} s")
        for name, d in t.phases:
            log(f"    {name:24s} {d * 1e3:9.1f} ms  {100 * d / total:5.1f}%")
        nsol = sum(s is not None for s in sols)
        log(f"    satisfiable candidates: {nsol}")


if __name__ == "__main__":
    main()
