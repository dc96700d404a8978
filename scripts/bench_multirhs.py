"""Multi-RHS device-rate sweep across the tile buckets.

One elimination carries up to MAX_RHS=32768 instances as appended 128-word
RHS tiles (ops/multi_rhs.py; 8 tiles since round 5).  This measures the
device rate (inputs resident, tiny forced readback) at B = 1024 ... 32768 — the
expected curve is "~one elimination" per batch: the appended tiles widen
the augmented matrix 768 -> 896 -> 1152 words, so the per-elimination time
grows ~1.5x from first to last bucket while the instance count grows 16x.
The reference pays one full PLUQ per instance
(/root/reference/gf2bv/_internal.c:359-502).
"""

import random
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from gf2bv_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

from gf2bv_tpu import LinearSystem
from gf2bv_tpu.core import packing
from gf2bv_tpu.crypto import mt_jax
from gf2bv_tpu.crypto.mt import MT19937
from gf2bv_tpu.ops import lazy_solve, multi_rhs

SAMPLES, BS = 624, 32


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    r = fn()
    return time.perf_counter() - t0, r


def main():
    log(f"devices: {jax.devices()}")
    lin = LinearSystem([32] * 624)

    def mt_model(ws, p):
        sym = MT19937(list(ws))
        return [sym.getrandbits(BS) ^ p[i] for i in range(SAMPLES)] + [
            ws[0] ^ 0x80000000
        ]

    tmpl = lin.capture(mt_model)
    cs = lazy_solve.cached_system(lin, tmpl.zeros)
    exprs = [z._expr for z in tmpl.zeros]

    for nb in (1024, 4096, 8192, 16384, 32768):
        batch, states = [], []
        for k in range(nb):
            r = random.Random(77_000 + k)
            states.append(tuple(r.getstate()[1][:-1]))
            batch.append([r.getrandbits(32) for _ in range(SAMPLES)])
        affs = tmpl._affine_matrix(exprs, cs.widths, batch)
        bw = multi_rhs._bw_for(nb)
        rhs_dev = jnp.asarray(
            multi_rhs._pack_rhs(affs[:, cs.kept], cs.a_dev.shape[0], bw)
        )
        _ = np.asarray(rhs_dev[:1, :1])  # upload outside the timed region

        def dev_solve():
            _, _, origins, unsat = multi_rhs.solve_multi_rhs_device(
                cs.a_dev, mt_jax.COLS, rhs_dev, bw
            )
            _ = np.asarray(unsat[:1])  # force the fused executable
            return origins

        t0 = time.perf_counter()
        origins = dev_solve()  # compile + warm
        log(f"B={nb}: first call {time.perf_counter() - t0:.1f}s "
            f"(aug width {cs.a_dev.shape[1] + multi_rhs._tiles_for(bw) * 128}"
            f" words)")
        ts = sorted(_timed(dev_solve)[0] for _ in range(3))
        rate = nb / ts[0]
        log(f"B={nb}: best {ts[0]:.3f}s of {[round(t, 3) for t in ts]} = "
            f"{rate:.0f} recoveries/s/chip")
        # honest full-origin extraction cost at this scale: the D2H of all
        # B origins (B x Wsol32 u32) through whatever link this host has
        d2h, _ = _timed(lambda: jax.device_get(origins))
        mb = origins.size * 4 / 1e6
        log(f"B={nb}: full-origin D2H {d2h:.3f}s for {mb:.1f} MB "
            f"(e2e rate incl. extraction: {nb / (ts[0] + d2h):.0f}/s)")

        # spot-verify 4 sampled instances against their known states
        ow = np.asarray(origins)
        w32 = 2 * packing.nwords64(mt_jax.COLS)
        for k in (0, nb // 3, nb // 2, nb - 1):
            got = packing.from_u32(ow[k][None, :w32])[0]
            s = packing.words_to_int(got)
            sol = [(s >> (32 * i)) & 0xFFFFFFFF for i in range(624)]
            assert tuple(sol) == states[k], f"instance {k} mismatch"
        log(f"B={nb}: sampled round-trips verified")


if __name__ == "__main__":
    main()
