"""Smoke run of the GF(2) solver on a GPU, through the entry points a user
calls, at the flagship width: MT19937 state cloning (19968 unknowns from
624 outputs plus the known-MSB equation, the reference's own example).

    python chip_smoke.py          # one card: every one-card phase
    python chip_smoke.py --four   # four cards: the sharded paths only

One process; a missing GPU is fatal (JAX is pinned to CUDA before it is
imported).  Every comparison is exact: RREF is unique and the device
arithmetic is u32 AND/XOR/popcount, so the tolerance is zero.  Each phase
prints what it found; any failure exits non-zero.  The last line of a
passing run is ``{"ok": true, "device": {...}}`` as JAX reports the device.
"""

from __future__ import annotations

import os

os.environ["JAX_PLATFORMS"] = "cuda"

import argparse  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gf2bv_tpu import LinearSystem  # noqa: E402
from gf2bv_tpu.core import packing  # noqa: E402
from gf2bv_tpu.crypto import mt_jax  # noqa: E402
from gf2bv_tpu.crypto.mt import MT19937  # noqa: E402
from gf2bv_tpu.ops import gauss_blocked, solver  # noqa: E402
from gf2bv_tpu.ops.gauss_ref import solve_oracle  # noqa: E402
from gf2bv_tpu.utils import device  # noqa: E402
from gf2bv_tpu.utils.cache import enable_persistent_cache  # noqa: E402

COLS = mt_jax.COLS  # 19968
SEED = 3142


def log(*a):
    print(*a, flush=True)


def timed(fn, n: int) -> list[float]:
    """Seconds of n warm calls of fn, each ended by block_until_ready."""
    jax.block_until_ready(fn())
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def fmt(ts) -> str:
    return f"median {statistics.median(ts) * 1e3:.3f} ms of {len(ts)}"


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: ok ({time.perf_counter() - self.t0:.1f} s)")


def mt_instance(seed: int):
    rand = random.Random(seed)
    state = tuple(rand.getstate()[1][:-1])
    return state, [rand.getrandbits(32) for _ in range(624)]


def mt_zeros(lin, out):
    words = lin.gens()
    sym = MT19937(list(words))
    return [sym.getrandbits(32) ^ o for o in out] + [words[0] ^ 0x80000000]


def mt_model(ws, p):
    sym = MT19937(list(ws))
    return [sym.getrandbits(32) ^ p[i] for i in range(624)] + [ws[0] ^ 0x80000000]


def words_of(x: int) -> tuple:
    return tuple((x >> (32 * i)) & 0xFFFFFFFF for i in range(624))


def flagship_matrix(out):
    """(20224, 640) u32: the device-built MT19937 system, row-padded."""
    e = mt_jax.mt19937_system_device(jnp.asarray(out, jnp.uint32), 32, 624)
    want = -(-e.shape[0] // 256) * 256
    return jnp.pad(e, ((0, want - e.shape[0]), (0, 0)))


def origin_int(origin32) -> int:
    return packing.words_to_int(packing.from_u32(np.asarray(origin32)[None, :])[0])


def random_system(rng, rows, cols, deficit=0, unsat=False):
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    coeff[:, rng.permutation(cols)[:deficit]] = 0
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    if unsat:
        j = int(np.argmax(coeff.any(axis=1)))
        coeff[rows - 1] = coeff[j]
        rhs[rows - 1] = rhs[j] ^ 1
    return packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)


def check_vs_oracle(eqs, cols, tag):
    ref = solve_oracle(eqs, cols)
    got0 = solver.solve(eqs, cols, 0)
    got1 = solver.solve(eqs, cols, 1)
    if not ref.consistent:
        assert got0 is None and got1 is None, f"{tag}: unsat not detected"
        return "unsat"
    want = packing.words_to_int(ref.origin)
    assert got0 == want, f"{tag}: mode-0 origin"
    assert got1.origin == want, f"{tag}: mode-1 origin"
    assert got1.basis == [packing.words_to_int(b) for b in ref.basis], f"{tag}: basis"
    return f"dim {len(ref.basis)}"


def one_card(devs):
    from gf2bv_tpu.ops import triton_update
    from gf2bv_tpu.parallel import batch as pbatch

    with Phase("1 device"):
        assert len(devs) == 1, f"one card expected, JAX sees {len(devs)}"
        backend = solver._resolve_backend(None, COLS)
        assert backend == "blocked", backend
        engine = gauss_blocked.default_phase2()
        assert engine == "triton", engine
        log(f"auto backend at {COLS} cols: {backend}; phase-2 engine: {engine}")

    state, out = mt_instance(SEED)
    a = flagship_matrix(out)
    with Phase("2 compile"):
        t0 = time.perf_counter()
        compiled = gauss_blocked.rref_origin_blocked.lower(a, COLS).compile()
        log(f"rref_origin_blocked {a.shape} {a.dtype}: compiled in "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"memory_analysis: {compiled.memory_analysis()}")

    with Phase("3 public path"):
        lin = LinearSystem([32] * 624)
        zeros = mt_zeros(lin, out)
        t0 = time.perf_counter()
        sol = lin.solve_one(zeros)
        log(f"LinearSystem.solve_one (first, incl. compile): "
            f"{time.perf_counter() - t0:.2f} s")
        assert sol == state, "solve_one != seeded random.Random state"
        rng2 = MT19937(list(sol))
        assert all(rng2.getrandbits(32) == o for o in out), "round trip"
        log(f"solve_one warm: {fmt(timed(lambda: lin.solve_one(zeros), 3))}")
        host = packing.to_u32(lin.get_eqs_packed(zeros))
        dev = np.asarray(
            mt_jax.mt19937_system_device(jnp.asarray(out, jnp.uint32), 32, 624)
        )
        devnz = dev[dev.any(axis=1)]
        assert devnz.shape == (host.shape[0], dev.shape[1])
        assert np.array_equal(devnz[:, : host.shape[1]], host)
        assert not dev[:, host.shape[1]:].any()
        log(f"device-built matrix == host lazy trace matrix ({host.shape[0]} rows)")

    with Phase("4 oracle and fuzz"):
        origin32, unsat = jax.device_get(compiled(a))
        assert not bool(unsat)
        t0 = time.perf_counter()
        ref = solve_oracle(lin.get_eqs_packed(zeros), COLS, mode=0)
        assert origin_int(origin32) == packing.words_to_int(ref.origin)
        assert words_of(origin_int(origin32)) == state
        log(f"flagship origin == packed numpy oracle "
            f"(oracle {time.perf_counter() - t0:.1f} s on the host)")
        rng = np.random.default_rng(0xF022)
        cases = [(4100, 0, False), (4000, 3, False), (3990, 0, True),
                 (2500, 0, False), (4300, 4, True), (4000, 0, False)]
        for i, (rows, deficit, unsat_) in enumerate(cases):
            eqs = random_system(rng, rows, 4000, deficit, unsat_)
            log(f"fuzz {i}: rows {rows} x 4000 cols, deficit {deficit}: "
                f"{check_vs_oracle(eqs, 4000, f'fuzz {i}')}")

    with Phase("5 serving and sweeps"):
        tmpl = lin.capture(mt_model)
        batch, states = [], []
        for k in range(256):
            st_k, out_k = mt_instance(91_000 + k)
            states.append(st_k)
            batch.append(out_k)
        t0 = time.perf_counter()
        assert tmpl.solve_one_batch(batch) == states
        log(f"CapturedTrace.solve_one_batch B=256: all states "
            f"({time.perf_counter() - t0:.2f} s first call)")
        log(f"solve_one_batch B=256 warm: "
            f"{fmt(timed(lambda: tmpl.solve_one_batch(batch), 2))}")

        guesses = [lin.gens()[0][i] for i in range(12)]
        k_true = sum(((state[0] >> i) & 1) << i for i in range(12))
        sweep = lin.solve_one_sweep(zeros, guesses)
        assert len(sweep) == 4096 and sweep[k_true] == state
        assert sum(x is not None for x in sweep) == 1
        log("solve_one_sweep 12 bits: 4096 candidates, only the true state survives")

        rng = np.random.default_rng(0xBA7C)
        mats = [random_system(rng, 2100, 2048, deficit=d) for d in (0, 2, 0, 5)]
        got = pbatch.solve_batch(mats, 2048, 1)
        for i, (g, m) in enumerate(zip(got, mats)):
            want = gauss_blocked.solve_blocked(m, 2048, 1)
            assert np.array_equal(g[0], want[0]) and np.array_equal(g[1], want[1]), i
        log("parallel.batch.solve_batch mode 1, 4 x 2048 cols == solve_blocked each")

    with Phase("6 phase-2 engines"):
        rows, wp = a.shape
        r = np.random.default_rng(6)
        s = jnp.asarray(r.integers(0, 2**32, size=(rows, 8), dtype=np.uint32))
        pf = jnp.asarray(r.integers(0, 2**32, size=(256, wp), dtype=np.uint32))
        f_jnp = jax.jit(gauss_blocked.rank_k_update_jnp)
        f_tri = triton_update.rank_k_update_triton
        full = np.asarray(f_jnp(a, s, pf))
        assert np.array_equal(np.asarray(f_tri(a, s, pf)), full)
        w0, tw = 320, triton_update.TW
        live = w0 // tw * tw  # first word of the first live tile past tile 0
        trail = np.asarray(f_tri(a, s, pf, jnp.int32(w0)))
        a_h = np.asarray(a)
        assert np.array_equal(trail[:, :tw], full[:, :tw])
        assert np.array_equal(trail[:, tw:live], a_h[:, tw:live])
        assert np.array_equal(trail[:, live:], full[:, live:])
        log("Triton rank-K update == rank_k_update_jnp bit for bit "
            "(full width; trailing at w0=320)")
        log(f"per panel, jnp: {fmt(timed(lambda: f_jnp(a, s, pf), 20))}")
        log(f"per panel, triton: {fmt(timed(lambda: f_tri(a, s, pf), 20))}")
        log(f"per panel, triton trailing w0={w0}: "
            f"{fmt(timed(lambda: f_tri(a, s, pf, jnp.int32(w0)), 20))}")
        p1 = jax.jit(gauss_blocked.phase1_panel, static_argnums=(4, 5))
        used = jnp.zeros((rows,), bool)
        b40 = a[:, 320:328]
        log(f"phase 1 per panel (panel 40): "
            f"{fmt(timed(lambda: p1(a, b40, used, 320, 256, COLS), 10))}")
        times = {"jnp": [], "triton": []}
        for eng in ("jnp", "triton", "triton", "jnp"):
            o, _ = gauss_blocked.rref_origin_blocked(a, COLS, 256, eng)
            assert words_of(origin_int(o)) == state, eng
            times[eng] += timed(
                lambda eng=eng: gauss_blocked.rref_origin_blocked(a, COLS, 256, eng), 3
            )
        for eng, ts in times.items():
            log(f"warm solve_one (rref_origin_blocked) phase2={eng}: {fmt(ts)}")


def four_cards(devs):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gf2bv_tpu.ops import extract_device, lazy_solve, multi_rhs
    from gf2bv_tpu.parallel import mesh as meshlib
    from gf2bv_tpu.parallel import multi_rhs_sharded, rowshard_tournament, solve_sharded

    assert len(devs) == 4, f"four cards expected, JAX sees {len(devs)}"
    state, out = mt_instance(SEED)
    lin = LinearSystem([32] * 624)
    zeros = mt_zeros(lin, out)
    eqs = lin.get_eqs_packed(zeros)

    def on_four(x, tag):
        owners = {sh.device for sh in x.addressable_shards}
        assert len(owners) == 4, f"{tag}: shards on {owners}"
        log(f"{tag}: shards on {sorted(d.id for d in owners)}")

    with Phase("four: row-sharded flagship solve"):
        a1 = jnp.asarray(gauss_blocked._pad(eqs, 256, word_align=128))
        one, _ = jax.device_get(gauss_blocked.rref_origin_blocked(a1, COLS))
        assert words_of(origin_int(one)) == state
        mesh = meshlib.make_mesh(batch=1, rows=4)
        got = solve_sharded(eqs, COLS, 0, mesh)
        assert packing.words_to_int(got) == origin_int(one)
        log("parallel.solve_sharded mode 0 over (batch 1, rows 4) == one-card origin")
        a32 = packing.pad2d(packing.to_u32(eqs), row_align=4 * 256, word_align=128)
        rref32, pof = rowshard_tournament.rref_rowsharded_tournament(a32, COLS, mesh)
        on_four(rref32, "tournament RREF")
        o4 = extract_device.origin_device(rref32, pof, COLS)
        assert origin_int(o4) == origin_int(one)
        log("tournament RREF origin == one-card origin")

    with Phase("four: mesh-sharded multi-RHS B=1024"):
        tmpl = lin.capture(mt_model)
        batch, states = [], []
        for k in range(1024):
            st_k, out_k = mt_instance(91_000 + k)
            states.append(st_k)
            batch.append(out_k)
        mesh_b = meshlib.make_mesh(batch=4, rows=1)
        got = tmpl.solve_raw_batch(batch, 0, mesh=mesh_b)
        want = tmpl.solve_raw_batch(batch, 0)
        assert got == want, "sharded multi-RHS != one-card multi_rhs"
        assert [words_of(g) for g in got] == states
        log("solve_multi_rhs_sharded over (batch 4, rows 1) == one-card "
            "multi_rhs.solve_multi_rhs, all 1024 states")
        # the instance shards of that call's program sit on four devices
        cs = lazy_solve.cached_system(lin, tmpl.zeros)
        affs = tmpl._affine_matrix([z._expr for z in tmpl.zeros], cs.widths, batch)
        rows_pad, wp = cs.a_dev.shape
        rhs, bw_d = multi_rhs_sharded.pack_shard_blocks(
            affs[:, cs.kept], 1024, 4, rows_pad, multi_rhs._pack_rhs
        )
        fn = multi_rhs_sharded._build(mesh_b, COLS, wp, bw_d, gauss_blocked.K_PANEL)
        origins, unsat, _, _ = fn(
            jax.device_put(cs.a_dev, NamedSharding(mesh_b, P(None, None))),
            jax.device_put(rhs, NamedSharding(mesh_b, P(None, meshlib.BATCH_AXIS))),
        )
        on_four(origins, "multi-RHS origins")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args(argv)
    cache = enable_persistent_cache()
    devs = device.require_gpu()
    log(f"platform {devs[0].platform}, kind {devs[0].device_kind}, "
        f"count {len(devs)}; compile cache {cache}")
    log(device.card_line())
    (four_cards if args.four else one_card)(devs)
    print(device.result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
