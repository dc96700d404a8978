"""Randomized differential fuzz of the solver families vs the numpy oracle,
on whatever device JAX runs (the compiled GPU path on a machine with one).
One padded shape -> one compile; many random instances incl.
rank-deficient and inconsistent systems, both modes.  Zero tolerance:
RREF is unique.  tests/test_fuzz_harness.py runs every family at mini
size on the CPU.

Run: python scripts/fuzz.py [n_instances] [seed]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import solver
from gf2bv_tpu.ops.gauss_ref import solve_oracle


def main(n=30, cols=4000, backend="blocked", seed=0xF022):
    import jax
    from gf2bv_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    print(f"devices: {jax.devices()}", file=sys.stderr)
    rng = np.random.default_rng(seed)
    for i in range(n):
        rows = int(rng.integers(cols - 40, cols + 300))
        deficit = int(rng.integers(0, 5)) * int(rng.integers(0, 2))
        unsat = bool(rng.integers(0, 4) == 0)
        free = rng.permutation(cols)[:deficit]
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        coeff[:, free] = 0
        secret = rng.integers(0, 2, size=cols).astype(np.uint8)
        rhs = (coeff @ secret) % 2
        if unsat:
            j = int(np.argmax(coeff.any(axis=1)))
            coeff[rows - 1] = coeff[j]
            rhs[rows - 1] = rhs[j] ^ 1
        eqs = packing.pack_bits(
            np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols
        )

        ref = solve_oracle(eqs, cols)
        got0 = solver.solve(eqs, cols, 0, backend=backend)
        got1 = solver.solve(eqs, cols, 1, backend=backend)
        if not ref.consistent:
            assert got0 is None and got1 is None, f"[{i}] unsat not detected"
        else:
            assert got0 == packing.words_to_int(ref.origin), f"[{i}] origin0"
            assert got1.origin == packing.words_to_int(ref.origin), f"[{i}] origin1"
            assert got1.basis == [
                packing.words_to_int(b) for b in ref.basis
            ], f"[{i}] basis"
        print(
            f"[{i}] rows={rows} deficit={deficit} unsat={unsat} OK",
            file=sys.stderr,
        )
    print(f"fuzz [{backend} cols={cols}]: {n} instances OK")


def _random_system(rng, cols):
    # 1-in-4 deeply underdetermined (rows down to cols/2): the round-4
    # tournament rank-loss bug lived at rows < cols, a region the old
    # [cols-40, cols+300] range barely grazed
    if rng.integers(0, 4) == 0:
        rows = int(rng.integers(cols // 2, max(cols - 40, cols // 2 + 1)))
    else:
        rows = int(rng.integers(cols - 40, cols + 300))
    deficit = int(rng.integers(0, 5)) * int(rng.integers(0, 2))
    unsat = bool(rng.integers(0, 4) == 0)
    free = rng.permutation(cols)[:deficit]
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    coeff[:, free] = 0
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    if unsat:
        j = int(np.argmax(coeff.any(axis=1)))
        coeff[rows - 1] = coeff[j]
        rhs[rows - 1] = rhs[j] ^ 1
    return packing.pack_bits(
        np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols
    )


def _check(i, ref, got0, got1):
    if not ref.consistent:
        assert got0 is None and got1 is None, f"[{i}] unsat not detected"
        return
    assert got0 == packing.words_to_int(ref.origin), f"[{i}] origin0"
    assert got1.origin == packing.words_to_int(ref.origin), f"[{i}] origin1"
    assert got1.basis == [
        packing.words_to_int(b) for b in ref.basis
    ], f"[{i}] basis"


def fuzz_batched(n=24, batch=8, cols=2000, seed=0xBA7C):
    """The batched blocked solver (ops/gauss_batched) vs the oracle, both
    modes, on the real chip."""
    from gf2bv_tpu.core.affine import AffineSpace
    from gf2bv_tpu.ops import gauss_batched

    rng = np.random.default_rng(seed)
    done = 0
    while done < n:
        mats = [_random_system(rng, cols) for _ in range(batch)]
        got0 = gauss_batched.solve_batched(mats, cols, 0)
        got1 = gauss_batched.solve_batched(mats, cols, 1)
        for i, m in enumerate(mats):
            ref = solve_oracle(m, cols)
            g0 = None if got0[i] is None else packing.words_to_int(got0[i])
            g1 = (
                None
                if got1[i] is None
                else AffineSpace(got1[i][0], got1[i][1], cols)
            )
            _check(done + i, ref, g0, g1)
        done += batch
        print(f"[batched {done}/{n}] OK", file=sys.stderr)
    print(f"fuzz [batched blocked cols={cols}]: {n} instances OK")


def fuzz_sharded(n=12, cols=2000, seed=0x5AAD):
    """The row-sharded solvers on a 1-device mesh (the shape available on
    this machine) vs the oracle, both kernels, both modes."""
    import jax

    from gf2bv_tpu.core.affine import AffineSpace
    from gf2bv_tpu.parallel import mesh as meshlib
    from gf2bv_tpu.parallel.rowshard_blocked import solve_rowsharded_blocked
    from gf2bv_tpu.parallel.rowshard_tournament import (
        solve_rowsharded_tournament,
    )

    mesh = meshlib.make_mesh(batch=1, rows=jax.device_count())
    rng = np.random.default_rng(seed)
    for i in range(n):
        eqs = _random_system(rng, cols)
        ref = solve_oracle(eqs, cols)
        # k_panel varies the panel/merge geometry (the round-4 tournament
        # rank-loss bug was k_panel-sensitive); keep the set small so the
        # sweep reuses a handful of compiled kernels
        kp = int(rng.choice([64, 256]))
        for name, fn in (
            ("blocked", solve_rowsharded_blocked),
            ("tournament", solve_rowsharded_tournament),
        ):
            got0 = fn(eqs, cols, 0, mesh, k_panel=kp)
            got1 = fn(eqs, cols, 1, mesh, k_panel=kp)
            g0 = None if got0 is None else packing.words_to_int(got0)
            g1 = (
                None
                if got1 is None
                else AffineSpace(got1[0], got1[1], cols)
            )
            _check(f"{i}:{name}", ref, g0, g1)
        print(f"[sharded {i}] OK", file=sys.stderr)
    print(f"fuzz [rowsharded 1-dev mesh cols={cols}]: {n} instances OK")


def _random_lazy_model(rng, lin, lazy: bool):
    """Apply an identical random op chain to lazy or eager gens, returning
    symbolic output words (constants planted so both trees match 1:1)."""
    gens = lin.gens(lazy=lazy)
    state = gens[0]
    w = len(state)
    outs = []
    nsteps = int(rng.integers(6, 14))
    for s in range(nsteps):
        op = int(rng.integers(0, 6))
        if op == 0:
            state = state ^ int(rng.integers(0, 1 << 63))
        elif op == 1:
            state = state ^ state.rotl(int(rng.integers(1, w)))
        elif op == 2:
            state = (state >> int(rng.integers(1, 8))) ^ state
        elif op == 3:
            state = state ^ ((state << int(rng.integers(1, 8)))[:w])
        elif op == 4:
            state = state ^ (state & int(rng.integers(0, 1 << 63)))
        elif op == 5:
            state = state.rotr(int(rng.integers(1, w)))
        outs.append(state ^ int(rng.integers(0, 1 << 63)))
    return outs


def fuzz_lazy(n=20, seed=0x1A2B):
    """The lazy public-API route (ops/lazy_solve: device-cached coefficient
    matrix + per-solve affine delta) vs (a) the eager materialization of the
    SAME op chain and (b) the numpy oracle, both modes, on the real chip."""
    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.ops import lazy_solve

    rng = np.random.default_rng(seed)
    for i in range(n):
        # two FIXED widths (one per backend) so the whole sweep reuses two
        # compiled executables; the random op chains vary the structure
        cols = 72 if i % 2 else 1280
        lin = LinearSystem([cols])
        op_seed = int(rng.integers(0, 2**31))
        lazy_zeros = _random_lazy_model(
            np.random.default_rng(op_seed), lin, lazy=True
        )
        eager_zeros = _random_lazy_model(
            np.random.default_rng(op_seed), lin, lazy=False
        )
        eqs_l = lin.get_eqs_packed(lazy_zeros)
        eqs_e = lin.get_eqs_packed(eager_zeros)
        assert np.array_equal(eqs_l, eqs_e), f"[lazy {i}] materialization"

        assert lazy_solve.eligible(lin, lazy_zeros), f"[lazy {i}] eligibility"
        ref = solve_oracle(eqs_e, cols)
        got0 = lin.solve_raw_one(lazy_zeros)
        got1 = lin.solve_raw_space(lazy_zeros)
        _check(f"lazy:{i}", ref, got0, got1)
        print(f"[lazy {i}] cols={cols} OK", file=sys.stderr)
    print(f"fuzz [lazy public API]: {n} instances OK")


def fuzz_engines(n=2, seed=0xE491, cols=500):
    """Every phase-2 engine this device runs vs the oracle: jnp always,
    the Triton kernel on a GPU."""
    from gf2bv_tpu.ops.gauss_blocked import default_phase2, solve_blocked

    engines = sorted({"jnp", default_phase2()})
    rng = np.random.default_rng(seed)
    for i in range(n):
        eqs = _random_system(rng, cols)
        ref = solve_oracle(eqs, cols)
        for p2 in engines:
            got0 = solve_blocked(eqs, cols, 0, phase2=p2)
            got1r = solve_blocked(eqs, cols, 1, phase2=p2)
            g1 = None
            if got1r is not None:
                from gf2bv_tpu.core.affine import AffineSpace

                g1 = AffineSpace(got1r[0], got1r[1], cols)
            g0 = None if got0 is None else packing.words_to_int(
                got0[0] if isinstance(got0, tuple) else got0
            )
            _check(f"eng:{i}:{p2}", ref, g0, g1)
        print(f"[engines {i}] OK", file=sys.stderr)
    print(f"fuzz [engine matrix cols={cols}]: {n} instances OK")


def fuzz_incremental(n=6, seed=0x17C4):
    """IncrementalSolver vs a from-scratch oracle: random base + random add
    batches (rank-deficient bases, unsat planted mid-stream).  After EVERY
    add, the maintained device RREF must solve identically to a fresh
    elimination of all rows so far (RREF uniqueness), and sticky unsat must
    hold once tripped."""
    from gf2bv_tpu.ops.incremental import IncrementalSolver

    rng = np.random.default_rng(seed)
    for i in range(n):
        cols = int(rng.choice([48, 220, 500]))
        rows = cols + int(rng.integers(10, 60))
        deficit = int(rng.integers(0, 6)) * int(rng.integers(0, 2))
        unsat_at = (
            int(rng.integers(1, rows)) if rng.integers(0, 3) == 0 else -1
        )
        free = rng.permutation(cols)[:deficit]
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        coeff[:, free] = 0
        secret = rng.integers(0, 2, size=cols).astype(np.uint8)
        rhs = (coeff @ secret) % 2
        if unsat_at >= 0:
            j = int(np.argmax(coeff[: unsat_at + 1].any(axis=1)))
            coeff[unsat_at] = coeff[j]
            rhs[unsat_at] = rhs[j] ^ 1
        pool = packing.pack_bits(
            np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols
        )

        k0 = int(rng.integers(1, rows // 2))
        inc = IncrementalSolver.from_packed(pool[:k0], cols)
        done = k0
        step = 0
        while done < rows:
            nb = min(int(rng.integers(1, rows // 2 + 1)), rows - done)
            inc.add_packed(pool[done : done + nb])
            done += nb
            ref = solve_oracle(pool[:done], cols)
            got0 = inc.solve_raw_one()
            got1 = inc.solve_raw_space()
            _check(f"inc:{i}:{step}", ref, got0, got1)
            assert inc.unsat == (not ref.consistent), f"[inc:{i}] unsat flag"
            step += 1
        print(f"[inc {i}] cols={cols} rows={rows} steps={step} OK",
              file=sys.stderr)
    print(f"fuzz [incremental]: {n} instances OK")


def fuzz_native_route(n=16, seed=0x4A7E):
    """The CPU-native lazy route (ops/lazy_solve native branch: cached host
    matrix + per-solve affine-column swap + affine-independent mode-1 basis
    built once) vs the numpy oracle over random op chains, both modes,
    plus the captured-trace multi-RHS native batch vs per-instance solves."""
    from gf2bv_tpu import LinearSystem, _native
    from gf2bv_tpu.ops import lazy_solve

    if not _native.available():
        print("native engine unavailable; skipping", file=sys.stderr)
        return
    rng = np.random.default_rng(seed)
    for i in range(n):
        cols = 72 if i % 2 else 1280
        lin = LinearSystem([cols], backend="native")
        op_seed = int(rng.integers(0, 2**31))
        lazy_zeros = _random_lazy_model(
            np.random.default_rng(op_seed), lin, lazy=True
        )
        eager_zeros = _random_lazy_model(
            np.random.default_rng(op_seed), lin, lazy=False
        )
        eqs = lin.get_eqs_packed(eager_zeros)
        assert lazy_solve.eligible(lin, lazy_zeros), f"[native {i}] route"
        ref = solve_oracle(eqs, cols)
        got0 = lin.solve_raw_one(lazy_zeros)
        got1 = lin.solve_raw_space(lazy_zeros)
        _check(f"native:{i}", ref, got0, got1)
        # a second mode-1 solve serves the CACHED basis — must be identical
        got1b = lin.solve_raw_space(lazy_zeros)
        if got1 is not None:
            assert got1b.origin == got1.origin, f"[native {i}] re-origin"
            assert got1b.basis == got1.basis, f"[native {i}] re-basis"
        print(f"[native {i}] cols={cols} OK", file=sys.stderr)

    # captured multi-RHS on the host engine vs per-instance native solves
    lin = LinearSystem([64], backend="native")
    tmpl = lin.capture(
        lambda gens, p: [
            (gens[0] ^ gens[0].rotl(11) ^ (gens[0] >> 3)) ^ p[0],
            (gens[0] ^ (gens[0] << 9)[:64]) ^ p[1],
        ]
    )
    batch = [
        [int(rng.integers(0, 1 << 63)), int(rng.integers(0, 1 << 63))]
        for _ in range(17)
    ]
    got = tmpl.solve_raw_batch(batch, mode=0)
    want = [tmpl.solve_raw_one(v) for v in batch]
    assert got == want, "[native] captured batch"
    print(f"fuzz [native lazy route]: {n} instances OK")


def fuzz_quad(n=16, seed=0x9D0F):
    """Round-2 quadratic device paths on the real chip: (a) on-device
    monomial expansion (ops/quad_device) vs the host mul_bits build, and
    (b) the lazy mulq route (reference idiom) vs the eager matrix — each
    solved both modes and checked vs the oracle."""
    import jax.numpy as jnp

    from gf2bv_tpu import LinearSystem, QuadraticSystem
    from gf2bv_tpu.core.affine import AffineSpace
    from gf2bv_tpu.ops import quad_device

    rng = np.random.default_rng(seed)
    for i in range(n):
        # fixed shapes (two variants) so the sweep compiles at most twice
        nlin = 16 if i % 2 else 10
        qsys = QuadraticSystem([nlin])
        cols = qsys._cols
        nouts = cols + 24

        # (a) device expansion from narrow tap streams
        lin_n = LinearSystem([nlin])
        (v,) = lin_n.gens()
        width = nouts
        idx_a = rng.integers(0, nlin, size=width)
        idx_b = rng.integers(0, nlin, size=width)
        a_bits = type(v).stack([v[int(k)] for k in idx_a])
        b_bits = type(v).stack([v[int(k)] for k in idx_b])
        const = int.from_bytes(rng.bytes(width // 8 + 1), "little") & (
            (1 << width) - 1
        )
        eqs_dev = quad_device.quad_rows(
            qsys, pairs=[(a_bits, b_bits)], linear=[a_bits], const=const
        )
        host = qsys.mul_bits(a_bits, b_bits) ^ qsys.lift(a_bits) ^ const
        got_dev = np.asarray(eqs_dev)
        want_dev = packing.to_u32(host.rows)
        assert np.array_equal(
            got_dev[:, : want_dev.shape[1]], want_dev
        ), f"[quad {i}] device expansion"

        ref = solve_oracle(host.rows, cols)
        got0 = qsys.solve_raw_packed(jnp.asarray(eqs_dev), 0)
        got1 = qsys.solve_raw_packed(jnp.asarray(eqs_dev), 1)
        g1 = None if got1 is None else got1
        _check(f"quad-dev:{i}", ref, got0, g1)

        # (b) lazy mulq (the reference's per-bit idiom) vs eager
        (xl,) = qsys.gens(lazy=True)
        (xe,) = qsys.gens(lazy=False)
        zl, ze = [], []
        for _ in range(nouts):
            ia, ib, ic = (int(r) for r in rng.integers(0, nlin, size=3))
            c = int(rng.integers(0, 2))
            zl.append(qsys.mul_bit(xl[ia], xl[ib]) ^ xl[ic] ^ c)
            ze.append(qsys.mul_bit(xe[ia], xe[ib]) ^ xe[ic] ^ c)
        eqs_l = qsys.get_eqs_packed(zl)
        assert np.array_equal(
            eqs_l, qsys.get_eqs_packed(ze)
        ), f"[quad {i}] lazy materialization"
        ref2 = solve_oracle(eqs_l, cols)
        got0 = qsys.solve_raw_one(zl)
        got1 = qsys.solve_raw_space(zl)
        _check(f"quad-lazy:{i}", ref2, got0, got1)
        print(f"[quad {i}] nlin={nlin} cols={cols} OK", file=sys.stderr)
    print(f"fuzz [quad device+lazy]: {n} instances OK")


def fuzz_capture(n=12, per_template=3, seed=0xCA97):
    """Captured-trace templates (core/capture.py) on the real chip: a random
    op-chain model is captured once with Param slots; several instances bind
    random values and must match BOTH the direct lazy solve of the same
    structure and the numpy oracle, both modes."""
    from gf2bv_tpu import LinearSystem

    rng = np.random.default_rng(seed)
    for i in range(n):
        cols = 72 if i % 2 else 1280  # same fixed widths as fuzz_lazy
        lin = LinearSystem([cols])
        op_seed = int(rng.integers(0, 2**31))

        def model(gens, p, lin=lin, op_seed=op_seed):
            zs = _random_lazy_model(
                np.random.default_rng(op_seed), lin, lazy=True
            )
            return [z ^ p[k] for k, z in enumerate(zs)]

        tmpl = lin.capture(model)
        for j in range(per_template):
            vals = [
                int(v)
                for v in rng.integers(0, 1 << 63, size=tmpl.nparams)
            ]
            # direct route: same structure, literal constants
            direct = [
                z ^ v
                for z, v in zip(
                    _random_lazy_model(
                        np.random.default_rng(op_seed), lin, lazy=True
                    ),
                    vals,
                )
            ]
            eqs = lin.get_eqs_packed(direct)
            ref = solve_oracle(eqs, cols)
            got0 = tmpl.solve_raw_one(vals)
            got1 = tmpl.solve_raw_space(vals)
            _check(f"capture:{i}.{j}", ref, got0, got1)
            assert got0 == lin.solve_raw_one(direct), f"[capture {i}.{j}] direct"
        print(f"[capture {i}] cols={cols} x{per_template} OK", file=sys.stderr)
    print(f"fuzz [captured templates]: {n} templates x {per_template} OK")


def fuzz_multi_rhs(n=8, seed=0x3B5):
    """ops/multi_rhs on the real chip: random coefficient structures x
    random instance batches (incl. planted-unsat columns) vs the oracle,
    both modes; mode-1 instances must share the oracle's exact basis."""
    from gf2bv_tpu.ops import multi_rhs
    from gf2bv_tpu.ops.gauss_blocked import K_PANEL, _pad

    rng = np.random.default_rng(seed)
    cols, rows = 1500, 1600  # fixed shape: one compile for the sweep
    for i in range(n):
        nb = int(rng.integers(3, 40))
        deficit = int(rng.integers(0, 4))
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        if deficit:
            coeff[:, rng.permutation(cols)[:deficit]] = 0
        coeff[rows - 1] = coeff[0] ^ coeff[1]  # dependent row for unsat planting
        rhs, expect_bad = [], []
        for k in range(nb):
            secret = rng.integers(0, 2, size=cols).astype(np.uint8)
            b = (coeff @ secret) % 2
            bad = bool(rng.integers(0, 3) == 0)
            if bad:
                b[rows - 1] ^= 1
            rhs.append(b)
            expect_bad.append(bad)
        eqs = packing.pack_bits(
            np.concatenate([np.zeros((rows, 1), np.uint8), coeff], axis=1),
            1 + cols,
        )
        a32 = _pad(eqs, K_PANEL, word_align=128)
        mode = int(rng.integers(0, 2))
        got = multi_rhs.solve_multi_rhs(a32, cols, np.stack(rhs), mode)
        for k in range(nb):
            bits = np.concatenate([rhs[k][:, None], coeff], axis=1)
            ref = solve_oracle(packing.pack_bits(bits, 1 + cols), cols)
            assert ref.consistent != expect_bad[k], f"[mrhs {i}.{k}] plant"
            if expect_bad[k]:
                assert got[k] is None, f"[mrhs {i}.{k}] unsat"
                continue
            if mode == 0:
                assert got[k] == packing.words_to_int(ref.origin), f"[mrhs {i}.{k}]"
            else:
                assert got[k].origin == packing.words_to_int(ref.origin), f"[mrhs {i}.{k}] o1"
                assert got[k].basis == [
                    packing.words_to_int(b) for b in ref.basis
                ], f"[mrhs {i}.{k}] basis"
        print(f"[mrhs {i}] nb={nb} mode={mode} OK", file=sys.stderr)
    print(f"fuzz [multi-RHS cols={cols}]: {n} sweeps OK")


def fuzz_mrhs_sharded(n=4, seed=0x6D2):
    """Mesh-sharded multi-RHS (parallel/multi_rhs_sharded.py) vs the
    single-device path: random structures x random instance batches
    (ragged over the device count, planted unsats), both modes, on a
    (n_devices, 1) mesh — 8 virtual shards on the CPU soak, the 1-device
    wrapper sanity on the real chip."""
    import jax

    from gf2bv_tpu.ops import multi_rhs
    from gf2bv_tpu.ops.gauss_blocked import K_PANEL, _pad
    from gf2bv_tpu.parallel import mesh as meshlib
    from gf2bv_tpu.parallel.multi_rhs_sharded import solve_multi_rhs_sharded

    rng = np.random.default_rng(seed)
    mesh = meshlib.make_mesh(batch=jax.device_count(), rows=1)
    cols, rows = 900, 950  # fixed shape: one compile for the sweep
    for i in range(n):
        nb = int(rng.integers(3, 60))
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        coeff[rows - 1] = coeff[0] ^ coeff[1]
        if rng.integers(0, 2):  # sometimes underdetermined
            coeff[:, rng.permutation(cols)[: int(rng.integers(1, 30))]] = 0
        rhs = []
        for k in range(nb):
            secret = rng.integers(0, 2, size=cols).astype(np.uint8)
            b = (coeff @ secret) % 2
            if rng.integers(0, 3) == 0:
                b[rows - 1] ^= 1  # planted unsat
            rhs.append(b)
        eqs = packing.pack_bits(
            np.concatenate([np.zeros((rows, 1), np.uint8), coeff], axis=1),
            1 + cols,
        )
        a32 = _pad(eqs, K_PANEL, word_align=128)
        mode = int(rng.integers(0, 2))
        got = solve_multi_rhs_sharded(
            a32, cols, np.stack(rhs), mode, mesh=mesh
        )
        want = multi_rhs.solve_multi_rhs(a32, cols, np.stack(rhs), mode)
        assert len(got) == len(want) == nb
        for k, (g, w) in enumerate(zip(got, want)):
            assert (g is None) == (w is None), f"[mrhs-sh {i}.{k}] unsat"
            if g is None:
                continue
            if mode == 0:
                assert g == w, f"[mrhs-sh {i}.{k}]"
            else:
                assert g.origin == w.origin, f"[mrhs-sh {i}.{k}] o"
                assert g.basis == w.basis, f"[mrhs-sh {i}.{k}] b"
        print(f"[mrhs-sh {i}] nb={nb} mode={mode} OK", file=sys.stderr)
    print(
        f"fuzz [multi-RHS sharded {mesh.shape[meshlib.BATCH_AXIS]}-dev "
        f"mesh cols={cols}]: {n} sweeps OK"
    )


def fuzz_multi_rhs_multitile(n=2, seed=0x4C1):
    """The MULTI-TILE multi-RHS path (nb > 4096: several appended 128-word
    tiles ride one elimination) on the real chip.  The full batch is
    checked for consistency (coeff @ x == b over GF(2)) and unsat flags;
    a random subset is checked for EXACT origin equality vs the numpy
    oracle (the RREF origin is unique, so consistency alone would not
    catch a wrong-but-consistent extraction)."""
    from gf2bv_tpu.ops import multi_rhs
    from gf2bv_tpu.ops.gauss_blocked import K_PANEL, _pad

    rng = np.random.default_rng(seed)
    cols, rows = 1500, 1600
    for i in range(n):
        # last sweep crosses 4 appended tiles (the round-5 MAX_RHS_TILES=8
        # extension); earlier ones stay in the 2-3-tile range
        nb = (
            int(rng.integers(17000, 20000))
            if i == n - 1
            else int(rng.integers(4100, 9000))
        )
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        coeff[rows - 1] = coeff[0] ^ coeff[1]  # dependent row for unsat planting
        secrets = rng.integers(0, 2, size=(nb, cols)).astype(np.uint8)
        b_all = (secrets @ coeff.T) % 2  # (nb, rows)
        bad = rng.integers(0, 16, size=nb) == 0
        b_all[bad, rows - 1] ^= 1
        eqs = packing.pack_bits(
            np.concatenate([np.zeros((rows, 1), np.uint8), coeff], axis=1),
            1 + cols,
        )
        a32 = _pad(eqs, K_PANEL, word_align=128)
        got = multi_rhs.solve_multi_rhs(a32, cols, b_all.astype(np.uint8), 0)
        assert len(got) == nb
        sol_bits = np.zeros((nb, cols), np.uint8)
        for k in range(nb):
            assert (got[k] is None) == bool(bad[k]), f"[mrhs-mt {i}.{k}] unsat"
            if got[k] is not None:
                raw = np.frombuffer(
                    got[k].to_bytes((cols + 7) // 8, "little"), np.uint8
                )
                sol_bits[k] = np.unpackbits(raw, bitorder="little")[:cols]
        good = ~bad
        lhs = (sol_bits[good] @ coeff.T) % 2
        assert np.array_equal(lhs, b_all[good]), f"[mrhs-mt {i}] consistency"
        # exact-origin spot checks vs the oracle, sampled across ALL tiles
        goodk = np.flatnonzero(good)
        for k in rng.choice(goodk, size=12, replace=False):
            bits = np.concatenate([b_all[k][:, None], coeff], axis=1)
            ref = solve_oracle(packing.pack_bits(bits, 1 + cols), cols)
            assert got[k] == packing.words_to_int(ref.origin), f"[mrhs-mt {i}.{k}]"
        print(f"[mrhs-mt {i}] nb={nb} OK", file=sys.stderr)
    print(f"fuzz [multi-RHS multi-tile cols={cols}]: {n} sweeps OK")


def fuzz_sweep(n=8, seed=0x5E3):
    """Guess sweeps on the real chip vs the per-guess re-solve oracle:
    random systems, random guess expressions (single-bit, multi-bit,
    constant), default enumeration and explicit candidates; also the
    captured-trace sweep against the direct-system sweep."""
    from gf2bv_tpu import LinearSystem

    rng = np.random.default_rng(seed)
    w = 96
    for i in range(n):
        lin = LinearSystem([w])
        (x,) = lin.gens(lazy=False)
        secret = int(rng.integers(1, 1 << 62)) | (1 << (w - 1))
        zeros = []
        for _ in range(w + 4 - int(rng.integers(0, 8))):
            mask = int(rng.integers(1, 1 << 62)) | int(rng.integers(0, 2)) << (w - 1)
            bit = bin(secret & mask).count("1") & 1
            zeros.append((x & mask).sum() ^ bit)
        g1 = (x >> int(rng.integers(0, w - 4))).sum()
        g2 = (x >> int(rng.integers(0, w - 4))) & 0b11
        got = lin.solve_one_sweep(zeros, [g1, g2])
        assert len(got) == 8, f"[sweep {i}]"
        for k, sol in enumerate(got):
            want = lin.solve_one(
                list(zeros) + [g1 ^ (k & 1), g2 ^ (k >> 1)]
            )
            assert sol == want, f"[sweep {i}.{k}]"
        print(f"[sweep {i}] OK", file=sys.stderr)
    print(f"fuzz [guess sweep w={w}]: {n} sweeps OK")


def fuzz_captured_sweep(n=4, seed=0x7A1):
    """CapturedTrace.solve_one_sweep vs the direct-system sweep on chip."""
    from gf2bv_tpu import LinearSystem
    from gf2bv_tpu.crypto.lfsr import GaloisLFSR

    rng = np.random.default_rng(seed)
    W, TAPS = 96, (1 << 95) | (1 << 17) | 0b101
    lin = LinearSystem([W])

    def model(ws, p):
        reg = GaloisLFSR(W, TAPS, ws[0])
        return [reg() ^ p[i] for i in range(W - 5)]

    tmpl = lin.capture(model)
    (x,) = lin.gens(lazy=False)
    guesses = [x[i] for i in range(W - 5, W)]
    (xs,) = lin.gens()
    for i in range(n):
        key = int(rng.integers(1, 1 << 62)) | (1 << (W - 1))
        reg = GaloisLFSR(W, TAPS, key)
        obs = [reg() for _ in range(W - 5)]
        got = tmpl.solve_one_sweep(obs, guesses)
        sym = GaloisLFSR(W, TAPS, xs)
        want = lin.solve_one_sweep([sym() ^ o for o in obs], guesses)
        assert got == want, f"[csweep {i}]"
        assert got[key >> (W - 5)] == (key,), f"[csweep {i}] true key"
        print(f"[csweep {i}] OK", file=sys.stderr)
    print(f"fuzz [captured sweep]: {n} instances OK")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    seed = int(sys.argv[2], 0) if len(sys.argv) > 2 else 0xF022
    main(n, cols=4000, backend="blocked", seed=seed)
    # multi-word-tile shape (384 words = 3 tiles): mode 0 skips dead
    # tiles in the trailing update
    main(max(5, n // 5), cols=9000, backend="blocked", seed=seed ^ 0xDD)
    main(n, cols=700, backend="jax", seed=seed ^ 0x11)
    fuzz_batched(max(8, n // 2), seed=seed ^ 0x22)
    fuzz_batched(20, batch=20, cols=900, seed=seed ^ 0xEE)
    fuzz_sharded(max(6, n // 4), seed=seed ^ 0x33)
    fuzz_lazy(max(10, n // 2), seed=seed ^ 0x44)
    fuzz_quad(max(8, n // 3), seed=seed ^ 0x55)
    fuzz_capture(max(8, n // 3), seed=seed ^ 0x66)
    fuzz_multi_rhs(max(6, n // 4), seed=seed ^ 0x77)
    fuzz_multi_rhs_multitile(2, seed=seed ^ 0x88)
    fuzz_mrhs_sharded(max(3, n // 8), seed=seed ^ 0xF1)
    fuzz_sweep(max(6, n // 4), seed=seed ^ 0x99)
    fuzz_captured_sweep(max(3, n // 6), seed=seed ^ 0xAA)
    fuzz_native_route(max(8, n // 3), seed=seed ^ 0xBB)
    fuzz_incremental(max(4, n // 5), seed=seed ^ 0xCC)
