"""Device-side quadratic row construction (ops/quad_device.py) and the
pre-packed solve entries (solve_raw_packed / solve_all_packed).

Differential against the host mul_bits path, which is itself diff-tested
against the reference's coefficient formula (test_quadratic.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gf2bv_tpu import LinearSystem, QuadraticSystem
from gf2bv_tpu.core import packing
from gf2bv_tpu.core.bitvec import BitVec
from gf2bv_tpu.ops import quad_device


def _random_narrow(rng, rows, n):
    """Random narrow (linear-columns-only) bitvec rows over 1+n bits."""
    nw = packing.nwords64(1 + n)
    raw = rng.integers(0, 1 << 63, size=(rows, nw), dtype=np.uint64)
    bits = packing.unpack_rows(raw, 1 + n)
    return BitVec(packing.pack_bits(bits, 1 + n), 1 + n)


@pytest.mark.parametrize("n,rows", [(24, 40), (31, 17)])
def test_quad_rows_matches_mul_bits(n, rows):
    rng = np.random.default_rng(5)
    qsys = QuadraticSystem([n])
    a, b, c = (_random_narrow(rng, rows, n) for _ in range(3))
    const = int(rng.integers(0, 1 << 16)) & ((1 << rows) - 1)

    want = (
        qsys.mul_bits(a, b)
        ^ qsys.mul_bits(b, c)
        ^ qsys.lift(a)
        ^ qsys.lift(c)
        ^ const
    )
    got = quad_device.quad_rows(
        qsys, pairs=[(a, b), (b, c)], linear=[a, c], const=const
    )
    got64 = packing.from_u32(np.asarray(got))
    w = want.rows
    assert np.array_equal(got64[:, : w.shape[1]], w)
    assert not got64[:, w.shape[1] :].any()


def test_solve_packed_device_equals_zeros_path():
    rng = np.random.default_rng(9)
    n, rows = 16, 200
    qsys = QuadraticSystem([n])
    a, b, c = (_random_narrow(rng, rows, n) for _ in range(3))
    zeros_bv = qsys.mul_bits(a, b) ^ qsys.lift(c) ^ ((1 << rows) - 1)
    eqs_dev = quad_device.quad_rows(
        qsys, pairs=[(a, b)], linear=[c], const=(1 << rows) - 1
    )

    want_space = qsys.solve_raw_space([zeros_bv])
    got_space = qsys.solve_raw_packed(jnp.asarray(eqs_dev), 1)
    if want_space is None:
        assert got_space is None
        return
    assert got_space.dimension == want_space.dimension
    assert got_space.origin == want_space.origin
    assert got_space.basis == want_space.basis


def test_solve_packed_accepts_host_matrices():
    lin = LinearSystem([12])
    (v,) = lin.gens()
    zeros = [v ^ 0xABC]
    eqs = lin.get_eqs_packed(zeros)
    want = lin.solve_raw_one(zeros)
    assert lin.solve_raw_packed(eqs, 0) == want  # u64 host rows
    assert lin.solve_raw_packed(packing.to_u32(eqs), 0) == want  # u32 view
    assert lin.solve_raw_packed(jnp.asarray(packing.to_u32(eqs)), 0) == want

    sols = list(lin.solve_all_packed(eqs))
    assert sols == [lin.convert_sol(want)]
    assert lin.solve_one_packed(eqs) == lin.convert_sol(want)


@pytest.mark.parametrize("n,rows", [(24, 9), (63, 40), (64, 33), (128, 1500)])
def test_mul_bits_batch_matches_host(n, rows):
    """XLA-CPU batched monomial expansion (materialize-time mulq route)
    must be bit-exact with QuadraticSystem.mul_bits, across word-boundary
    widths and a bucket-padded batch."""
    rng = np.random.default_rng(n + rows)
    qsys = QuadraticSystem([n])
    a = _random_narrow(rng, rows, n)
    b = _random_narrow(rng, rows, n)
    want = qsys.mul_bits(a, b).rows
    got = quad_device.mul_bits_batch(qsys, a.rows, b.rows)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_mul_bits_batch_chunking():
    """Batches above the top row bucket chunk transparently."""
    from gf2bv_tpu.ops.quad_device import _ROW_BUCKETS

    n = 16
    rows = _ROW_BUCKETS[-1] + 7
    rng = np.random.default_rng(3)
    qsys = QuadraticSystem([n])
    a = _random_narrow(rng, rows, n)
    b = _random_narrow(rng, rows, n)
    want = qsys.mul_bits(a, b).rows
    got = quad_device.mul_bits_batch(qsys, a.rows, b.rows)
    assert np.array_equal(got, want)


def test_lazy_mulq_routes_and_matches_host_expansion():
    """End-to-end: a lazy per-bit mul_bit trace big enough to cross the
    XLA routing threshold materializes bit-identically to the forced host
    numpy path (GF2BV_TPU_MULBITS=host)."""
    import os

    from gf2bv_tpu.core import lazy as lazy_mod
    from gf2bv_tpu.core.lazy import materialize_many

    n = 48
    qsys = QuadraticSystem([n])
    (x,) = qsys.gens()  # lazy
    zeros = [
        qsys.mul_bit(x[i], x[(i + 5) % n]) ^ x[(i + 1) % n] ^ (i & 1)
        for i in range(n)
    ]
    exprs = [z._expr for z in zeros]
    old_thresh = lazy_mod._XLA_MULBITS_MIN_WORK
    lazy_mod._XLA_MULBITS_MIN_WORK = 1  # force the XLA route
    try:
        got = materialize_many(exprs, strip_consts=True)
    finally:
        lazy_mod._XLA_MULBITS_MIN_WORK = old_thresh
    os.environ["GF2BV_TPU_MULBITS"] = "host"
    try:
        want = materialize_many(exprs, strip_consts=True)
    finally:
        del os.environ["GF2BV_TPU_MULBITS"]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))

def test_mul_bits_batch_no_cpu_backend_falls_back_to_host(monkeypatch):
    """When the JAX platform list is pinned to an accelerator (no cpu
    backend), mul_bits_batch must answer from the host numpy expansion —
    never dispatch the kernel to the default device (the product rows feed
    host-side assembly; see the device read-back cost note in the
    module)."""
    monkeypatch.setattr(quad_device, "_cpu_device", lambda: None)

    def boom(*a, **k):
        raise AssertionError("kernel dispatched without a cpu backend")

    monkeypatch.setattr(quad_device, "_mul_bits_kernel", boom)
    n, rows = 48, 64
    rng = np.random.default_rng(5)
    qsys = QuadraticSystem([n])
    a = _random_narrow(rng, rows, n)
    b = _random_narrow(rng, rows, n)
    want = qsys.mul_bits(a, b).rows
    got = quad_device.mul_bits_batch(qsys, a.rows, b.rows)
    assert np.array_equal(got, want)


def test_cpu_device_respects_pinned_platforms(monkeypatch):
    """_cpu_device must answer None from config alone when the platform
    list excludes cpu — without touching (initializing) any backend."""
    import jax

    def boom(*a, **k):
        raise AssertionError("backend initialization attempted")

    monkeypatch.setattr(quad_device.jax, "local_devices", boom)
    prev = jax.config.jax_platforms
    jax.config.update("jax_platforms", "faketpu")
    try:
        assert quad_device._cpu_device() is None
    finally:
        jax.config.update("jax_platforms", prev)
