"""Compiled GPU kernels against the plain formulation.  Each test needs a
GPU and skips elsewhere (the ``gpu`` fixture); run them on a machine with
one as ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``."""

import numpy as np
import pytest

import jax.numpy as jnp

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import gauss_blocked, triton_update
from gf2bv_tpu.ops.gauss_ref import solve_oracle
from gf2bv_tpu.ops.triton_update import rank_k_update_triton

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("w0", [None, 0, 300])
def test_triton_update_compiled(gpu, w0):
    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.integers(0, 2**32, size=(2048, 512), dtype=np.uint32))
    s = jnp.asarray(rng.integers(0, 2**32, size=(2048, 8), dtype=np.uint32))
    pf = jnp.asarray(rng.integers(0, 2**32, size=(256, 512), dtype=np.uint32))
    full = np.asarray(gauss_blocked.rank_k_update_jnp(a, s, pf))
    got = np.asarray(rank_k_update_triton(a, s, pf, None if w0 is None else jnp.int32(w0)))
    tw = triton_update.TW
    live = max((w0 or 0) // tw * tw, tw)  # first live word past tile 0
    assert np.array_equal(got[:, :tw], full[:, :tw])
    assert np.array_equal(got[:, live:], full[:, live:])
    assert np.array_equal(got[:, tw:live], np.asarray(a)[:, tw:live])


@pytest.mark.parametrize("engine", ["jnp", "triton"])
def test_fused_solve_compiled_vs_oracle(gpu, engine):
    rng = np.random.default_rng(9)
    cols, rows = 4000, 4100
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    eqs = packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)
    a = jnp.asarray(gauss_blocked._pad(eqs, 256, word_align=128))
    origin32, unsat = gauss_blocked.rref_origin_blocked(a, cols, 256, engine)
    assert not bool(unsat)
    got = packing.words_to_int(packing.from_u32(np.asarray(origin32)[None, :])[0])
    assert got == packing.words_to_int(solve_oracle(eqs, cols, mode=0).origin)
