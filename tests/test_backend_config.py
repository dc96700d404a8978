"""Backend/engine selection knobs: constructor param, env overrides."""

import numpy as np
import pytest

from gf2bv_tpu import LinearSystem
from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import solver


def _toy_zeros(lin, secret=0b1011):
    (x,) = lin.gens()
    return [x ^ secret], secret


@pytest.mark.parametrize("backend", ["oracle", "jax", "blocked", "native"])
def test_constructor_backend_param(backend):
    lin = LinearSystem([4], backend=backend)
    zeros, secret = _toy_zeros(lin)
    assert lin.solve_one(zeros) == (secret,)


def test_env_backend_override(monkeypatch):
    # auto would pick 'jax' for 4 cols; force the oracle and verify the
    # dispatcher honors it (the oracle never touches JAX)
    monkeypatch.setenv("GF2BV_TPU_BACKEND", "oracle")
    assert solver._auto_backend(4) == "oracle"
    monkeypatch.delenv("GF2BV_TPU_BACKEND")
    assert solver._auto_backend(4) == "jax"
    assert solver._auto_backend(4096) == "blocked"


def test_phase_engine_env_override(monkeypatch):
    """The phase-2 engine follows the JAX backend alone: the Triton kernel
    on a GPU, jnp elsewhere; no environment variable overrides it."""
    from gf2bv_tpu.ops import gauss_blocked

    monkeypatch.setenv("GF2BV_TPU_PHASE1", "pallas")
    monkeypatch.setenv("GF2BV_TPU_PHASE2", "triton")
    assert gauss_blocked.default_phase2() == "jnp"
    monkeypatch.setattr(gauss_blocked.jax, "default_backend", lambda: "gpu")
    assert gauss_blocked.default_phase2() == "triton"


def test_unknown_backend_falls_back_to_jax_path():
    # solver._solve treats any unknown name as the jax backend (the final
    # else); document that behavior
    rng = np.random.default_rng(1)
    secret = rng.integers(0, 2, size=8).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(16, 8)).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    eqs = packing.pack_bits(
        np.concatenate([rhs[:, None], coeff], axis=1), 9
    )
    want = solver.solve(eqs, 8, 0, backend="oracle")
    assert solver.solve(eqs, 8, 0, backend="jax") == want
