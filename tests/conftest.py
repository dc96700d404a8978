"""Test config: force JAX onto an 8-device virtual CPU mesh.

GPU measurement happens in bench.py and chip_smoke.py; tests must run
anywhere and must exercise the multi-device sharding paths, so we ask XLA
for 8 host devices (the standard way to test jax.sharding code without
hardware).  Only an explicit ``JAX_PLATFORMS=cuda`` keeps the GPU, for the
``gpu``-marked tests (tests/test_gpu.py).
Must run before jax is imported anywhere.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS") not in ("cuda", "gpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# the suite's job is to exercise the device code paths on the virtual mesh, so
# force auto-routing onto blocked/jax here (hard assignment, like the
# platform pin below: an exported =1 must not silently reroute the suite);
# the CPU->native preference has its own tests (test_cpu_native_routing.py)
os.environ["GF2BV_TPU_CPU_NATIVE"] = "0"

# Pin the platform through jax.config too, in case JAX was imported
# before this file ran.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided per test, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda on a machine with one")
