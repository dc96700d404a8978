"""Shared example bootstrap: repo-root imports + persistent compile cache.

Examples are run as scripts (``python examples/foo.py``); this makes the
in-repo package importable and points JAX at the persistent compilation
cache (utils/cache.py), so a big solver graph compiles once, not per
process.
"""

import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))
from gf2bv_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

# GF2BV_FORCE_CPU=1 pins every example to the host CPU backend: for
# machines without a GPU and for virtual-mesh runs
# (XLA_FLAGS=--xla_force_host_platform_device_count=N).
if os.environ.get("GF2BV_FORCE_CPU"):
    import jax

    jax.config.update("jax_platforms", "cpu")
