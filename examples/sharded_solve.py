"""Row-sharded solve across a device mesh (new capability; the
reference is single-core).

Runs on whatever devices exist: one GPU (1-device mesh — same
code path, collectives compiled away) or a virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        GF2BV_FORCE_CPU=1 python examples/sharded_solve.py
"""

import _bootstrap  # noqa: F401  (repo imports, compile cache, GF2BV_FORCE_CPU)

import numpy as np

import jax

from gf2bv_tpu.core import packing
from gf2bv_tpu.parallel import mesh as meshlib
from gf2bv_tpu.parallel.rowshard_blocked import solve_rowsharded_blocked
from gf2bv_tpu.utils.timing import timeit

cols, rows = 4096, 5120
rng = np.random.default_rng(7)
secret = rng.integers(0, 2, size=cols).astype(np.uint8)
coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
rhs = (coeff @ secret) % 2
eqs = packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)

n = jax.device_count()
mesh = meshlib.make_mesh(batch=1, rows=n)
print(f"devices: {n}, mesh: {dict(mesh.shape)}")

with timeit(f"row-sharded solve ({rows}x{cols}) over {n} device(s)"):
    got = solve_rowsharded_blocked(eqs, cols, 0, mesh)

want = packing.pack_bits(secret[None, :], cols)[0]
assert got is not None and np.array_equal(got, want)
print("recovered the secret; sharded RREF matches")
