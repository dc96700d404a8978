"""Serving-scale state recovery: a fleet of PRNG instances, one captured
model, instances sharded across a device mesh (new capability — the
reference solves each instance with its own full PLUQ on one core,
``/root/reference/gf2bv/_internal.c:359-502``).

The pattern: capture the model ONCE (zero per-instance Python re-trace),
then feed batches of observed outputs; every instance becomes one
appended RHS column of a shared elimination (`ops/multi_rhs.py`), and the
mesh shards instances across devices with the coefficient matrix
replicated — zero collectives, so throughput is devices x the single-chip
rate (measured 119k full MT19937 recoveries/s/chip at B=32768,
BASELINE.md).

Runs on whatever devices exist: one GPU (1-device mesh), several, or a
virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        GF2BV_FORCE_CPU=1 python examples/serving_multi_rhs.py
"""

import os

# On a CPU-pinned run the auto backend would route to the native host
# engine and (with a warning) ignore the mesh — this example exists to
# demonstrate the SHARDED path, so keep the device backends in play.
os.environ.setdefault("GF2BV_TPU_CPU_NATIVE", "0")

import _bootstrap  # noqa: F401  (repo imports, compile cache, GF2BV_FORCE_CPU)

import random

import jax

from gf2bv_tpu import LinearSystem
from gf2bv_tpu.crypto.lfsr import GaloisLFSR
from gf2bv_tpu.parallel import mesh as meshlib
from gf2bv_tpu.utils.timing import timeit

WIDTH, TAPS, NOUT = 96, (1 << 95) | (1 << 81) | (1 << 17) | 0b101, 120
B = 64  # instances per serving batch

lin = LinearSystem([WIDTH])


def model(gens, p):
    (x,) = gens
    sym = GaloisLFSR(WIDTH, TAPS, x)
    return [sym() ^ p[i] for i in range(NOUT)]


with timeit("capture model (once)"):
    tmpl = lin.capture(model)

# a fleet of independent keystreams to recover
keys, batch = [], []
for k in range(B):
    key = random.Random(1000 + k).getrandbits(WIDTH) | 1
    stream = GaloisLFSR(WIDTH, TAPS, key)
    keys.append(key)
    batch.append([stream() for _ in range(NOUT)])

mesh = meshlib.make_mesh(batch=jax.device_count(), rows=1)
print(f"devices: {jax.device_count()}, mesh: {dict(mesh.shape)}")

with timeit(f"serve batch of {B} (cold: compile + upload)"):
    sols = tmpl.solve_raw_batch(batch, 0, mesh=mesh)
with timeit(f"serve batch of {B} (warm)"):
    sols = tmpl.solve_raw_batch(batch, 0, mesh=mesh)

assert all(s == k for s, k in zip(sols, keys)), "recovery mismatch"
print(f"all {B} keys recovered across {jax.device_count()} device(s); "
      "one shared elimination per device, zero collectives")
