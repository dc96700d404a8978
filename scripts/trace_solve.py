"""Where the time of one warm flagship solve goes on the GPU.

Traces one warm ``rref_origin_blocked`` of the MT19937 system (19968
columns, (20224, 640) u32) with ``jax.profiler`` and reduces the trace to
per-kernel counts and device time, the device busy share of the traced
window, and kernels per phase-1 loop step (each panel runs K forward and
K back steps).

Run on a machine with a GPU: python scripts/trace_solve.py [out_dir]
"""

import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cuda"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gf2bv_tpu.crypto import mt_jax  # noqa: E402
from gf2bv_tpu.ops import gauss_blocked  # noqa: E402
from gf2bv_tpu.utils import device  # noqa: E402
from gf2bv_tpu.utils.cache import enable_persistent_cache  # noqa: E402


def device_events(xplane: str):
    """(name, start_ns, duration_ns) of every event on the GPU planes."""
    pd = jax.profiler.ProfileData.from_file(xplane)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                yield ev.name, ev.start_ns, ev.duration_ns


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, -1.0
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


def main(out_dir="chiprun_out/trace_solve"):
    enable_persistent_cache()
    devs = device.require_gpu()
    print(device.device_record(devs), flush=True)
    print(device.card_line(), flush=True)
    rng = np.random.default_rng(1)
    e = mt_jax.mt19937_system_device(
        jnp.asarray(rng.integers(0, 2**32, size=624, dtype=np.uint32)), 32, 624
    )
    a = jnp.pad(e, ((0, -e.shape[0] % 256), (0, 0)))
    jax.block_until_ready(gauss_blocked.rref_origin_blocked(a, mt_jax.COLS))

    jax.profiler.start_trace(out_dir)
    t0 = time.perf_counter()
    jax.block_until_ready(gauss_blocked.rref_origin_blocked(a, mt_jax.COLS))
    wall_ns = (time.perf_counter() - t0) * 1e9
    jax.profiler.stop_trace()

    xplane = max(Path(out_dir).rglob("*.xplane.pb"), key=os.path.getmtime)
    events = list(device_events(str(xplane)))
    agg: dict = {}
    for name, _, d in events:
        c = agg.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += d
    busy = busy_ns(events)
    kw = gauss_blocked.K_PANEL // 32
    panels = min(a.shape[1] // kw, -(-(1 + mt_jax.COLS) // gauss_blocked.K_PANEL))
    steps = 2 * panels * gauss_blocked.K_PANEL
    per_step = sum(c for c, _ in agg.values() if c >= panels * gauss_blocked.K_PANEL)
    print(f"wall {wall_ns / 1e6:.3f} ms, device busy {busy / 1e6:.3f} ms, "
          f"idle share {1 - busy / wall_ns:.4f}, {len(events)} device events")
    print(f"phase-1 loop steps {steps}; events in per-step kernels {per_step} "
          f"= {per_step / steps:.2f} per step")
    for name, (c, d) in sorted(agg.items(), key=lambda kv: -kv[1][1])[:20]:
        print(f"{c:8d} {d / 1e6:10.3f} ms  {name[:70]}")


if __name__ == "__main__":
    main(*sys.argv[1:])
