"""The accelerator a measurement runs on: the check that it is a GPU and
the lines that name it.  A measurement that finds no GPU fails; it never
falls back to the CPU."""

from __future__ import annotations

import json
import subprocess


def require_gpu(devices=None):
    """The JAX devices, which must be GPUs; anything else raises."""
    import jax

    devices = list(devices if devices is not None else jax.devices())
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "nothing"
        raise RuntimeError(f"no GPU: JAX runs on {found}")
    return devices


def device_record(devices) -> dict:
    """platform, kind and count as JAX reports them."""
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}


def card_line() -> str:
    """Each card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def result_line(devices) -> str:
    """The last line of a passing run: ``{"ok": true, "device": {...}}``."""
    return json.dumps({"ok": True, "device": device_record(devices)})
