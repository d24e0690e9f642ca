"""The accelerator a measurement runs on.

Measurement entry points (bench.py, chip_smoke.py) refuse to run on
anything but an NVIDIA GPU — a number taken on the CPU is never reported
as a device number — and name the card and its power limit beside every
result, since a card set below its maximum power runs slower under load.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu(count: int = 1):
    """JAX's devices, if they are ``count`` or more NVIDIA GPUs; raises
    RuntimeError otherwise (there is no fallback to another device)."""
    try:
        devices = jax.devices()
    except Exception as e:  # JAX raises more than one type for a missing plugin
        raise RuntimeError(f"no GPU found by JAX ({type(e).__name__}: {e})") from e
    if devices[0].platform != "gpu" or len(devices) < count:
        raise RuntimeError(
            f"need {count} GPU(s), JAX found {len(devices)} "
            f"{devices[0].platform} device(s)"
        )
    return devices


def card_info() -> dict:
    """Name and power limit of the first card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, _, limit = out.splitlines()[0].partition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def device_fields(devices) -> dict:
    """The device as JAX reports it."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
