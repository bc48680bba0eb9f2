"""The accelerator a measurement runs on, and the card's own report.

A measurement path needs a GPU: :func:`require_gpu` stops the process
when JAX finds none, rather than timing XLA's CPU backend under a device
metric's name.  :func:`card_line` is the card's name and power limit as
``nvidia-smi`` reports them; a card set below its maximum power runs
slower under load, so the limit goes beside every number.
"""

from __future__ import annotations

import subprocess
import sys

import jax


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU; exit non-zero if not."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX's first device is {dev.platform} "
                 f"({dev.device_kind}); this measures the card only")
    return dev


def device_report() -> dict:
    """``platform``, ``kind`` and ``count`` as JAX reports them."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    ``name, limit`` line each ("not available" when it cannot run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out or "not available"
