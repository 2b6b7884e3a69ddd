"""What a measurement ran on: the JAX device and the card's power limit.

Every timing this repo reports names its device (platform, device kind,
count) and, on a GPU, the card's name and power limit, because a card set
below its maximum power runs slower under load.
"""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """The device as JAX reports it."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power() -> str:
    """`name, power.limit` of each card, as nvidia-smi prints them. Runs
    in a child process that never imports JAX, so it reserves no device
    memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().replace("\n", " | ")
