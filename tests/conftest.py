"""Test harness: force the CPU backend with 8 virtual devices.

Multi-card sharding is validated on a simulated 8-device CPU mesh
(`--xla_force_host_platform_device_count`), per SURVEY.md §4. The GPU
runs are `chip_smoke.py` and `bench.py`; keeping tests off the card also
keeps each test worker from reserving its memory.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
