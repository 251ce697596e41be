"""Test configuration: run on CPU with 8 virtual devices.

Tests validate numerics (f64) and multi-device sharding logic on the CPU;
``chip_smoke.py`` runs the same code on the GPU. The platform is forced
both through the environment and through ``jax.config`` before any test
imports jax, so a machine with a GPU still runs the suite on the CPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
