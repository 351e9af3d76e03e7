"""Test configuration: run JAX on the CPU backend with 8 virtual devices.

Sharding / multi-device tests use a virtual device mesh
(--xla_force_host_platform_device_count=8), the standard way to validate
shard_map layouts without several accelerators. Run the suite with
``JAX_PLATFORMS=cpu python -m pytest tests/``.

The persistent compilation cache stays off in tests unless the caller
sets ``JAX_COMPILATION_CACHE_DIR``: test workers compile in parallel and
should not write into the checkout.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
