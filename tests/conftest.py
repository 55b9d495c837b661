"""Test configuration: force the CPU backend with 8 virtual devices so
multi-device sharding tests run without accelerators (SURVEY.md §5).

jax.config.update overrides a JAX_PLATFORMS preset in the environment.
XLA_FLAGS is read lazily at CPU client creation, so setting it here
(before the first jax operation) works.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
