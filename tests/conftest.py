"""Test harness config: run everything on CPU with 8 virtual devices.

SURVEY.md §4 item 5: JAX simulates a device mesh on one host via
``--xla_force_host_platform_device_count``; the identical shard_map renderer
runs on 8 fake devices so distribution is tested without a GPU host.  The
CPU backend is pinned here (as with ``JAX_PLATFORMS=cpu``), so the tests
never touch a GPU even where one is present.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
