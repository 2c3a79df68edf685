"""Test configuration: CPU backend with 8 virtual devices, x64 enabled.

The reference's d/z oracles need double precision, so parity tests run
on the CPU backend (SURVEY.md §7 hard part 4).  Sharding tests use the
8-device virtual CPU mesh.  Tests that need a GPU (marker `gpu`) skip
here; chip_smoke.py runs the same checks on the card.
"""

import os

# Force-override: the environment may pin JAX_PLATFORMS to an
# accelerator and may even have imported jax already, so set both the env
# var and the live config option.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
