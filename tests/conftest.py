"""Test configuration.

The suite runs on the CPU, as a virtual 8-device mesh
(xla_force_host_platform_device_count), so the multi-device sharding
regimes are tested without cards. Tests marked ``gpu`` need an NVIDIA
GPU: ``python -m pytest -m gpu`` selects them, and then this file leaves
JAX on its default platform; a fixture skips them on any other
(chip_smoke.py runs them on the card). Compiled programs are kept in the
persistent cache of troy_tpu.utils.jax_cache.
"""

import os


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        # XLA_FLAGS is read when the CPU client initializes (first
        # jax.devices()), which happens inside the tests.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    from troy_tpu.utils import jax_cache
    jax_cache.enable()
