"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding logic is validated on host-platform virtual devices. Tests that
need the GPU are marked ``gpu`` and take the ``gpu_device`` fixture, which
skips them unless JAX runs on a GPU. On a machine with a card:

    ROVINA_GPU_TESTS=1 python -m pytest tests/ -m gpu

``ROVINA_GPU_TESTS=1`` lifts the CPU pin; every other run stays on the CPU.
"""

import os

import pytest

GPU_MODE = os.environ.get("ROVINA_GPU_TESTS") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not GPU_MODE and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

if not GPU_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")

from rovinasemanticsegmentation_tpu.utils.compile_cache import (  # noqa: E402
    setup_compile_cache,
)

# Most of the suite's wall time is XLA:CPU compiles of the same graphs.
setup_compile_cache(min_compile_time_secs=0.5)


@pytest.fixture
def gpu_device():
    """The GPU the test runs on; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: ROVINA_GPU_TESTS=1 python -m pytest -m gpu")
    return jax.devices()[0]
