"""Test harness: run on the CPU backend (``JAX_PLATFORMS=cpu``) with 8
virtual devices.

Multi-device behavior (shard_map merging, mesh sharding) is exercised on a
virtual CPU mesh exactly as ``__graft_entry__.dryrun_multichip`` does; the
GPU path is covered by ``python chip_smoke.py`` and bench.py on the card.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# also holds when a plugin imported jax before this file set the variable
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {devs}"
    return devs
