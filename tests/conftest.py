import os
import sys

# The tests run on the CPU, with 8 virtual devices for the mesh tests.
# Both must be set before the first backend use.  Tests of code that runs
# only on the GPU carry the `gpu` marker and skip here (see
# tests/test_dfs_cuda.py); chip_smoke.py runs them on the card.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

import jax

from nabwa_tpu.device import setup_compile_cache

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

# persistent compilation cache: the DFS while-loop body is expensive to
# compile; cache it across test processes
setup_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
