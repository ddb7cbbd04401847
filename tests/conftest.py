"""Test configuration: force CPU with 8 virtual devices so sharding tests run
anywhere (multi-device paths are validated on a virtual mesh, as
__graft_entry__.dryrun_multichip does). No test needs a GPU; the GPU checks
live in `python chip_smoke.py`."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

# Persistent compilation cache: the suite jit-compiles ~100 programs; a warm
# cache cuts a cold run from ~20 min to a few minutes.
from vloam.runtime.cache import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(16833)
