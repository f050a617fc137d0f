"""Test harness: run everything on a virtual 8-device CPU mesh.

Sharding correctness is validated on a forced 8-device CPU host platform.
Tests marked ``gpu`` need a card; run them there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` — the platform is
taken from ``JAX_PLATFORMS`` (default cpu), and on cpu the 8 virtual
devices are required.
"""

import os

_platform = os.environ.get("JAX_PLATFORMS") or "cpu"
if _platform == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

jax.config.update("jax_platforms", _platform)

import numpy as np
import pytest

if _platform == "cpu":
    assert len(jax.devices()) == 8, f"expected 8 CPU devices, got {jax.devices()}"


@pytest.fixture
def rng():
    return np.random.default_rng(0)
