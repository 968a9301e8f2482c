"""Test configuration: CPU with 8 virtual devices and float64 by default.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), which rehearses the multi-GPU
path without the GPUs.  Float64 lets golden numerics tests run the full
1e-12 residual targets of the reference protocol.

Tests marked `gpu` take the `gpu` fixture, which skips them unless JAX
sees a GPU; run them on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def rng():
    import random

    return random.Random(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX sees none)")
    return gpus[0]
