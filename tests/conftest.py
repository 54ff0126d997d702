"""Test harness: host CPU with 8 virtual devices unless `--gpu` is given.

Multi-device tests run on a host-CPU mesh (the standard JAX answer to
testing sharding without a cluster); parity tests compare against torch-cpu
oracles built from the read-only reference.

GPU tier: `python -m pytest tests -m gpu --gpu` on a machine with an NVIDIA
card keeps JAX's default platform and runs the `gpu`-marked tests. Whether
a card is present is decided inside the `gpu` fixture, never at import, so
every worker collects the same tests; without a card they skip.
"""

import os

import jax
import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--gpu", action="store_true",
        help="keep JAX's default platform (run the gpu tier on a card)",
    )


def pytest_configure(config):
    if config.getoption("--gpu"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    from anatomix_tpu.backend import platform

    if platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with -m gpu --gpu on a card)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def _has_torch():
    try:
        import torch  # noqa: F401

        return True
    except ImportError:
        return False


def _has_reference():
    return os.path.isdir("/root/reference/anatomix")


requires_torch = pytest.mark.skipif(
    not _has_torch(), reason="torch oracle not available"
)
requires_reference = pytest.mark.skipif(
    not (_has_torch() and _has_reference()),
    reason="reference repo or torch not available",
)
