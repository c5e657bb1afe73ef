"""Shared pytest fixtures.

NOTE: no XLA_FLAGS device-count override here — smoke tests and benches must
see the single real CPU device.  Multi-device behaviour is tested via
subprocesses that set ``--xla_force_host_platform_device_count`` themselves
(see tests/test_distributed.py and tests/test_dryrun_small.py).
"""
import jax
import pytest


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips elsewhere)")
