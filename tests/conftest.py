import numpy as np
import pytest

# NOTE: XLA_FLAGS --xla_force_host_platform_device_count is deliberately NOT
# set here — smoke tests and benchmarks must see the real single CPU device.
# Only launch/dryrun.py fakes 512 devices (and only in its own process).


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow (long-iteration PSO "
                          "runs, LM-substrate smoke compiles)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test, excluded from tier-1 unless --runslow")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(0)
