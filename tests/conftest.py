"""Shared pytest config: registers the ``slow`` marker and gates the
multi-device subprocess tests behind ``--run-slow`` so the tier-1 run
(``pytest -x -q``) stays fast by default."""
import pytest


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False,
                     help="run tests marked slow (multi-device subprocess "
                          "selftests)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running multi-device subprocess test "
                   "(opt in with --run-slow)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the repro_torch kernels); "
                   "skips where none is present")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --run-slow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
