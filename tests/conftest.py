"""Test harness.

Tests run on the CPU: a virtual 8-device CPU mesh stands in for several
cards (mirrors the reference's test strategy, SURVEY.md §4: single-device
goldens + multi-device-on-one-host via the XLA host-platform device-count
flag). Tests marked `gpu` need an NVIDIA GPU; they skip here and run on
the card as a phase of chip_smoke.py.

Env vars must be set before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "mesh: requires the 8-device virtual CPU mesh")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run by chip_smoke.py)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture(autouse=True)
def _fail_on_thread_exceptions():
    """Fail any test whose worker threads die with an unhandled exception.

    Round 4's reader/writer race was masked exactly this way: a scan
    thread died with IndexError, the thread's `bad` list stayed empty,
    and the test vacuously passed (VERDICT r4 weak #2)."""
    import threading

    errors = []
    prev = threading.excepthook

    def hook(args):
        errors.append(args)
        prev(args)

    threading.excepthook = hook
    try:
        yield
    finally:
        threading.excepthook = prev
    if errors:
        first = errors[0]
        raise AssertionError(
            f"{len(errors)} unhandled thread exception(s); first: "
            f"{first.exc_type.__name__}: {first.exc_value}")
