import os
import signal
import sys
import threading

# tests see the real (single-CPU) device topology; ONLY the dry-run forces 512
# placeholder devices. Keep XLA quiet and deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Per-test timeout (seconds): an executor/hub deadlock must fail ITS test
# fast instead of hanging the whole CI job until the runner-level kill.
# SIGALRM-based (no pytest-timeout in the base image); a no-op on platforms
# without it or off the main thread. 0 disables.
TEST_TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips inside the test when "
        "torch.cuda.is_available() is false")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if (TEST_TIMEOUT_S <= 0 or not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        return (yield)

    def _alarm(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded the {TEST_TIMEOUT_S}s per-test "
            f"timeout (REPRO_TEST_TIMEOUT)")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(TEST_TIMEOUT_S)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session")
def host_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
