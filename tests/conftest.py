"""Shared test fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches
must see the real (single) device; distributed tests spawn subprocesses."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 300) -> str:
    """Run python code in a subprocess with N fake CPU devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{out.stdout}\n{out.stderr}")
    return out.stdout


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's CUDA kernels); "
        "skips without one")
