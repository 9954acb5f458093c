"""Test configuration: 8 virtual CPU devices for the mesh tests.

The driver's tier-1 command runs with JAX_PLATFORMS=cpu.  Tests marked
``gpu`` take the ``gpu`` fixture, which skips them unless JAX's default
backend is a GPU (run them on the card with ``pytest -m gpu tests/``).
"""

import importlib.util
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE = "/root/reference"
INSTANCES = os.path.join(REFERENCE, "instances")
CORRUPT = os.path.join(REFERENCE, "unittests", "instances")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def instances_dir():
    return INSTANCES


@pytest.fixture(scope="session")
def corrupt_dir():
    return CORRUPT


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; jax backend is "
                    f"{jax.default_backend()!r}")
    return jax.devices()[0]


def load_root_module(name):
    """Import one of the repository's top-level scripts by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="session")
def chip_smoke():
    return load_root_module("chip_smoke")
