"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding logic is exercised without accelerators (SURVEY.md §4
implication (c): decomposition-invariance tests on a virtual mesh).

Tests that need a GPU carry the ``chip`` marker and take the ``gpu``
fixture, which skips them when no GPU is present. They run on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/test_tridiag.py
tests/test_b4b.py``.
"""

import os

# must be set before jax is imported anywhere
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

from pop2_tpu import compile_cache  # noqa: E402

compile_cache.enable()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with -m chip on the card)")
    return devs[0]


@pytest.fixture
def cpu_devices8():
    """Eight CPU devices for mesh tests; skips when fewer exist."""
    import jax
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


@pytest.fixture(scope="session")
def test_cfg():
    from pop2_tpu.config import get_config
    return get_config("test")


@pytest.fixture(scope="session")
def test_grid(test_cfg):
    from pop2_tpu.grid import build_grid
    return build_grid(test_cfg)


@pytest.fixture(scope="session")
def mini_cfg():
    from pop2_tpu.config import get_config
    return get_config("mini")


@pytest.fixture(scope="session")
def mini_grid(mini_cfg):
    from pop2_tpu.grid import build_grid
    return build_grid(mini_cfg)
