"""Test configuration.

By default every test runs on jax-CPU with an 8-device virtual mesh:
multi-device sharding is validated on virtual CPU devices (SURVEY.md §4:
"works under --xla_force_host_platform_device_count for CPU CI").

Tests that need the card carry the `gpu` marker and take the `gpu_device`
fixture, which skips them when JAX has no GPU. `chip_smoke.py` runs them on
the card inside its own process: it sets MPT_TESTS_ON_DEVICE=1, which
leaves JAX's platform alone here.
"""

import os

import pytest

if os.environ.get("MPT_TESTS_ON_DEVICE") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    # wins over any platform an installed plugin registered at import
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the "
                    "card")
    return gpus[0]
