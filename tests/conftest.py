"""Test harness config.

By default the tests run on an 8-virtual-device CPU platform, so sharding
tests exercise a real Mesh without accelerators. Tests marked `chip` need a
GPU: here they skip, decided when each one runs, and `python chip_smoke.py`
runs them on the card. It sets JET_CHIP_TESTS=1, which keeps the real
device instead of the CPU platform.
"""
import os

import pytest

ON_CHIP = os.environ.get("JET_CHIP_TESTS", "") == "1"

if not ON_CHIP:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy statistical/FD tests — excluded from the fast tier "
        "(`pytest -m 'not slow'`, <5 min); run the full suite nightly/CI",
    )
    config.addinivalue_line(
        "markers",
        "chip: needs a GPU; skips elsewhere, run on the card by "
        "`python chip_smoke.py`",
    )


@pytest.fixture(autouse=True)
def _chip_only(request):
    if (request.node.get_closest_marker("chip")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU; run on the card by `python chip_smoke.py`")


if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

    assert jax.default_backend() == "cpu", (
        "tests must run on the virtual CPU mesh, got " + jax.default_backend()
    )
    assert len(jax.devices()) == 8, jax.devices()
