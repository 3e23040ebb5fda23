"""Test configuration: the tests run on the CPU backend with 8 virtual
devices, so multi-device sharding tests run anywhere (the standard
fake-backend trick; SURVEY.md section 4).  The platform is forced in
jax.config too, before any backend is materialized (clients are created
lazily on first jax.devices()/dispatch), in case JAX was imported first.
The card's own checks are ``python chip_smoke.py`` (README)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Fast/slow tiers: the slow tier holds the compile-heavy tests (golden
# configs, virtual-mesh sharding) so `pytest -m "not slow"` runs the
# unit/parity tier in about a minute.  Whole modules
# are marked here; individual slow tests in mixed modules carry their own
# @pytest.mark.slow.
_SLOW_MODULES = {
    "test_golden_configs",
    "test_golden_sphere",
    "test_sharding",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
