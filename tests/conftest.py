import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

# Optional dev dependency: the property tests use hypothesis when present,
# and fall back to a deterministic sampler (tests/_hypothesis_fallback.py)
# when it isn't installed — the suite must collect on a bare container.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _path = os.path.join(os.path.dirname(__file__),
                         "_hypothesis_fallback.py")
    _spec = importlib.util.spec_from_file_location("hypothesis", _path)
    _mod = importlib.util.module_from_spec(_spec)
    sys.modules["hypothesis"] = _mod
    _spec.loader.exec_module(_mod)

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see the single real CPU device; only the dry-run uses 512
# virtual devices (see repro/launch/dryrun.py).

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and nvcc; skips without one "
        "(on the card: PYTHONPATH=src python -m pytest --noconftest -m gpu "
        "tests/test_torch_device.py)")
