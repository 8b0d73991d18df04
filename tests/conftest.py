import os

# Tests run on the single real CPU device; only the dry-run sets the
# 512-device flag (and runs in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# hypothesis shim: the property tests use hypothesis when it is installed
# (see requirements-dev.txt); without it we register a stub module so the
# test modules still import and their non-property tests run. @given tests
# become explicit skips instead of collection errors.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    import sys
    import types

    def _given(*_a, **_k):
        def deco(fn):
            def _skipper():
                pytest.skip("hypothesis not installed")
            _skipper.__name__ = fn.__name__
            _skipper.__doc__ = fn.__doc__
            return _skipper
        return deco

    def _settings(*_a, **_k):
        return lambda fn: fn

    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda _name: (lambda *a, **k: None)

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = lambda *_a, **_k: True
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips itself without "
        "one (run them on the card with `pytest -m cuda`)")
