"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the single real CPU device; only
``launch/dryrun.py`` requests 512 placeholder devices (and only in its own
process)."""

import sys
import types

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Optional-import shim for ``hypothesis``: several test modules use
# property-based tests (@given/@settings + strategies). On a bare interpreter
# without hypothesis installed, collection must still succeed — install a
# stub module whose @given decorator turns each property test into a skip.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    def _given(*_args, **_kwargs):
        def deco(fn):
            def skipper(*a, **k):
                pytest.skip("hypothesis not installed "
                            "(property-based case skipped)")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper
        return deco

    def _settings(*_args, **_kwargs):
        def deco(fn):
            return fn
        return deco

    class _Strategy:
        """Inert placeholder: strategy expressions build but never draw."""

        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "lists", "floats", "booleans", "sampled_from",
                  "tuples", "text", "composite", "just", "one_of",
                  "dictionaries"):
        setattr(_st, _name, _Strategy())

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(too_slow=None,
                                             filter_too_much=None)
    _hyp.assume = lambda *_a, **_k: True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

from repro.core import ClusterSpec, CostModel, ModelSpec


@pytest.fixture
def tiny_model() -> ModelSpec:
    return ModelSpec(name="tiny", n_layers=8, d_model=256, n_heads=8,
                     n_kv_heads=4, head_dim=32, d_ff=1024, vocab=512)


@pytest.fixture
def small_cluster() -> ClusterSpec:
    return ClusterSpec(d_p=4, d_s=4, flops_per_chip=197e12, hbm_bytes=16e9)


@pytest.fixture
def cost_model(tiny_model, small_cluster) -> CostModel:
    return CostModel(tiny_model, small_cluster)


@pytest.fixture
def skewed_lengths():
    rng = np.random.default_rng(42)
    lens = np.clip(rng.lognormal(7.5, 1.1, 48).astype(int), 64, 65536)
    lens[0] = 65536
    return [int(x) for x in lens]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one "
        "(run on the card: python -m pytest -m gpu tests/test_torch_*.py)")
