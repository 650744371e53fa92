"""Test-suite bootstrap.

* Ensures ``src/`` is importable (so ``PYTHONPATH=src`` is optional).
* If ``hypothesis`` is not installed (it is an optional dev dependency,
  see requirements-dev.txt), installs a minimal deterministic stand-in
  that supports the subset used here (``given``/``settings`` with
  ``st.integers``/``st.sampled_from``/``st.floats``/``st.booleans``) by
  running a fixed number of seeded pseudo-random examples.  Property
  tests then still execute -- with less adversarial search than real
  hypothesis, but the same invariants.
"""
import inspect
import os
import random
import sys
import types

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if _SRC not in sys.path:
    sys.path.insert(0, os.path.abspath(_SRC))


def _install_hypothesis_stub():
    mod = types.ModuleType("hypothesis")
    strategies = types.ModuleType("hypothesis.strategies")

    class _Strategy:
        def __init__(self, sample):
            self.sample = sample

    def integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rng: rng.choice(elements))

    def floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    strategies.integers = integers
    strategies.sampled_from = sampled_from
    strategies.floats = floats
    strategies.booleans = booleans

    def settings(max_examples=10, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    def given(**strats):
        def deco(fn):
            def wrapper():
                n = getattr(wrapper, "_stub_max_examples", 10)
                rng = random.Random(fn.__module__ + "." + fn.__name__)
                for _ in range(n):
                    fn(**{k: s.sample(rng) for k, s in strats.items()})
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            # zero-arg signature: pytest must not treat the strategy
            # parameters as fixtures
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    mod.given = given
    mod.settings = settings
    mod.strategies = strategies
    mod.HealthCheck = types.SimpleNamespace(all=lambda: [])
    mod.__stub__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = strategies


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skips without one")
