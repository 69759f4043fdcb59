"""Force 8 host devices for the test session.

The dist-layer tests need a small multi-device mesh. 8 devices keeps the
smoke tests fast on one CPU core. The 512-device production mesh is ONLY
created by launch/dryrun.py (per its own XLA_FLAGS header) — never here.

Also: `hypothesis` is an optional dependency. When it is absent (minimal CI
images) we install a stub that marks @given property tests as skipped so the
rest of each module still collects and runs.
"""
import os
import sys
import types

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture
def mesh_4x2():
    """Flat single-pod mesh: 4 clients ("data") x 2-way TP ("model")."""
    from repro.launch.mesh import make_test_mesh

    return make_test_mesh((4, 2), ("data", "model"))


@pytest.fixture
def mesh_2x2x2():
    """Two-pod mesh: 2 pods x 2 in-pod clients ("data") x 2-way TP — the
    smallest mesh that exercises BOTH levels of the hierarchical wire."""
    from repro.launch.mesh import make_test_mesh

    return make_test_mesh((2, 2, 2), ("pod", "data", "model"))


@pytest.fixture
def mesh_1x4x2():
    """Single-pod mesh WITH a pod axis (size 1): the two-level wire code
    path whose output must bit-match mesh_4x2's flat wire."""
    from repro.launch.mesh import make_test_mesh

    return make_test_mesh((1, 4, 2), ("pod", "data", "model"))

try:  # pragma: no cover - depends on the environment
    import hypothesis  # noqa: F401
except ImportError:  # build a skip-only stand-in
    import pytest

    def _given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(reason="hypothesis not installed")(fn)

        return deco

    def _settings(*_a, **_k):
        return lambda fn: fn

    def _strategy(*_a, **_k):
        return None

    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "sampled_from", "booleans", "lists",
                  "tuples", "just", "one_of"):
        setattr(_st, _name, _strategy)

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
