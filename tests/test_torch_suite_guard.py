"""The root conftest's memory-map guard: it leaves JAX's caches alone below
half of ``vm.max_map_count`` and clears them past it."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def guard():
    spec = importlib.util.spec_from_file_location(
        "root_conftest_guard", os.path.join(REPO, "conftest.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cleared(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax, "clear_caches", lambda: calls.append(1))
    return calls


def test_limit_and_count_are_read(guard):
    assert guard._map_limit() > 0
    assert guard._THRESHOLD == guard._map_limit() // 2
    if os.path.exists("/proc/self/maps"):
        assert guard._map_count() > 0


@pytest.mark.parametrize("over", [False, True])
def test_clears_jax_caches_only_past_the_threshold(guard, cleared, monkeypatch, over):
    count = guard._map_count()
    monkeypatch.setattr(guard, "_THRESHOLD", count if over else count + 10**6)
    guard.pytest_runtest_setup(None)
    assert cleared == ([1] if over else [])
