"""The root conftest's guards: the memory-map guard leaves JAX's caches
alone below half of ``vm.max_map_count`` and clears them past it; the
thread guard gives each pytest-xdist worker's torch its share of the
cores and leaves a run without workers alone; the scheduling default
hands xdist's load scheduler one test at a time unless the command line
says otherwise."""

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


@pytest.mark.parametrize("env,cores,want", [
    ({}, 8, None),  # no xdist: torch keeps its default
    ({"PYTEST_XDIST_WORKER": "gw0", "PYTEST_XDIST_WORKER_COUNT": "6"}, 8, 1),
    ({"PYTEST_XDIST_WORKER": "gw3", "PYTEST_XDIST_WORKER_COUNT": "2"}, 8, 4),
    ({"PYTEST_XDIST_WORKER": "gw1", "PYTEST_XDIST_WORKER_COUNT": "16"}, 8, 1),
])
def test_worker_torch_threads(guard, monkeypatch, env, cores, want):
    import torch

    for key in ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
    calls = []
    monkeypatch.setattr(torch, "set_num_threads", calls.append)
    assert guard.worker_threads() == want
    guard.pytest_collection_finish(None)
    assert calls == ([] if want is None else [want])


@pytest.mark.parametrize("given,want", [(None, 1), (4, 4), ("absent", "absent")])
def test_load_scheduler_chunk_default(guard, given, want):
    option = type("Option", (), {})()
    if given != "absent":  # "absent": xdist not loaded, no such option
        option.maxschedchunk = given
    guard.pytest_configure(type("Config", (), {"option": option})())
    assert getattr(option, "maxschedchunk", "absent") == want
