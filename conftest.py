"""Keep a long-lived pytest process under the kernel's memory-map limit,
keep pytest-xdist workers from oversubscribing the CPU with torch
threads, and hand xdist's load scheduler one test at a time.

Every program that XLA:CPU compiles keeps its code in memory maps of its
own for as long as JAX's in-process caches hold the executable, and those
caches never let go in a test process. A pytest-xdist worker that compiles
many large programs (the multi-sequence, chunked-inference and full
pipeline tests) therefore climbs towards ``vm.max_map_count`` (65530 by
default); at the limit ``mmap`` fails inside XLA, and the next large
compile or ``executable.serialize()`` ends the worker with a segfault.

Before each test, :func:`pytest_runtest_setup` counts the process's maps.
Past half the limit it drops JAX's in-process compilation caches
(``jax.clear_caches()``), which frees the executables no test holds any
more; later tests that need one of them load it from the persistent
compilation cache or compile it again. Below that mark it does nothing.

Each pytest-xdist worker's torch would run its CPU ops on a thread per
core, so six workers on eight cores run 48 spinning OpenMP threads and the
workers slow each other several times over. After collection,
:func:`pytest_collection_finish` gives each worker's torch its share of
the cores (``torch.set_num_threads``); a run without workers keeps
torch's default.

xdist's ``--dist load`` scheduler sends each worker blocks of tests that
are consecutive in collection order (at the start, a quarter of its
share of the suite); the suite's
minutes-long JAX integration tests (finetune, multiseq, resume, scan
runner) then pile up on a few workers while the others sit idle at the
end. :func:`pytest_configure` sets ``--maxschedchunk`` to 1 unless the
command line sets it, so a worker that finishes takes the next test:
cold full runs of the same tree took 1724 s with the blocks and 1109 s
one test at a time, on 8 cores with 6 workers.

This file imports no JAX or torch of its own: ``tests/conftest.py`` must
configure JAX's platform and devices before anything imports it.
"""

import gc
import os
import sys

_MAPS = "/proc/self/maps"


def _map_limit():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


_THRESHOLD = _map_limit() // 2


def _map_count():
    try:
        with open(_MAPS, "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # not Linux: nothing to guard
        return 0


def pytest_runtest_setup(item):
    jax = sys.modules.get("jax")
    if jax is None or _map_count() < _THRESHOLD:
        return
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    if getattr(config.option, "maxschedchunk", 0) is None:  # xdist, not set
        config.option.maxschedchunk = 1


def worker_threads():
    """Cores per pytest-xdist worker (at least 1); None outside a worker."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not os.environ.get("PYTEST_XDIST_WORKER") or not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


def pytest_collection_finish(session):
    torch = sys.modules.get("torch")
    threads = worker_threads()
    if torch is not None and threads is not None:
        torch.set_num_threads(threads)
