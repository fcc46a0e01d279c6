"""Keep a long-lived pytest process under the kernel's memory-map limit.

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

This file imports no JAX of its own: ``tests/conftest.py`` must configure
JAX's platform and devices before anything imports it.
"""

import gc
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
