"""Named, grouped wall-clock timers with per-item mean reporting.

Counterpart of ``dfvo_tpu/utils/timer.py``. Times are host wall times.
``scope`` also opens a ``torch.profiler.record_function`` range of the
same name, so a profiler trace carries the stage names (the JAX version
opens a ``jax.named_scope``).
"""

import time
from collections import OrderedDict
from contextlib import contextmanager

from torch.profiler import record_function


class Timer:
    """start/end named timers; ``time_analysis`` prints per-item means."""

    def __init__(self):
        self.timers = OrderedDict()

    def add(self, name, group=None):
        self.timers[name] = {"name": name, "group": group, "times": [], "start": None}

    def start(self, name, group=None):
        if name not in self.timers:
            self.add(name, group)
        item = self.timers[name]
        if item["start"] is not None:
            raise RuntimeError(f"timer [{name}] has started already")
        item["start"] = time.time()

    def end(self, name):
        item = self.timers[name]
        if item["start"] is None:
            raise RuntimeError(f"timer [{name}] has not started")
        item["times"].append(time.time() - item["start"])
        item["start"] = None

    @contextmanager
    def scope(self, name, group=None):
        """Time a block and mark it in the profiler trace with the same name."""
        self.start(name, group)
        with record_function(name.replace(" ", "_")):
            try:
                yield
            finally:
                self.end(name)

    def get_mean(self, name):
        times = self.timers[name]["times"]
        return sum(times) / len(times) if times else 0.0

    def time_analysis(self):
        """Print per-item mean seconds by group; return {name: mean s}."""
        print("----- time breakdown -----")
        groups = OrderedDict()
        for item in self.timers.values():
            groups.setdefault(item["group"], []).append(item)
        for group, items in groups.items():
            if group is not None:
                print(f"[{group}]")
            for item in items:
                if item["times"]:
                    print(f"  {item['name']}: {self.get_mean(item['name']):.4f}s")
        return {name: self.get_mean(name) for name, item in self.timers.items() if item["times"]}
