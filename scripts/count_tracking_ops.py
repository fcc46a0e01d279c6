#!/usr/bin/env python3
"""Count the operations one ``tracking_step`` dispatches, on the CPU.

    python3 scripts/count_tracking_ops.py

Runs the port's tracking step on the scenes of ``chip_smoke.py`` (192x640,
the YAML defaults) on the CPU and counts the aten operations it dispatches,
leaving out views (reshape, slice, expand, ...), which launch no kernel. On
the card each counted operation launches about one kernel, so the count
predicts the step's launches; it is a count, not a time.
"""

import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

VIEWS = {"view", "_unsafe_view", "reshape", "expand", "slice", "select", "unsqueeze",
         "squeeze", "permute", "transpose", "t", "as_strided", "alias", "detach",
         "diagonal", "unbind", "split", "lift_fresh"}


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_name = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name not in VIEWS:
            self.by_name[name] = self.by_name.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def main():
    tcfg = chip_smoke.track_tcfg()
    for name, (inputs, _) in chip_smoke.track_scenes().items():
        call = chip_smoke.track_call(inputs, "cpu", tcfg)
        with OpCounter() as counter:
            out = call()
        top = sorted(counter.by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"{name:9s} mode {int(out['mode'])}: {sum(counter.by_name.values())} ops; "
              f"most: {', '.join(f'{k} {v}' for k, v in top)}")


if __name__ == "__main__":
    main()
