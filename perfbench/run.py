#!/usr/bin/env python3
"""Run one cell of the benchmark of dfvo_torch on this machine's card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (import, kernel build on a first run,
seeded weights and drive on the card, one warm pass over the drive's
chunks) is timed from this file's first line to the window's start. The
window tracks chunks until ``--seconds`` have passed. ``--trace 0``
reports the cell's end-to-end metrics; ``--trace 1`` profiles a few
chunks in the middle of the window and reports the per-layer metrics.
After the window the outputs are checked against the plain reference, and
the last line of standard output is the result as one JSON object.

Exits non-zero, with no result, where no CUDA card is visible, where fewer
cards than the cell asks for are, where the program cannot be imported,
or where the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    args.t_start = T_START
    # every cache the program or torch may write stays in this checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "perfbench" / sub))
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import core

    cell = core.load_benchmark(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no CUDA card, or fewer than the {cell['chips']} the cell asks for "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    return core.main(args)


if __name__ == "__main__":
    sys.exit(main())
