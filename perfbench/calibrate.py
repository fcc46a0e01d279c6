#!/usr/bin/env python3
"""Readings that the limits of a cell's output check are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds 101 102 ... \
        [--control-seeds 101 102 103] [--fault-seeds 201 202 203] \
        [--seconds 3] [--out FILE]

On the card, in one process: for each seed, the cell's set-up, a short
window and its check, giving the sound program's readings of every number
compared; for each control seed also the control's readings: the
reference computed in float8 (``ReferenceFrontend(precision="float8")``)
in the program's place, on the same sampled chunks, the formulas of
kernels A, B and C in float8 on the inputs those kernels were given, and
the geometry of a step that returns its state unchanged (every frame of a
chunk given the motion the chunk started from); for each fault seed, one
run with each fault of ``faults.py`` that applies to the cell planted
under the timed path. Prints one JSON
line per run and a summary: per number, the largest sound reading (the
lower), the smallest control reading (the upper) and their ratio, and per
fault the runs it left correct. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def unchanged_state_geometry(run):
    """The geometry numbers of a step that returns its state unchanged:
    every frame of a chunk gets the motion the chunk's carry held."""
    T, speed = run.chunk, run.traffic["speed"]
    from perfbench.core import rotation_deg

    rot = trans = 0.0
    prev = {}
    for i, c, poses, _ in run.records:
        held = np.eye(4) if c == 0 else prev.get(i - 1, np.eye(4))
        for j in range(T):
            gt = run.motions[c * T + j]
            rot = max(rot, rotation_deg(held[:3, :3], gt[:3, :3]))
            trans = max(trans, float(np.linalg.norm(held[:3, 3] - gt[:3, 3])) / speed)
        prev[i] = poses[-1].astype(np.float64)
    return {"rotation_deg": rot, "translation_per_m": trans}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--fault-seeds", type=int, nargs="*", default=())
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.core import Run
    from perfbench.faults import FAULTS, ONLY_FOR, Patches

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    sound, upper = {}, {}
    for seed in dict.fromkeys(list(args.seeds) + list(args.control_seeds)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run = Run(args.workload, seed)
        run.setup()
        run.window(args.seconds)
        correct, attempted, failed, checks = run.check(detail=True)
        rec = {"workload": args.workload, "seed": seed, "correct": correct,
               "frames": attempted, "failed": failed, "sampled": sorted(run.captured),
               "program": run.numbers}
        if seed in args.seeds:
            for k, v in run.numbers.items():
                sound[k] = max(sound.get(k, 0.0), v)
        if seed in args.control_seeds:
            ctl = run.network_numbers(precision="float8", detail=True)
            ctl.update(run.kernel_numbers(precision="float8"))
            ctl.update(unchanged_state_geometry(run))
            rec["control"] = ctl
            for k, v in ctl.items():
                upper[k] = min(upper.get(k, float("inf")), v)
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del run
    faults = {}
    kind = Run(args.workload, args.seeds[0]).cfg.deep_flow.network
    for name in [f for f in FAULTS if ONLY_FOR.get(f, kind) == kind]:
        for seed in args.fault_seeds:
            t0 = time.perf_counter()
            patches, run = Patches(), None
            FAULTS[name](patches.set)
            try:
                run = Run(args.workload, seed)
                run.setup()
                run.window(args.seconds)
                correct, _, _, checks = run.check()
                rec = {"workload": args.workload, "fault": name, "seed": seed,
                       "correct": correct, "program": run.numbers,
                       "failing": sorted(k for k, (v, lim) in checks.items() if not v <= lim)}
            except Exception as e:  # a fault that crashes the run has failed it
                rec = {"workload": args.workload, "fault": name, "seed": seed, "correct": False,
                       "crashed": repr(e)[:300]}
                if run is not None:
                    run.free_program()
            finally:
                patches.undo()
            rec["seconds"] = time.perf_counter() - t0
            faults.setdefault(name, []).append(rec["correct"])
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            run = None
    summary = {k: {"lower": sound[k], "upper": upper.get(k),
                   "ratio": (upper[k] / sound[k]) if k in upper and sound[k] > 0 else None}
               for k in sound}
    line = json.dumps({"workload": args.workload, "summary": summary,
                       "faults_left_correct": {k: sum(v) for k, v in faults.items()},
                       "seeds": list(args.seeds), "control_seeds": list(args.control_seeds),
                       "fault_seeds": list(args.fault_seeds)})
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
