#!/usr/bin/env python3
"""Time one online-finetuning update of one checkout of the PyTorch port at
192x640, so that two checkouts can be compared on one card in turns.

    python3 scripts/update_turns.py --tree DIR [--label NAME] [--out FILE]

DIR is the root of a checkout (for a parent commit: `git archive <commit>
dfvo_torch` unpacked into a git-ignored directory such as build/parent).
Its dfvo_torch is imported, and its kernels are built under DIR/build/.
The update is the finetune phase's of chip_smoke.py: the default
configuration with ablation_self_flow_online.yml and depth finetuning,
float32, seeded weights, one synthetic frame pair, cuDNN's TF32
convolutions on (PyTorch's default, as the CLI runs). Prints one JSON line
(CUDA-event median ms of `OnlineFinetuner.update` over five calls, and
the kernels, device time and busy share of one call under
torch.profiler) and appends it to FILE when given. Run one process per
turn, e.g.

    for t in build/parent . . build/parent; do
        python3 scripts/update_turns.py --tree $t --out build/update_turns.jsonl; done

Needs one NVIDIA GPU; exits 1 without one.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of a checkout")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None, help="append the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("update_turns: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, REPO]
    import chip_smoke as cs
    import dfvo_torch
    from dfvo_torch.ops import cuda_lib
    from dfvo_torch.utils import ConfigLoader

    if not os.path.abspath(dfvo_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {dfvo_torch.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    cuda_lib.load()
    cfg = ConfigLoader().merge_cfg([cs.CFG, cs.ABLATION_CFG])
    cfg.online_finetune.depth.enable = True
    ft, variables, state, a, b, pose = cs.ft_update_setup("cuda", SEED, cfg)

    def update():
        ft.update(variables, state, a, b, pose)

    for _ in range(2):
        update()
    ms = cs.time_cuda(update, reps=1, rounds=5)
    _, events, wall_ms = cs.profiled(update)
    kernels = sum(e.count for e in events)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    row = {"tree": args.label or os.path.relpath(tree, REPO), "update_ms": ms,
           "kernels": kernels, "device_ms": device_ms, "profiled_wall_ms": wall_ms,
           "busy_share": device_ms / wall_ms, "nvidia_smi": smi}
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
