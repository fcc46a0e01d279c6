#!/usr/bin/env python3
"""Time the CUDA kernel wrappers of one checkout of the PyTorch port at the
level-2 shapes of the main path, in bfloat16, so that two checkouts can be
compared on one card in turns.

    python3 scripts/kernel_turns.py --tree DIR [--label NAME] [--out FILE]

DIR is the root of a checkout (for a parent commit: `git archive <commit>`
unpacked into a git-ignored directory such as build/parent). Its
dfvo_torch is imported, and its kernels are built under DIR/build/. Each
wrapper is called as the main path calls it: the correlation on the
[::2, ::2] view of f1, the head conv on the permuted OIHW bf16 weight
parameter, and the regularization filter from the raw confidence logits:
through the fused ``reg_dist_filter_cuda`` where the checkout has it, else
as the normalisation ops (pow, neg, amax, sub, exp) followed by
``reg_scale_filter_cuda``, the form such a checkout runs. Prints one JSON line of device times per call (torch.profiler,
``device_ms``) and CUDA-event medians of back-to-back calls (``event_ms``)
and appends it to FILE when given. Run one process per turn, e.g.

    for t in build/parent . . build/parent; do
        python3 scripts/kernel_turns.py --tree $t --out build/turns.jsonl; done

Needs one NVIDIA GPU; exits 1 without one.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEED = 0
BATCHES = (2, 64)


def normalise(raw):
    """The five ops (pow, neg, amax, sub, exp) that normalised the raw
    logits before the fused kernel."""
    dist = -(raw**2)
    return torch.exp(dist - torch.amax(dist, dim=-1, keepdim=True))


def reg_dist_filter(regfilter, raw, flow, p):
    """The regularization filter from the raw logits, k = 7, as the
    checkout's main path runs it."""
    if hasattr(regfilter, "reg_dist_filter_cuda"):
        return regfilter.reg_dist_filter_cuda(raw, flow, *p, 7)
    return regfilter.reg_scale_filter_cuda(normalise(raw), flow, *p, 7)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of a checkout")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None, help="append the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, REPO]
    from chip_smoke import device_ms, time_cuda
    import dfvo_torch
    from dfvo_torch.ops.headconv import head_conv_cuda
    from dfvo_torch.ops.pallas_corr import correlation_cuda
    from dfvo_torch.ops import regfilter

    if not os.path.abspath(dfvo_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {dfvo_torch.__file__}, not from {tree}")
    rng = np.random.default_rng(SEED)

    def randn(shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).cuda().bfloat16()

    cases = {}
    for n in BATCHES:
        f1 = randn((n, 96, 320, 64))[:, ::2, ::2]
        f2 = randn((n, 48, 160, 64))
        raw = randn((n, 96, 320, 49), 2.0)
        flow = randn((n, 96, 320, 2), 4.0)
        p = [randn((1, 1, 49, 1)), randn((1,)), randn((1, 1, 49, 1)), randn((1,))]
        x = randn((n, 96, 320, 32))
        kern = randn((2, 32, 7, 7), 0.025).permute(2, 3, 1, 0)
        bias = randn((2,), 0.1)
        cases[f"correlation L2 N={n}"] = (
            lambda f1=f1, f2=f2: correlation_cuda(f1, f2, 3, 1))
        cases[f"reg_dist_filter L2 N={n}"] = (
            lambda d=raw, f=flow, p=p: reg_dist_filter(regfilter, d, f, p))
        cases[f"head_conv L2 N={n}"] = (
            lambda x=x, k=kern, b=bias: head_conv_cuda(x, k, b))
    # the normalisation ops alone at every level of one infer_chunk network
    # call (N = 64): the device time that the fused kernel takes over
    for lvl, (h, w), k in ((2, (96, 320), 7), (3, (48, 160), 5), (4, (24, 80), 5),
                           (5, (12, 40), 3), (6, (6, 20), 3)):
        raw = randn((64, h, w, k * k), 2.0)
        cases[f"normalisation ops L{lvl} k{k} N=64"] = lambda d=raw: normalise(d)
    device = {name: device_ms(fn) for name, fn in cases.items()}
    event = {name: time_cuda(fn, reps=20) for name, fn in cases.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    line = json.dumps({"label": args.label or args.tree, "tree": args.tree,
                       "device": smi, "device_ms": device, "event_ms": event})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
