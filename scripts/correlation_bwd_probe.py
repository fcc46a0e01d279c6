#!/usr/bin/env python3
"""Build the port's kernels and check and time the cost volume's backward
kernel (csrc/correlation_bwd.cu) on one NVIDIA GPU, without the rest of
chip_smoke.py: a short first call after a change to that kernel.

    python3 scripts/correlation_bwd_probe.py [--out FILE]
    python3 scripts/correlation_bwd_probe.py --tree DIR --times [--out FILE]

Run from the root of a checkout. Prints the card's name and power limit and
the kernel's registers and spills (ptxas), then:

* chip_smoke.py's edge cases of the backward wrapper (``CORR_BWD_EDGES``:
  a map smaller than one tile, ragged tiles, C = 33, 24, 130 and 1536, a
  1x1 map, unaligned pixels, stride 2, D = 4) against
  ``correlation_backward_plain`` in float32 and bf16, with both gradients
  and each alone, every gradient equal bit for bit over two launches;
* chip_smoke.py's finetuning checks of the cost volume's Function (the
  backward kernel's gradients equal bit for bit over two launches, and in
  bf16) at the update's shapes (192x640, N = 2), the extend
  configuration's feed (384x1248), the multi-sequence update's N = 8 and
  HD3's five levels at D = 4;
* the backward wrapper's device time at every level of those four feeds
  (torch.profiler, us per call: the call, which at stride 2 includes the
  zero fill of the full-size gradients, and each kernel by name) and per
  update, beside the bounds.

With ``--tree DIR --times`` it imports DIR's dfvo_torch (its kernels are
built under DIR/build/) and only times, so that two checkouts can be
compared on one card in turns:

    for t in build/parent . . build/parent; do
        python3 scripts/correlation_bwd_probe.py --tree $t --times --out build/cb_turns.jsonl
    done

The JSON line of times is appended to FILE when given. Exits non-zero on
the first disagreement; needs one GPU.
"""

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def feeds(cs, chk):
    """The cost volume's cases of one float32 update at each feed."""
    def corr(cases):
        return [c for c in cases if c["kernel"] == "correlation"]

    return {"update 192x640": corr(cs.ft_cases(chk)),
            "flow update 384x1248": corr(cs.ft_cases(
                chk, shapes=cs.main_path_shapes((384, 1248), (384, 1248)), depth=False)),
            "update N = 8": corr(cs.ft_cases(chk, n=8, depth=False)),
            "HD3 update D = 4": cs.hd3_ft_cases(chk, cs.hd3_corr_shapes((192, 640)))}


def by_kernel(cs, fn, reps=20):
    """Device us per call of each kernel that ``fn`` launches, by name."""
    def run():
        for _ in range(reps):
            fn()

    run()
    _, events, _ = cs.profiled(run)
    return {cs.short_kernel_name(e.key.split("(")[0].replace("void ", "")):
            e.self_device_time_total / reps for e in events}


def per_feed(cs, cases):
    """The backward wrapper's device ms at each level and their sum, beside
    the bounds; each kernel's us per call by name."""
    rows, total, bound = [], 0.0, 0.0
    for case in cases:
        ins, rest = case["ins"], case["rest"]
        with torch.no_grad():
            cot = torch.randn_like(case["kfn"](*ins, *rest))

            def call(cot=cot, ins=ins, rest=rest, fn=case["bwd_kfn"]):
                return fn(cot, *ins, *rest)

            ms = cs.device_ms(call, label=f"{case['label']} bwd")
            kern = by_kernel(cs, call)
        row = {"shape": case["label"], "ms": ms, "bound_ms": case["bwd_bound"][0],
               "us_by_kernel": kern}
        total += ms
        bound += case["bwd_bound"][0]
        rows.append(row)
        print(f"  {case['label']:34s} backward {ms * 1e3:8.2f} us (bound "
              f"{case['bwd_bound'][0] * 1e3:.2f})  ("
              + ", ".join(f"{k} {v:.2f} us" for k, v in kern.items()) + ")", flush=True)
    return {"ms": total, "bound_ms": bound, "rows": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout to import")
    ap.add_argument("--times", action="store_true", help="time only, no checks")
    ap.add_argument("--out", default=None, help="append the JSON line of times here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("correlation_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, REPO]
    import chip_smoke as cs
    import dfvo_torch

    if not os.path.abspath(dfvo_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {dfvo_torch.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    chk = cs.Checker(cs.SEED)
    if args.times:
        from dfvo_torch.ops import cuda_lib

        cuda_lib.load()
    else:
        ptxas = cs.build_phase()
        for name, info in ptxas.items():
            if "correlation_bwd" in name:
                print(f"  backward kernel {cs.short_kernel_name(name)}: {info.get('regs')}; "
                      f"{info.get('spill')}", flush=True)
        cs.corr_bwd_edge_checks(chk)
    by_feed = feeds(cs, chk)
    if not args.times:
        for cases in by_feed.values():
            cs.ft_kernel_checks(cases)
    sums = {}
    for feed, cases in by_feed.items():
        print(f"  per {feed} (float32):", flush=True)
        sums[feed] = per_feed(cs, cases)
        print(f"  per {feed}: backward {sums[feed]['ms']:.4f} ms (bound "
              f"{sums[feed]['bound_ms']:.4f})", flush=True)
    line = json.dumps({"tree": args.tree, "device": smi, "backward_per_update": sums})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(f"correlation_bwd_probe: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
