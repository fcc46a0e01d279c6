#!/usr/bin/env python3
"""Build the port's kernels and check and time the cost volume's reg_tile
variant (csrc/correlation.cu) on one NVIDIA GPU, without the rest of
chip_smoke.py: a short first call after a change to that kernel.

    python3 scripts/correlation_f32_probe.py [--out FILE]
    python3 scripts/correlation_f32_probe.py --tree DIR --times [--out FILE]

Run from the root of a checkout. Prints the card's name and power limit and
the kernel's registers and spills (ptxas), then:

* the wrapper on edge cases against ``correlation_plain`` in float32 and
  bf16 (chip_smoke.py's tolerances), each float32 launch (and bf16 outside
  the tensor-core set) on reg_tile and equal bit for bit to a second launch:
  a map smaller than one tile, ragged tiles, C = 33, C = 24 in bf16,
  C = 1536, a 1x1 map, an unaligned base, a stride-2 view, D = 4 at 512
  channels;
* chip_smoke.py's finetuning checks of the cost volume's Function at the
  update's shapes (192x640, N = 2), the extend configuration's feed
  (384x1248), the multi-sequence update's N = 8 and HD3's five levels at
  D = 4;
* the device time of each launch by level (torch.profiler, us per call)
  and per update at those four feeds (float32), and per HD3 network call
  in bf16 at N = 2 and N = 64 (the 512-channel levels take reg_tile),
  beside the bounds; and, for the cost of a launch apart from its
  arithmetic, a 3 x 10 map at C = 16 to 1024 (one chunk to 64).

With ``--tree DIR --times`` it imports DIR's dfvo_torch (its kernels are
built under DIR/build/) and only times, so that two checkouts can be
compared on one card in turns:

    for t in build/parent . . build/parent; do
        python3 scripts/correlation_f32_probe.py --tree $t --times --out build/corr_turns.jsonl
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

# (label, [n, h, w, c], max_disp, stride, prepare the inputs)
EDGES = [
    ("[1, 3, 5, 64] smaller than a tile", (1, 3, 5, 64), 3, 1, None),
    ("ragged [2, 13, 41, 96]", (2, 13, 41, 96), 3, 1, None),
    ("c=33 [2, 12, 40, 33]", (2, 12, 40, 33), 3, 1, None),
    ("c=24 [2, 12, 40, 24]", (2, 12, 40, 24), 3, 1, None),
    ("c=1536 [2, 6, 20, 1536]", (2, 6, 20, 1536), 3, 1, None),
    ("1x1 [2, 1, 1, 64]", (2, 1, 1, 64), 4, 1, None),
    ("unaligned [2, 12, 40, 64]", (2, 12, 40, 64), 3, 1, "misaligned"),
    ("stride 2 [2, 48, 160, 64]", (2, 48, 160, 64), 3, 2, None),
    ("D=4 c=512 [2, 6, 20, 512]", (2, 6, 20, 512), 4, 1, None),
]


def edge(cs, chk, label, shape, d, stride, prep):
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda

    before = correlation_cuda.variant_launches["reg_tile"]
    f1, f2 = chk.randn(shape), chk.randn(shape)
    chk.compare("correlation", label, lambda a, b: correlation_cuda(a, b, d, stride),
                lambda a, b: correlation_plain(a, b, d, stride), (f1, f2),
                prep=getattr(cs, prep) if prep else None, main_path=False)
    # float32 twice (the second to check the bits), bf16 once or twice
    ran = chk.variants["correlation", label]
    want = 2 + 2 * (ran == "reg_tile")
    if correlation_cuda.variant_launches["reg_tile"] != before + want:
        cs.fail(f"correlation {label}: {correlation_cuda.variant_launches['reg_tile'] - before} "
                f"reg_tile launches, expected {want}")


def by_kernel(cs, fn, reps=20):
    """Device us per call of each kernel that ``fn`` launches, by name."""
    def run():
        for _ in range(reps):
            fn()

    run()
    _, events, _ = cs.profiled(run)
    return {cs.short_kernel_name(e.key.split("(")[0].replace("void ", "")):
            e.self_device_time_total / reps for e in events}


def feeds(cs, chk):
    """The cost volume's cases of one float32 update at each feed."""
    def corr(cases):
        return [c for c in cases if c["kernel"] == "correlation"]

    hd3 = cs.hd3_corr_shapes((192, 640))
    return {"update 192x640": corr(cs.ft_cases(chk)),
            "flow update 384x1248": corr(cs.ft_cases(
                chk, shapes=cs.main_path_shapes((384, 1248), (384, 1248)), depth=False)),
            "update N = 8": corr(cs.ft_cases(chk, n=8, depth=False)),
            "HD3 update D = 4": cs.hd3_ft_cases(chk, hd3)}


def per_feed(cs, cases, kernels):
    rows, total, bound = [], 0.0, 0.0
    for case in cases:
        ins, rest = case["ins"], case["rest"]
        with torch.no_grad():
            ms = cs.device_ms(lambda: case["kfn"](*ins, *rest), label=case["label"])
            row = {"shape": case["label"], "ms": ms, "bound_ms": case["fwd_bound"][0]}
            if kernels:
                row["us_by_kernel"] = by_kernel(cs, lambda: case["kfn"](*ins, *rest))
        total += ms
        bound += case["fwd_bound"][0]
        rows.append(row)
        extra = ""
        if kernels:
            extra = "  (" + ", ".join(f"{k} {v:.2f} us" for k, v in row["us_by_kernel"].items()) + ")"
        print(f"  {case['label']:36s} {ms * 1e3:8.2f} us (bound {case['fwd_bound'][0] * 1e3:.2f})"
              + extra, flush=True)
    return {"ms": total, "bound_ms": bound, "rows": rows}


def hd3_bf16(cs, chk, kernels):
    """HD3's five levels at D = 4 in bf16, per network call at N = 2 and 64."""
    out = {}
    for n in (2, 64):
        cases = cs.hd3_cases(chk, cs.hd3_corr_shapes((192, 640)), n, torch.bfloat16)
        rows, total, c512 = [], 0.0, 0.0
        for case in cases:
            ms = cs.device_ms(case["kfn"], label=case["shape"])
            row = {"shape": case["shape"], "ms": ms, "bound_ms": case["bound"][0]}
            if kernels:
                row["us_by_kernel"] = by_kernel(cs, case["kfn"])
            rows.append(row)
            total += ms
            c512 += ms if "512]" in case["shape"] else 0.0
            print(f"  HD3 {case['shape']:30s} {ms * 1e3:8.2f} us (bound "
                  f"{case['bound'][0] * 1e3:.2f})", flush=True)
        out[f"N = {n}"] = {"ms": total, "ms_512_channel_levels": c512,
                           "bound_ms": sum(c["bound"][0] for c in cases), "rows": rows}
        print(f"  per HD3 network call, bf16, N = {n}: {total:.4f} ms, of which the 512-channel "
              f"levels {c512:.4f}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout to import")
    ap.add_argument("--times", action="store_true", help="time only, no checks")
    ap.add_argument("--out", default=None, help="append the JSON line of times here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("correlation_f32_probe: no CUDA device", file=sys.stderr)
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
            if "correlation" in name:
                print(f"  cost volume kernel {cs.short_kernel_name(name)}: {info.get('regs')}; "
                      f"{info.get('spill')}", flush=True)
        for e in EDGES:
            edge(cs, chk, *e)
    by_feed = feeds(cs, chk)
    if not args.times:
        for cases in by_feed.values():
            cs.ft_kernel_checks(cases)
    sums = {}
    for feed, cases in by_feed.items():
        print(f"  per {feed} (float32):", flush=True)
        sums[feed] = per_feed(cs, cases, kernels=not args.times)
        print(f"  per {feed}: {sums[feed]['ms']:.4f} ms (bound {sums[feed]['bound_ms']:.4f})",
              flush=True)
    sums["HD3 bf16"] = hd3_bf16(cs, chk, kernels=not args.times)
    if not args.times:
        from dfvo_torch.ops.pallas_corr import correlation_cuda

        sums["3x10 by C"] = {}
        for c in (16, 64, 256, 1024):
            f1, f2 = chk.randn((2, 3, 10, c)), chk.randn((2, 3, 10, c))
            ms = cs.device_ms(lambda: correlation_cuda(f1, f2, 3, 1), label=f"3x10 c={c}")
            sums["3x10 by C"][c] = ms
            print(f"  [2, 3, 10, {c}] float32: {ms * 1e3:.2f} us", flush=True)
    line = json.dumps({"tree": args.tree, "device": smi, "times": sums})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(f"correlation_f32_probe: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
