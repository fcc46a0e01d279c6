#!/usr/bin/env python3
"""Build the port's kernels and check and time the head conv's float32
kernels on one NVIDIA GPU, without the rest of chip_smoke.py: the forward
(csrc/headconv.cu, reg_tile) and the backward kernel (csrc/headconv_bwd.cu).
A short first call after a change to either.

    python3 scripts/headconv_f32_probe.py [--out FILE]
    python3 scripts/headconv_f32_probe.py --tree DIR --times [--out FILE]

Run from the root of a checkout. Prints the card's name and power limit and
the two kernels' registers and spills (ptxas), then:

* the forward wrapper on edge cases against ``head_conv_plain`` in float32
  and bf16 (chip_smoke.py's tolerances), each launch on reg_tile: a map
  smaller than the kernel, ragged tiles, Cin = 3, 20 and 40 (not a multiple
  of the 16-channel chunk), an unaligned base, Cout 1 to 4, k = 1 to 7,
  'same' and pre-padded;
* the backward wrapper on edge cases against ``head_conv_backward_plain``,
  every gradient within 1e-4·max(1, |ref|) (plus 2e-2·|ref| in bf16), for
  several subsets of requested gradients; dW and db equal bit for bit over
  two calls;
* chip_smoke.py's finetuning checks of the head conv's Function at the
  update's shapes (192x640, N = 2 / 1), the extend configuration's feed
  (384x1248) and the multi-sequence update's N = 8;
* the device time per call of each kernel by name at every head of the
  three feeds (forward, backward, and the backward's main kernel with only
  dx or only dW and db asked for), and the forward and backward sums per
  update.

With ``--tree DIR --times`` it imports DIR's dfvo_torch (its kernels are
built under DIR/build/) and only times the forward and backward wrappers
per update at the three feeds, so that two checkouts can be compared on
one card in turns:

    for t in build/parent . . build/parent; do
        python3 scripts/headconv_f32_probe.py --tree $t --times --out build/hc_turns.jsonl
    done

The JSON line of times is appended to FILE when given. Exits non-zero on
the first disagreement; needs one GPU.
"""

import argparse
import json
import math
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, n, [h, w, cin] of the input, cout, k, pre-padded)
FWD_EDGES = [
    ("[1, 2, 3] k7", 1, (2, 3, 32), 2, 7, False),
    ("ragged k5", 2, (13, 41, 32), 2, 5, False),
    ("ragged k3 pre", 1, (11, 37, 16), 1, 3, True),
    ("cin=40 k3 pre", 1, (20, 50, 40), 1, 3, True),
    ("cin=3 k5", 2, (24, 80, 3), 2, 5, False),
    ("cout=3 k7 pre cin=20", 2, (30, 86, 20), 3, 7, True),
    ("cout=4 k1 cin=12", 2, (24, 80, 12), 4, 1, False),
]
UNALIGNED = ("unaligned k5", 2, (24, 80, 32), 2, 5, False)


def fwd_edge(cs, chk, label, n, hwc, cout, k, pre, prep=None):
    from dfvo_torch.ops.headconv import head_conv_cuda, head_conv_plain

    before = head_conv_cuda.variant_launches["reg_tile"]
    cs.check_head(chk, label, n, hwc, cout, k, pre, head_conv_cuda, head_conv_plain,
                  prep=prep, main_path=False)
    # bf16 takes tensor_core in its set (aligned, Cin 16..128, Cout <= 2, k 3..7)
    tc = prep is None and hwc[2] in (16, 32, 64, 128) and cout <= 2 and k in (3, 5, 7)
    if head_conv_cuda.variant_launches["reg_tile"] != before + 1 + (not tc):
        cs.fail(f"head_conv {label}: the float32 launch (and bf16 outside the tensor-core "
                "set) did not take reg_tile")


def bwd_edge(cs, chk, label, n, hwc, cout, k, pre, dtype=torch.float32, prep=None):
    """The backward wrapper against the closed form for several ``needs``;
    returns the largest error."""
    from dfvo_torch.ops.headconv import head_conv_backward_cuda, head_conv_backward_plain

    h, w, cin = hwc
    x = chk.randn((n, h, w, cin)).to(dtype)
    kern = chk.randn((cout, cin, k, k), 1.0 / math.sqrt(k * k * cin)).permute(2, 3, 1, 0)
    kern = kern.to(dtype)
    bias = chk.randn((cout,), 0.1).to(dtype)
    grow = k - 1 if pre else 0
    g = chk.randn((n, h - grow, w - grow, cout)).to(dtype)
    ref = head_conv_backward_plain(g.float(), x.float(), kern.float(), bias.float(), pre)
    xin = x if prep is None else prep(x)
    worst = 0.0
    for needs in [(True, True, True), (True, False, False), (False, True, False),
                  (False, False, True), (False, True, True)]:
        got = head_conv_backward_cuda(g, xin, kern, bias, pre, needs=needs)
        again = head_conv_backward_cuda(g, xin, kern, bias, pre, needs=needs)
        if not all(a is None or torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
            cs.fail(f"head_conv backward {label}: dW or db differs between two calls")
        for i, (a, r, need) in enumerate(zip(got, ref, needs)):
            if not need:
                if a is not None:
                    cs.fail(f"head_conv backward {label}: gradient {i} not asked for")
                continue
            if a.dtype != dtype:
                cs.fail(f"head_conv backward {label}: gradient {i} is {a.dtype}")
            err = (a.float() - r).abs()
            tol = ((2e-2 * r.abs() if dtype == torch.bfloat16 else 0)
                   + 1e-4 * max(1.0, r.abs().max().item()))
            bad = (err > tol).sum().item()
            if bad or not torch.isfinite(a).all():
                cs.fail(f"head_conv backward {label} needs {needs} gradient {i}: "
                        f"{bad} entries off, max err {err.max().item():.3e}")
            worst = max(worst, err.max().item())
    print(f"  backward {label} {str(dtype)[6:]}: ok (dW, db equal bit for bit), "
          f"max abs err {worst:.2e}", flush=True)
    return worst


def by_kernel(cs, fn, reps=20):
    """Device us per call of each kernel that ``fn`` launches, by name."""
    def run():
        for _ in range(reps):
            fn()

    run()
    _, events, _ = cs.profiled(run)
    return {e.key.split("(")[0].replace("void ", ""): e.self_device_time_total / reps
            for e in events}


def feeds(cs, chk):
    """The head conv's cases of one update at each feed: 192x640 (N = 2 /
    1), the extend configuration's 384x1248 (N = 2, flow heads) and the
    multi-sequence update (N = 8, flow heads)."""
    def heads(cases):
        return [c for c in cases if c["kernel"] == "head_conv"]

    return {"update 192x640": heads(cs.ft_cases(chk)),
            "flow update 384x1248": heads(cs.ft_cases(
                chk, shapes=cs.main_path_shapes((384, 1248), (384, 1248)), depth=False)),
            "update N = 8": heads(cs.ft_cases(chk, n=8, depth=False))}


def per_update(cs, cases, kernels=False):
    """Device ms of the forward and the backward of each case and their sums
    per update; with ``kernels`` also each kernel's us per call by name."""
    rows, fwd, bwd = [], 0.0, 0.0
    for case in cases:
        ins, rest, calls = case["ins"], case["rest"], case["calls"]
        cot = torch.randn_like(case["plain"](*ins, *rest))
        with torch.no_grad():
            f = cs.device_ms(lambda: case["kfn"](*ins, *rest), label=f"{case['label']} fwd")
            b = cs.device_ms(lambda: case["bwd_kfn"](cot, *ins, *rest),
                             label=f"{case['label']} bwd")
            row = {"shape": case["label"], "calls": calls, "fwd_ms": f, "bwd_ms": b,
                   "fwd_bound_ms": case["fwd_bound"][0], "bwd_bound_ms": case["bwd_bound"][0]}
            if kernels:
                row["fwd_us_by_kernel"] = by_kernel(cs, lambda: case["kfn"](*ins, *rest))
                row["bwd_us_by_kernel"] = by_kernel(cs, lambda: case["bwd_kfn"](cot, *ins, *rest))
                for part, needs in (("dx", (True, False, False)), ("dw", (False, True, True))):
                    row[f"bwd_{part}_only_us_by_kernel"] = by_kernel(
                        cs, lambda needs=needs: case["bwd_kfn"](cot, *ins, *rest, needs=needs))
        fwd += calls * f
        bwd += calls * b
        rows.append(row)
        extra = ""
        if kernels:
            def fmt(d):
                return ", ".join(f"{cs.short_kernel_name(k) if k.startswith('_Z') else k} "
                                 f"{v:.2f}" for k, v in d.items())
            extra = (f"\n      fwd us {fmt(row['fwd_us_by_kernel'])}\n      bwd us "
                     f"{fmt(row['bwd_us_by_kernel'])}\n      bwd us (dx only) "
                     f"{fmt(row['bwd_dx_only_us_by_kernel'])}\n      bwd us (dW, db only) "
                     f"{fmt(row['bwd_dw_only_us_by_kernel'])}")
        print(f"  {case['label']:36s} x{calls}: fwd {f:.4f} ms (bound "
              f"{case['fwd_bound'][0]:.4f}), bwd {b:.4f} ms (bound {case['bwd_bound'][0]:.4f})"
              + extra, flush=True)
    return {"fwd_ms": fwd, "bwd_ms": bwd,
            "fwd_bound_ms": sum(c["calls"] * c["fwd_bound"][0] for c in cases),
            "bwd_bound_ms": sum(c["calls"] * c["bwd_bound"][0] for c in cases), "rows": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout to import")
    ap.add_argument("--times", action="store_true", help="time only, no checks")
    ap.add_argument("--out", default=None, help="append the JSON line of times here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("headconv_f32_probe: no CUDA device", file=sys.stderr)
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
            if "headconv_rt" in name or "headconv_bwd" in name:
                print(f"  head conv kernel {cs.short_kernel_name(name)}: {info.get('regs')}; "
                      f"{info.get('spill')}", flush=True)
        for edge in FWD_EDGES:
            fwd_edge(cs, chk, *edge)
        fwd_edge(cs, chk, *UNALIGNED, prep=cs.misaligned)
        for label, n, hwc, cout, k, pre in FWD_EDGES:
            bwd_edge(cs, chk, label, n, hwc, cout, k, pre)
        bwd_edge(cs, chk, *UNALIGNED, prep=cs.misaligned)
        for label, n, hwc, cout, k, pre in (FWD_EDGES[1], FWD_EDGES[5]):
            bwd_edge(cs, chk, label, n, hwc, cout, k, pre, dtype=torch.bfloat16)
    by_feed = feeds(cs, chk)
    if not args.times:
        for cases in by_feed.values():
            cs.ft_kernel_checks(cases)
    sums = {}
    for feed, cases in by_feed.items():
        print(f"  per {feed}:", flush=True)
        sums[feed] = per_update(cs, cases, kernels=not args.times)
        s = sums[feed]
        print(f"  per {feed}: forward {s['fwd_ms']:.4f} ms (bound {s['fwd_bound_ms']:.4f}), "
              f"backward {s['bwd_ms']:.4f} ms (bound {s['bwd_bound_ms']:.4f})", flush=True)
    line = json.dumps({"tree": args.tree, "device": smi, "per_update": sums})
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(f"headconv_f32_probe: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
