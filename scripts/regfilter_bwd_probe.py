#!/usr/bin/env python3
"""Build the port's kernels and check and time the regularization filter's
backward kernel (csrc/regfilter_bwd.cu) on one NVIDIA GPU, without the rest
of chip_smoke.py: a short first call after a change to that kernel.

    python3 scripts/regfilter_bwd_probe.py
    python3 scripts/regfilter_bwd_probe.py --tree DIR --times [--out FILE]

Run from the root of a checkout. Prints the card's name and power limit and
each kernel's registers and spills (ptxas), then:

* the backward wrapper on edge cases against
  ``reg_dist_filter_backward_plain`` on the same inputs, every gradient
  within 1e-4·max(1, |ref|) (plus 2e-2·|ref| for a bf16 gradient), for
  several subsets of requested gradients, and equal bit for bit over two
  launches: a map smaller than the window, ragged tiles, raw and flow one
  element past an aligned address, bf16, bf16 parameters with float32 data,
  logits of +-300 (every tap but the minimum underflows) and an expanded
  (stride-0) cotangent;
* chip_smoke.py's finetuning checks of the filter's Function at the
  update's shapes (192x640, N = 2), its ties and non-contiguous cotangents,
  the extend configuration's feed (384x1248) and the multi-sequence
  update's N = 8;
* the device time of each kernel at every level of an update (us per
  call, by kernel name; and of the backward with only draw, only dflow or
  only the parameter gradients asked for), and chip_smoke.py's forward and
  backward times per update at the three feeds beside the plain version's
  VJP and the bounds.

With ``--tree DIR --times`` it imports DIR's dfvo_torch (its kernels are
built under DIR/build/) and only times the backward wrapper at every level
of the three feeds (device us per call, torch.profiler) and per update, so
that two checkouts can be compared on one card in turns:

    for t in build/parent . . build/parent; do
        python3 scripts/regfilter_bwd_probe.py --tree $t --times --out build/rb_turns.jsonl
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
cs = R = None  # chip_smoke and dfvo_torch.ops.regfilter of the tree, set by main


def direct(chk, label, n, h, w, k, raw=None, cot=None, dtype=torch.float32, pdtype=None,
           prep=None):
    """The wrapper against the closed form for several ``needs`` (``prep``
    re-lays raw and the flow, same values, before the launches); returns the
    largest error."""
    kk = k * k
    raw = chk.randn((n, h, w, kk), 2.0) if raw is None else raw
    flow = chk.randn((n, h, w, 2), 4.0)
    ps = [chk.randn((1, kk, 1, 1)), chk.randn((1,)), chk.randn((1, kk, 1, 1)), chk.randn((1,))]
    cot = chk.randn((n, h, w, 2)) if cot is None else cot
    ins = [raw.to(dtype), flow.to(dtype)] + [p.to(pdtype or dtype) for p in ps]
    g = cot.to(dtype)
    ref = R.reg_dist_filter_backward_plain(g.float(), *[t.float() for t in ins], k)
    if prep is not None:
        ins[:2] = [prep(t) for t in ins[:2]]
    worst = 0.0
    for needs in [(True,) * 6, (True, False, False, False, False, False),
                  (False, True, False, False, False, False),
                  (False, False, True, True, False, False),
                  (False, True, False, False, True, True)]:
        got = R.reg_dist_filter_backward_cuda(g, *ins, k, needs=needs)
        again = R.reg_dist_filter_backward_cuda(g, *ins, k, needs=needs)
        for i, (a, b, r, need) in enumerate(zip(got, again, ref, needs)):
            if not need:
                if a is not None:
                    cs.fail(f"{label}: gradient {i} not asked for but returned")
                continue
            if a.dtype != ins[i].dtype or a.shape != ins[i].shape:
                cs.fail(f"{label}: gradient {i} is {a.dtype} {tuple(a.shape)}")
            if not torch.equal(a, b):
                cs.fail(f"{label}: gradient {i} differs between two launches")
            err = (a.float() - r).abs()
            tol = ((2e-2 * r.abs() if a.dtype == torch.bfloat16 else 0)
                   + 1e-4 * max(1.0, r.abs().max().item()))
            bad = (err > tol).sum().item()
            if bad or not torch.isfinite(a).all():
                cs.fail(f"{label} needs {needs} gradient {i}: {bad} entries off, max err "
                        f"{err.max().item():.3e}")
            worst = max(worst, err.max().item())
    print(f"  {label}: ok, max abs err {worst:.2e}", flush=True)
    return worst


def by_kernel(case, reps=20):
    """Device us per call of each kernel of the case's backward, by name."""
    ins, rest = case["ins"], case["rest"]
    g = torch.randn((*ins[0].shape[:3], 2), device="cuda")

    def run():
        for _ in range(reps):
            case["bwd_kfn"](g, *ins, *rest)

    run()
    _, events, _ = cs.profiled(run)
    return {cs.short_kernel_name(e.key.split("(")[0].replace("void ", "")):
            e.self_device_time_total / reps for e in events}


def per_update(cases, kernels):
    """The backward wrapper's device ms at each level and their sum per
    update; with ``kernels`` also each kernel's us per call by name."""
    rows, total = [], 0.0
    for case in cases:
        ins, rest = case["ins"], case["rest"]
        g = torch.randn((*ins[0].shape[:3], 2), device="cuda")
        with torch.no_grad():
            ms = cs.device_ms(lambda: case["bwd_kfn"](g, *ins, *rest),
                              label=f"{case['label']} bwd")
        row = {"shape": case["label"], "ms": ms, "bound_ms": case["bwd_bound"][0]}
        extra = ""
        if kernels:
            row["us_by_kernel"] = by_kernel(case)
            extra = "  (" + ", ".join(f"{k} {v:.2f} us" for k, v in row["us_by_kernel"].items()) + ")"
            # the backward with one output asked for: draw, dflow, the parameters
            for part, needs in (("draw", (True,) + (False,) * 5),
                                ("dflow", (False, True) + (False,) * 4),
                                ("params", (False, False) + (True,) * 4)):
                with torch.no_grad():
                    row[f"{part}_only_ms"] = cs.device_ms(
                        lambda needs=needs: case["bwd_kfn"](g, *ins, *rest, needs=needs),
                        label=f"{case['label']} {part} only")
            extra += "; only " + ", ".join(f"{part} {row[f'{part}_only_ms'] * 1e3:.2f}"
                                            for part in ("draw", "dflow", "params")) + " us"
        rows.append(row)
        total += ms
        print(f"  {case['label']:30s} backward {ms * 1e3:8.2f} us (bound "
              f"{case['bwd_bound'][0] * 1e3:.2f})" + extra, flush=True)
    return {"ms": total, "bound_ms": sum(c["bwd_bound"][0] for c in cases), "rows": rows}


def main():
    global cs, R
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout to import")
    ap.add_argument("--times", action="store_true", help="time only, no checks")
    ap.add_argument("--out", default=None, help="append the JSON line of times here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("regfilter_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, REPO]
    import chip_smoke
    import dfvo_torch
    from dfvo_torch.ops import regfilter

    if not os.path.abspath(dfvo_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {dfvo_torch.__file__}, not from {tree}")
    cs, R = chip_smoke, regfilter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    chk = cs.Checker(cs.SEED)

    def reg(cases):
        return [c for c in cases if c["kernel"] == "reg_dist_filter"]

    feeds = {"update 192x640": reg(cs.ft_cases(chk)),
             "flow update 384x1248": reg(cs.ft_cases(
                 chk, shapes=cs.main_path_shapes((384, 1248), (384, 1248)), depth=False)),
             "update N = 8": reg(cs.ft_cases(chk, n=8, depth=False))}
    if args.times:
        from dfvo_torch.ops import cuda_lib

        cuda_lib.load()
        sums = {}
        for feed, cases in feeds.items():
            sums[feed] = per_update(cases, kernels=False)
            print(f"  per {feed}: backward {sums[feed]['ms']:.4f} ms (bound "
                  f"{sums[feed]['bound_ms']:.4f})", flush=True)
        line = json.dumps({"tree": args.tree, "device": smi, "backward_per_update": sums})
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        print(f"regfilter_bwd_probe: ok in {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    ptxas = cs.build_phase()
    for name, info in ptxas.items():
        if "rf_bwd" in name:
            print(f"  filter backward kernel {cs.short_kernel_name(name)}: {info.get('regs')}; "
                  f"{info.get('spill')}", flush=True)
    direct(chk, "[1, 2, 3] k7", 1, 2, 3, 7)
    direct(chk, "ragged [2, 13, 41] k7", 2, 13, 41, 7)
    direct(chk, "unaligned raw and flow [2, 21, 45] k7", 2, 21, 45, 7, prep=cs.misaligned)
    direct(chk, "ragged [1, 9, 35] k5 bf16", 1, 9, 35, 5, dtype=torch.bfloat16)
    direct(chk, "[2, 6, 20] k3 f32 data bf16 params", 2, 6, 20, 3, pdtype=torch.bfloat16)
    big = torch.sign(chk.randn((2, 12, 40, 49))) * chk.rand((2, 12, 40, 49), 300.0, 305.0)
    direct(chk, "+-300 [2, 12, 40] k7", 2, 12, 40, 7, raw=big)
    direct(chk, "expanded cot [2, 24, 80] k5", 2, 24, 80, 5,
           cot=chk.randn((1, 1, 1, 2)).expand(2, 24, 80, 2))

    update, extend, multiseq = feeds.values()
    cs.ft_kernel_checks(update + cs.reg_ft_edge_cases(chk))
    cs.ft_kernel_checks(extend)
    cs.ft_kernel_checks(multiseq)
    for feed, cases in feeds.items():
        print(f"  per {feed}:", flush=True)
        per_update(cases, kernels=True)
    cs.ft_kernel_times(update)
    cs.ft_kernel_times(extend, per="flow update (N = 2, 1248x384)")
    cs.ft_kernel_times(multiseq, per="sequence-averaged update (N = 8)")
    print(f"regfilter_bwd_probe: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
