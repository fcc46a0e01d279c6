#!/usr/bin/env python3
"""Build the port's kernels and check and time the regularization filter's
backward kernel (csrc/regfilter_bwd.cu) on one NVIDIA GPU, without the rest
of chip_smoke.py: a short first call after a change to that kernel.

    python3 scripts/regfilter_bwd_probe.py

Run from the root of a checkout. Prints the card's name and power limit and
each kernel's registers and spills (ptxas), then:

* the backward wrapper on edge cases against
  ``reg_dist_filter_backward_plain`` on the same inputs, every gradient
  within 1e-4·max(1, |ref|) (plus 2e-2·|ref| for a bf16 gradient), for
  several subsets of requested gradients, and equal bit for bit over two
  launches: a map smaller than the window, ragged tiles, bf16, bf16
  parameters with float32 data, logits of +-300 (every tap but the minimum
  underflows) and an expanded (stride-0) cotangent;
* chip_smoke.py's finetuning checks of the filter's Function at the
  update's shapes (192x640, N = 2), its ties and non-contiguous cotangents,
  the extend configuration's feed (384x1248) and the multi-sequence
  update's N = 8;
* the device time of each of the two kernels at level 2 and level 4, and
  chip_smoke.py's forward and backward times per update at the three feeds
  beside the plain version's VJP and the bounds.

Exits non-zero on the first disagreement; needs one GPU.
"""

import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from dfvo_torch.ops import regfilter as R  # noqa: E402


def direct(chk, label, n, h, w, k, raw=None, cot=None, dtype=torch.float32, pdtype=None):
    """The wrapper against the closed form for several ``needs``; returns
    the largest error."""
    kk = k * k
    raw = chk.randn((n, h, w, kk), 2.0) if raw is None else raw
    flow = chk.randn((n, h, w, 2), 4.0)
    ps = [chk.randn((1, kk, 1, 1)), chk.randn((1,)), chk.randn((1, kk, 1, 1)), chk.randn((1,))]
    cot = chk.randn((n, h, w, 2)) if cot is None else cot
    ins = [raw.to(dtype), flow.to(dtype)] + [p.to(pdtype or dtype) for p in ps]
    g = cot.to(dtype)
    ref = R.reg_dist_filter_backward_plain(g.float(), *[t.float() for t in ins], k)
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
    """Device us per call of each kernel of the case's backward."""
    ins, rest = case["ins"], case["rest"]
    g = torch.randn((*ins[0].shape[:3], 2), device="cuda")

    def run():
        for _ in range(reps):
            case["bwd_kfn"](g, *ins, *rest)

    run()
    _, events, _ = cs.profiled(run)
    return {e.key.split("(")[0].replace("void ", ""): e.self_device_time_total / reps
            for e in events}


def main():
    if not torch.cuda.is_available():
        print("regfilter_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    cs.build_phase()
    chk = cs.Checker(cs.SEED)
    direct(chk, "[1, 2, 3] k7", 1, 2, 3, 7)
    direct(chk, "ragged [2, 13, 41] k7", 2, 13, 41, 7)
    direct(chk, "ragged [1, 9, 35] k5 bf16", 1, 9, 35, 5, dtype=torch.bfloat16)
    direct(chk, "[2, 6, 20] k3 f32 data bf16 params", 2, 6, 20, 3, pdtype=torch.bfloat16)
    big = torch.sign(chk.randn((2, 12, 40, 49))) * chk.rand((2, 12, 40, 49), 300.0, 305.0)
    direct(chk, "+-300 [2, 12, 40] k7", 2, 12, 40, 7, raw=big)
    direct(chk, "expanded cot [2, 24, 80] k5", 2, 24, 80, 5,
           cot=chk.randn((1, 1, 1, 2)).expand(2, 24, 80, 2))

    def reg(cases):
        return [c for c in cases if c["kernel"] == "reg_dist_filter"]

    update = reg(cs.ft_cases(chk))
    cs.ft_kernel_checks(update + cs.reg_ft_edge_cases(chk))
    extend = reg(cs.ft_cases(chk, shapes=cs.main_path_shapes((384, 1248), (384, 1248)),
                             depth=False))
    cs.ft_kernel_checks(extend)
    multiseq = reg(cs.ft_cases(chk, n=8, depth=False))
    cs.ft_kernel_checks(multiseq)
    for case in (update[0], update[2], extend[0]):
        times = ", ".join(f"{k} {v:.2f}" for k, v in by_kernel(case).items())
        print(f"  {case['label']}: device us per call {times}", flush=True)
    cs.ft_kernel_times(update)
    cs.ft_kernel_times(extend, per="flow update (N = 2, 1248x384)")
    cs.ft_kernel_times(multiseq, per="sequence-averaged update (N = 8)")
    print(f"regfilter_bwd_probe: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
