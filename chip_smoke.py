#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dfvo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out build/chip_smoke/chip_smoke.json]

Run from the root of a checkout. Phases, each printed with its result and
seconds, none caught:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for every float32 comparison.
2. build: the CUDA kernels of dfvo_torch/csrc, compiled with nvcc for
   sm_90a; registers and spills of each kernel from `ptxas -v`.
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the main path gives it, in float32 (the cuda_core variants)
   and bfloat16 (the tensor_core variants of the head conv and the cost
   volume, the fused normalisation and filter from the raw confidence
   logits), and the off-path cases.
4. slice: DeepFrontend from options/examples/default_configuration.yml
   (192x640, bfloat16, seeded random weights) runs `infer` on 8 consecutive
   pairs of synthetic frames, `infer_chunk` on a 33-frame chunk and
   `local_bestN` on every pair; launch counters must show each kernel on
   that path (5 correlations and 14 head convs per network call, all
   tensor_core, and 5 regularization filters, async_tile).
5. parity: the float32 slice on the card against the plain slice on the
   CPU, and the bfloat16 slice with the kernels against the same slice with
   the three CUDA wrappers swapped for their plain versions.
6. times: CUDA-event medians of `infer` and `infer_chunk` per frame, and of
   every kernel at every main-path shape (N = 64 LiteFlowNet, N = 32 depth,
   and level 2 at N = 2) beside its plain version, its bound and, for the
   head conv, one cuDNN `F.conv2d` call (the yardstick; the port never
   calls it).
7. profile: device time by kernel name of one `infer` and one
   `infer_chunk` call (torch.profiler), written next to the report as
   profile_infer.txt and profile_infer_chunk.txt; no pow, neg, amax, sub or
   exp may run on a [N,H,W,k²] confidence tensor (the kernel normalises it).

Weights and inputs are drawn from SEED.

It ends with a JSON line of the kernels, the nvidia-smi line, and the result
line {"ok": true, "device": {...}}. It exits non-zero, printing no result,
when no CUDA device is available or any phase fails.
"""

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "options", "examples", "default_configuration.yml")

# main-path shapes at 192x640 (N = 2 in infer, 2(M-1) = 64 in infer_chunk)
LFN_BATCHES = (2, 64)
DEPTH_BATCHES = (1, 32)
# (level, n-independent f1/f2 shape [H, W, C]); levels 3 and 2 are the
# stride-2 subsamples of [48,160,64] and [96,320,64]
CORR_SHAPES = ((6, (6, 20, 192)), (5, (12, 40, 128)), (4, (24, 80, 96)),
               (3, (24, 80, 64)), (2, (48, 160, 64)))
REG_SHAPES = ((2, (96, 320), 7), (3, (48, 160), 5), (4, (24, 80), 5),
              (5, (12, 40), 3), (6, (6, 20), 3))
# (name, [H, W, Cin], Cout, k, prepadded)
LFN_HEADS = tuple((f"main_3 L{lvl}", (h, w, 32), 2, k, False)
                  for lvl, (h, w), k in REG_SHAPES)
DEPTH_HEADS = (("dispconv_0", (194, 642, 16), 1, 3, True),
               ("dispconv_1", (98, 322, 32), 1, 3, True),
               ("dispconv_2", (50, 162, 64), 1, 3, True),
               ("dispconv_3", (26, 82, 128), 1, 3, True))
SEED = 0
INFER_PAIRS = 8
CHUNK_FRAMES = 33
PER_CALL = {"correlation": 5, "reg_dist_filter": 5, "head_conv": 14}
# the variant each kernel's bf16 main-path launches must take
MAIN_VARIANT = {"correlation": "tensor_core", "reg_dist_filter": "async_tile",
                "head_conv": "tensor_core"}
# the normalisation ops that reg_dist_filter fuses, as torch.profiler names them
PROLOGUE_OPS = ("aten::pow", "aten::neg", "aten::amax", "aten::sub", "aten::exp")
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, float32 CUDA-core FLOP/s
PEAK_BYTES, PEAK_BF16_TC, PEAK_F32 = 3.35e12, 989e12, 67e12


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            print(f"[{name}] start", flush=True)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] ok {time.perf_counter() - t0:.1f} s", flush=True)
            return out
        return run
    return wrap


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@phase("device")
def device_phase():
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  {smi}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print("  TF32 off for matmul and cuDNN (float32 comparisons in true float32)")
    return smi


@phase("build")
def build_phase():
    from dfvo_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"  library {cuda_lib.library_path().name}: built in "
          f"{cuda_lib.build_seconds if cuda_lib.build_seconds is not None else 0.0:.1f} s "
          f"(loaded in {time.perf_counter() - t0:.1f} s)")
    log = cuda_lib.BUILD_DIR / "build.log"
    ptxas = {}
    if log.is_file():
        name = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                ptxas[name] = {}
            elif name and "spill stores" in line:
                ptxas[name]["spill"] = line.strip()
            elif name and "Used" in line and "registers" in line:
                ptxas[name]["regs"] = line.split(":", 1)[1].strip()
    for name, info in ptxas.items():
        print(f"  ptxas {short_kernel_name(name)}: {info.get('regs')}; {info.get('spill')}")
    return ptxas


def short_kernel_name(mangled):
    """dfvo::headconv_tc_kernel<7, 2> from its mangled name, roughly."""
    m = re.match(r"_ZN4dfvo\d+(\w+?)I(.*)", mangled)
    if not m:
        return mangled
    targs = m.group(2).split("Ev", 1)[0]
    args = re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)(?=Lb|Li)|Lb([01])E", targs)
    vals = [a or ("bf16" if b else "float" if c else ("true" if d == "1" else "false"))
            for a, b, c, d in args]
    return f"{m.group(1).split('ILi')[0]}<{', '.join(vals)}>"


class Checker:
    """Holds the numpy generator and the worst errors per kernel."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.max_abs_err = {k: 0.0 for k in PER_CALL}  # bf16, main-path variant
        self.max_abs_err_f32 = {k: 0.0 for k in PER_CALL}

    def randn(self, shape, scale=1.0):
        a = self.rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).cuda()

    def rand(self, shape, lo=0.0, hi=1.0):
        a = self.rng.random(shape, dtype=np.float32) * np.float32(hi - lo) + np.float32(lo)
        return torch.from_numpy(a).cuda()

    def compare(self, kernel, label, kernel_fn, plain_fn, inputs, prep=None,
                main_path=True):
        """Kernel vs plain version in float32, then in bfloat16 against the
        plain version in float32 on the same bf16-rounded inputs. ``prep``
        re-lays the kernel's inputs (same values) before the launch. At a
        main-path shape the bf16 launch must take the kernel's main-path
        variant."""
        prep = prep or (lambda t: t)
        counter = launch_counts()[kernel]
        # float32: max abs error <= 1e-4 * max(1, max|ref|)
        got = kernel_fn(*[prep(t) for t in inputs])
        ref = plain_fn(*inputs)
        err = (got - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        torch.cuda.synchronize()
        if not err <= 1e-4 * scale:
            fail(f"{kernel} {label} float32: max abs err {err:.3e} > {1e-4 * scale:.3e}")
        self.max_abs_err_f32[kernel] = max(self.max_abs_err_f32[kernel], err)
        # bfloat16: |got - ref| <= 2e-2 |ref| (output rounding) + the float32
        # bound above (summation order)
        inputs_bf = [t.bfloat16() for t in inputs]
        before = dict(getattr(counter, "variant_launches", {}))
        got = kernel_fn(*[prep(t) for t in inputs_bf])
        after = getattr(counter, "variant_launches", {})
        variant = next((v for v in after if after[v] != before.get(v)), "cuda_core")
        if got.dtype != torch.bfloat16:
            fail(f"{kernel} {label}: bfloat16 input gave {got.dtype}")
        ref = plain_fn(*[t.float() for t in inputs_bf])
        abs_err = (got.float() - ref).abs()
        excess = (abs_err - 2e-2 * ref.abs()).max().item()
        scale = max(1.0, ref.abs().max().item())
        torch.cuda.synchronize()
        if not excess <= 1e-4 * scale:
            fail(f"{kernel} {label} bfloat16 ({variant}): error exceeds 2e-2 |ref| "
                 f"by {excess:.3e}")
        if main_path:
            if variant != MAIN_VARIANT[kernel]:
                fail(f"{kernel} {label} bfloat16 ran {variant}, not {MAIN_VARIANT[kernel]}")
            self.max_abs_err[kernel] = max(self.max_abs_err[kernel], abs_err.max().item())
        print(f"  {kernel:16s} {label:34s} f32 err {err:.2e}  bf16 ok ({variant}, "
              f"max abs err {abs_err.max().item():.2e})", flush=True)


@phase("kernels")
def kernels_phase(chk):
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.headconv import head_conv_cuda, head_conv_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda
    from dfvo_torch.ops.regfilter import reg_dist_filter_cuda, reg_dist_filter_plain

    def check_reg(label, n, h, w, k, raw=None, prep=None, main_path=True):
        # the raw moduleDist logits, as the path gives them
        raw = chk.randn((n, h, w, k * k), 2.0) if raw is None else raw
        flow = chk.randn((n, h, w, 2), 4.0)
        wts = [chk.randn((1, k * k, 1, 1)), chk.randn((1,)),
               chk.randn((1, k * k, 1, 1)), chk.randn((1,))]
        chk.compare("reg_dist_filter", label,
                    lambda d, f, *p: reg_dist_filter_cuda(d, f, *p, k),
                    lambda d, f, *p: reg_dist_filter_plain(d, f, *p, k),
                    (raw, flow, *wts), prep=prep, main_path=main_path)

    for n in LFN_BATCHES:
        for lvl, (h, w, c) in CORR_SHAPES:
            f1, f2 = chk.randn((n, h, w, c)), chk.randn((n, h, w, c))
            if lvl <= 3:
                # as on the path: f1 is the [::2, ::2] view of the full map
                f1 = chk.randn((n, 2 * h, 2 * w, c))[:, ::2, ::2]
            chk.compare("correlation", f"L{lvl} {[n, h, w, c]}",
                        lambda a, b: correlation_cuda(a, b, 3, 1),
                        lambda a, b: correlation_plain(a, b, 3, 1), (f1, f2))
        for lvl, (h, w), k in REG_SHAPES:
            check_reg(f"L{lvl} k{k} {[n, h, w]}", n, h, w, k)
        for name, hwc, cout, k, pre in LFN_HEADS:
            check_head(chk, name, n, hwc, cout, k, pre, head_conv_cuda, head_conv_plain)
    for n in DEPTH_BATCHES:
        for name, hwc, cout, k, pre in DEPTH_HEADS:
            check_head(chk, name, n, hwc, cout, k, pre, head_conv_cuda, head_conv_plain)
    # off the main path (the cuda_core variants in bf16 too): channel counts
    # that do not fill 16-byte vectors and a base address that is not
    # 16-byte aligned take the kernels' scalar loops
    f1, f2 = chk.randn((2, 12, 40, 33)), chk.randn((2, 12, 40, 33))
    chk.compare("correlation", "c=33 [2, 12, 40, 33]",
                lambda a, b: correlation_cuda(a, b, 3, 1),
                lambda a, b: correlation_plain(a, b, 3, 1), (f1, f2), main_path=False)
    f1, f2 = chk.randn((2, 12, 40, 64)), chk.randn((2, 12, 40, 64))
    chk.compare("correlation", "unaligned [2, 12, 40, 64]",
                lambda a, b: correlation_cuda(a, b, 3, 1),
                lambda a, b: correlation_plain(a, b, 3, 1), (f1, f2),
                prep=misaligned, main_path=False)
    check_head(chk, "cin=3", 2, (24, 80, 3), 2, 5, False, head_conv_cuda,
               head_conv_plain, main_path=False)
    check_head(chk, "unaligned", 2, (24, 80, 32), 2, 5, False, head_conv_cuda,
               head_conv_plain, prep=misaligned, main_path=False)
    # the regularization filter off the path: ragged tiles on both edges, a
    # raw and flow one element past an aligned address (unaligned spans and
    # element-wise flow staging), and logits of +-300 where every tap but the
    # minimum underflows
    check_reg("ragged [2, 13, 41] k7", 2, 13, 41, 7, main_path=False)
    check_reg("unaligned [2, 24, 80] k5", 2, 24, 80, 5, prep=misaligned, main_path=False)
    big = torch.sign(chk.randn((2, 12, 40, 49))) * chk.rand((2, 12, 40, 49), 300.0, 305.0)
    check_reg("+-300 [2, 12, 40] k7", 2, 12, 40, 7, raw=big, main_path=False)
    # the cost volume's other window (HD3, off this path) and its stride-2
    # form (tensor_core in bf16)
    f1, f2 = chk.randn((2, 24, 80, 64)), chk.randn((2, 24, 80, 64))
    chk.compare("correlation", "D=4 [2, 24, 80, 64]",
                lambda a, b: correlation_cuda(a, b, 4, 1),
                lambda a, b: correlation_plain(a, b, 4, 1), (f1, f2), main_path=False)
    chk.compare("correlation", "stride 2 [2, 48, 160, 64]",
                lambda a, b: correlation_cuda(a, b, 3, 2),
                lambda a, b: correlation_plain(a, b, 3, 2),
                (chk.randn((2, 48, 160, 64)), chk.randn((2, 48, 160, 64))),
                main_path=False)


def check_head(chk, name, n, hwc, cout, k, pre, kernel_fn, plain_fn, prep=None,
               main_path=True):
    x = chk.randn((n, *hwc))
    # as HeadConv passes it: the OIHW parameter, permuted (not copied)
    kern = chk.randn((cout, hwc[2], k, k), 1.0 / math.sqrt(k * k * hwc[2])).permute(2, 3, 1, 0)
    bias = chk.randn((cout,), 0.1)
    chk.compare("head_conv", f"{name} {[n, *hwc]}",
                lambda a, b, c: kernel_fn(a, b, c, pre),
                lambda a, b, c: plain_fn(a, b, c, pre), (x, kern, bias), prep,
                main_path)


def misaligned(t):
    """The same values, contiguous, starting one element past an aligned
    address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def make_frames(seed, count, h, w):
    """Synthetic uint8 frames: a smooth random texture panning 2 px/frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 4 + 4, (w + 2 * count) // 4 + 4, 3), np.uint8)
    base = np.repeat(np.repeat(base, 4, axis=0), 4, axis=1)
    return np.stack([base[:h, 2 * i : 2 * i + w] for i in range(count)])


def launch_counts():
    from dfvo_torch.ops.headconv import head_conv_cuda
    from dfvo_torch.ops.pallas_corr import correlation_cuda
    from dfvo_torch.ops.regfilter import reg_dist_filter_cuda

    return {"correlation": correlation_cuda, "reg_dist_filter": reg_dist_filter_cuda,
            "head_conv": head_conv_cuda}


def check_finite(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        fail(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.is_floating_point() and not torch.isfinite(t).all():
        fail(f"{name}: non-finite values")


def load_cfg(dtype=None):
    from dfvo_torch.utils import ConfigLoader

    cfg = ConfigLoader().merge_cfg([CFG])
    if dtype is not None:
        cfg.tpu.dtype = dtype
    return cfg


@phase("slice")
def slice_phase(seed):
    from dfvo_torch.matching import KPSelectionSpec, local_bestN
    from dfvo_torch.pipeline.frontend import DeepFrontend

    cfg = load_cfg()  # the YAML as it is: 192x640, bfloat16
    h, w = cfg.image.height, cfg.image.width
    fe = DeepFrontend(cfg, "cuda")
    variables = fe.prepare_variables(fe.init_variables(torch.Generator().manual_seed(seed)))
    kcfg = cfg.kp_selection.local_bestN
    spec = KPSelectionSpec(h, w, kcfg.num_row, kcfg.num_col, kcfg.num_bestN)
    frames = torch.from_numpy(make_frames(seed, CHUNK_FRAMES, h, w)).cuda()
    imgs = frames.float() / 255.0  # as the JAX frame loop scales uint8 frames
    print(f"  {h}x{w} {fe.dtype}, frames {tuple(frames.shape)}")

    counters = launch_counts()
    for fn in counters.values():
        fn.launches = 0
        for v in getattr(fn, "variant_launches", {}):
            fn.variant_launches[v] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, kps = [], []
    for i in range(1, INFER_PAIRS + 1):
        out = fe.infer(variables, imgs[i], imgs[i - 1])
        outs.append(out)
        kps.append(local_bestN(spec, out["flow_fwd"], out["flow_diff"],
                               thre=kcfg.thre, score_method=kcfg.score_method))
    chunk = fe.infer_chunk(variables, imgs)
    chunk_kps = [local_bestN(spec, chunk["flow_fwd"][j], chunk["flow_diff"][j],
                             thre=kcfg.thre, score_method=kcfg.score_method)
                 for j in range(CHUNK_FRAMES - 1)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    variants = {k: dict(fn.variant_launches) for k, fn in counters.items()
                if hasattr(fn, "variant_launches")}

    for out in outs:
        check_finite("depth_cur", out["depth_cur"], (h, w))
        check_finite("flow_fwd", out["flow_fwd"], (h, w, 2))
        check_finite("flow_bwd", out["flow_bwd"], (h, w, 2))
        check_finite("flow_diff", out["flow_diff"], (h, w))
    m = CHUNK_FRAMES - 1
    check_finite("depths", chunk["depths"], (m, h, w))
    check_finite("chunk flow_fwd", chunk["flow_fwd"], (m, h, w, 2))
    check_finite("chunk flow_diff", chunk["flow_diff"], (m, h, w))
    n_kp = spec.n_per_cell * spec.num_row * spec.num_col
    for kp in kps + chunk_kps:
        check_finite("kp1", kp["kp1"], (n_kp, 2))
        check_finite("kp2", kp["kp2"], (n_kp, 2))
        check_finite("valid", kp["valid"], (n_kp,))
    calls = INFER_PAIRS + 1
    expected = {k: v * calls for k, v in PER_CALL.items()}
    print(f"  {INFER_PAIRS} infer + 1 infer_chunk ({CHUNK_FRAMES} frames) + "
          f"{len(kps) + len(chunk_kps)} local_bestN in {wall:.2f} s (first calls included)")
    print(f"  launches {launches}, expected {expected} "
          f"({PER_CALL} per network call)")
    print(f"  depth {outs[0]['depth_cur'].min().item():.3f}..{outs[0]['depth_cur'].max().item():.3f}, "
          f"|flow_fwd| max {outs[0]['flow_fwd'].abs().max().item():.4f}, "
          f"valid kp {int(kps[0]['valid'].sum())}/{n_kp}, good {bool(kps[0]['good_kp_found'])}")
    print(f"  launches by variant {variants}")
    if launches != expected:
        fail(f"launch counts {launches} != {expected}")
    for k, by in variants.items():
        if by[MAIN_VARIANT[k]] != expected[k]:
            fail(f"{k}: {by} launches by variant, expected all {expected[k]} "
                 f"{MAIN_VARIANT[k]}")
    return fe, variables, imgs, launches


def parity_variables(fe, seed):
    """Seeded float32 variables with the flow-delta heads scaled x40, so
    flows span pixels and every warp samples between pixels; random weights
    alone give flows of ~0.02 px."""
    variables = fe.init_variables(torch.Generator().manual_seed(seed + 1))
    for k in variables["flow"]:
        if k.endswith("moduleMain.6.weight") and "Regularization" not in k:
            variables["flow"][k] = variables["flow"][k] * 40.0
    return variables


@phase("parity")
def parity_phase(seed, imgs):
    """float32 slice on the card vs the plain slice on the CPU, and the
    bfloat16 slice with the kernels vs the bfloat16 slice with the plain
    versions on the card; same weights throughout."""
    from dfvo_torch.pipeline.frontend import DeepFrontend

    cfg = load_cfg("float32")
    fe_gpu = DeepFrontend(cfg, "cuda")
    fe_cpu = DeepFrontend(cfg, "cpu")
    variables = parity_variables(fe_gpu, seed)
    v_gpu = fe_gpu.prepare_variables(variables)
    v_cpu = fe_cpu.prepare_variables(variables)
    worst = {}
    for i in (1, 2):
        got = fe_gpu.infer(v_gpu, imgs[i], imgs[i - 1])
        want = fe_cpu.infer(v_cpu, imgs[i].cpu(), imgs[i - 1].cpu())
        torch.cuda.synchronize()
        d_got, d_want = got["depth_cur"].cpu(), want["depth_cur"]
        rel = ((d_got - d_want).abs() / d_want.abs()).max().item()
        worst["depth_cur rel"] = max(worst.get("depth_cur rel", 0.0), rel)
        if not rel <= 1e-3:
            fail(f"pair {i}: depth_cur relative error {rel:.3e} > 1e-3")
        for key in ("flow_fwd", "flow_bwd", "flow_diff"):
            err = (got[key].cpu() - want[key]).abs().max().item()
            worst[key] = max(worst.get(key, 0.0), err)
            if not err <= 1e-2:
                fail(f"pair {i}: {key} max abs error {err:.3e} px > 1e-2")
        print(f"  f32 GPU vs CPU, pair {i}: |flow_fwd| max {want['flow_fwd'].abs().max().item():.2f} px, "
              f"errors {({k: f'{v:.2e}' for k, v in worst.items()})}", flush=True)
    worst_bf16 = bf16_kernels_vs_plain(imgs, variables)
    return {"f32_gpu_vs_cpu": worst, "bf16_kernels_vs_plain": worst_bf16}


# bf16 slice, kernels vs plain versions: both round every activation to
# bf16 (2^-8 relative) and differ only in the kernels' summation order,
# which can flip a rounding; such flips travel through the later layers
BF16_FLOW_ATOL_PX = 3e-2
BF16_DEPTH_RTOL = 3e-2


def bf16_kernels_vs_plain(imgs, variables):
    """The bf16 slice through the CUDA kernels against the same slice with
    the dispatchers' three ``*_cuda`` functions swapped for their plain
    versions (in this script only)."""
    from dfvo_torch.ops import correlation as corr_mod
    from dfvo_torch.ops import headconv as head_mod
    from dfvo_torch.ops import regfilter as reg_mod
    from dfvo_torch.pipeline.frontend import DeepFrontend

    fe = DeepFrontend(load_cfg(), "cuda")  # the YAML's bfloat16
    v = fe.prepare_variables(variables)
    pairs = (1, 2)
    with_kernels = [fe.infer(v, imgs[i], imgs[i - 1]) for i in pairs]
    swaps = ((corr_mod, "correlation_cuda", corr_mod.correlation_plain),
             (head_mod, "head_conv_cuda", head_mod.head_conv_plain),
             (reg_mod, "reg_dist_filter_cuda", reg_mod.reg_dist_filter_plain))
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        with_plain = [fe.infer(v, imgs[i], imgs[i - 1]) for i in pairs]
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    worst = {}
    for i, got, want in zip(pairs, with_kernels, with_plain):
        d_got, d_want = got["depth_cur"].float(), want["depth_cur"].float()
        rel = ((d_got - d_want).abs() / d_want.abs()).max().item()
        worst["depth_cur rel"] = max(worst.get("depth_cur rel", 0.0), rel)
        if not rel <= BF16_DEPTH_RTOL:
            fail(f"bf16 pair {i}: depth_cur relative error {rel:.3e} > {BF16_DEPTH_RTOL}")
        for key in ("flow_fwd", "flow_bwd", "flow_diff"):
            err = (got[key].float() - want[key].float()).abs().max().item()
            worst[key] = max(worst.get(key, 0.0), err)
            if not err <= BF16_FLOW_ATOL_PX:
                fail(f"bf16 pair {i}: {key} max abs error {err:.3e} px > {BF16_FLOW_ATOL_PX}")
        print(f"  bf16 kernels vs plain, pair {i}: |flow_fwd| max "
              f"{want['flow_fwd'].float().abs().max().item():.2f} px, "
              f"errors {({k: f'{v:.2e}' for k, v in worst.items()})}", flush=True)
    return worst


def time_cuda(fn, reps, rounds=5):
    """Median over ``rounds`` of CUDA-event ms per call over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def device_ms(fn, reps=20):
    """Device time per call: the device time of every kernel that ``reps``
    calls launch (torch.profiler), summed, over ``reps``. Unlike a CUDA-event
    interval it leaves out the gaps while the host launches the next call,
    which set the pace of small shapes on a slow host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    # three traces without device activity: time with CUDA events instead
    # (host gaps included, so an upper bound)
    print("  (torch.profiler recorded no device time; CUDA-event time instead)")
    return time_cuda(fn, reps)


def bound(nbytes, flops, peak_flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    each input byte read once and each output byte written once against
    the HBM rate, the operations against the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_cases(chk):
    """Every kernel at every main-path shape of one `infer_chunk` network
    call (N = 64 LiteFlowNet, N = 32 depth), with its launches in that call,
    and level 2 at N = 2 (`infer`, not in the per-call sums). Inputs in
    bf16, laid out as the path gives them."""
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.headconv import head_conv_cuda, head_conv_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda
    from dfvo_torch.ops.regfilter import reg_dist_filter_cuda, reg_dist_filter_plain

    bf = torch.bfloat16
    cases = []
    for n, per_call, levels in ((64, 1, (6, 5, 4, 3, 2)), (2, 0, (2,))):
        for lvl, (h, w, c) in CORR_SHAPES:
            if lvl not in levels:
                continue
            f1 = chk.randn((n, 2 * h, 2 * w, c) if lvl <= 3 else (n, h, w, c)).to(bf)
            f1 = f1[:, ::2, ::2] if lvl <= 3 else f1
            f2 = chk.randn((n, h, w, c)).to(bf)
            kk = 49
            cases.append(dict(
                kernel="correlation", shape=f"L{lvl} [{n}, {h}, {w}, {c}]", n=n,
                per_call=per_call,
                kfn=lambda f1=f1, f2=f2: correlation_cuda(f1, f2, 3, 1),
                pfn=lambda f1=f1, f2=f2: correlation_plain(f1, f2, 3, 1), lfn=None,
                bound=bound(2 * (2 * n * h * w * c + n * h * w * kk),
                            2 * n * h * w * kk * c, PEAK_BF16_TC)))
        for lvl, (h, w), k in REG_SHAPES:
            if lvl not in levels:
                continue
            kk = k * k
            raw = chk.randn((n, h, w, kk), 2.0).to(bf)
            flow = chk.randn((n, h, w, 2), 4.0).to(bf)
            p = [chk.randn((1, kk, 1, 1)).to(bf), chk.randn((1,)).to(bf),
                 chk.randn((1, kk, 1, 1)).to(bf), chk.randn((1,)).to(bf)]
            cases.append(dict(
                kernel="reg_dist_filter", shape=f"L{lvl} k{k} [{n}, {h}, {w}]", n=n,
                per_call=per_call,
                kfn=lambda d=raw, f=flow, p=p, k=k: reg_dist_filter_cuda(d, f, *p, k),
                pfn=lambda d=raw, f=flow, p=p, k=k: reg_dist_filter_plain(d, f, *p, k),
                lfn=None,
                # f32 CUDA-core work: the normalisation (|raw| min, raw², the
                # difference and the exp per tap, the minimum's square), then
                # k² adds for the divisor, 3 ops per tap and component, the
                # bias adds and the division
                bound=bound(2 * (n * h * w * (kk + 4) + 2 * kk + 2),
                            n * h * w * (11 * kk + 6), PEAK_F32)))
        heads = [(name, hwc, cout, k, pre, 2 * per_call) for name, hwc, cout, k, pre in LFN_HEADS
                 if int(name.split("L")[1]) in levels]
        if n == 64:
            heads += [(name, hwc, cout, k, pre, 1) for name, hwc, cout, k, pre in DEPTH_HEADS]
        for name, (h, w, cin), cout, k, pre, calls in heads:
            nn_ = 32 if name.startswith("dispconv") else n
            x = chk.randn((nn_, h, w, cin)).to(bf)
            w_oihw = chk.randn((cout, cin, k, k), 1.0 / math.sqrt(k * k * cin)).to(bf)
            kern = w_oihw.permute(2, 3, 1, 0)
            bias = chk.randn((cout,), 0.1).to(bf)
            pad = 0 if pre else (k - 1) // 2
            oh, ow = h - 2 * ((k - 1) // 2 - pad), w - 2 * ((k - 1) // 2 - pad)
            cases.append(dict(
                kernel="head_conv", shape=f"{name} [{nn_}, {h}, {w}, {cin}]", n=nn_,
                per_call=calls,
                kfn=lambda x=x, kern=kern, b=bias, pre=pre: head_conv_cuda(x, kern, b, pre),
                pfn=lambda x=x, kern=kern, b=bias, pre=pre: head_conv_plain(x, kern, b, pre),
                lfn=lambda x=x, w=w_oihw, b=bias, pad=pad: torch.nn.functional.conv2d(
                    x.permute(0, 3, 1, 2), w, b, padding=pad),
                bound=bound(2 * (nn_ * h * w * cin + nn_ * oh * ow * cout
                                 + k * k * cin * cout + cout),
                            2 * nn_ * oh * ow * k * k * cin * cout, PEAK_BF16_TC)))
    return cases


@phase("times")
def times_phase(chk, fe, variables, imgs):
    infer_ms = time_cuda(lambda: fe.infer(variables, imgs[1], imgs[0]), reps=5)
    chunk_ms = time_cuda(lambda: fe.infer_chunk(variables, imgs), reps=1, rounds=3)
    per_frame_chunk = chunk_ms / (CHUNK_FRAMES - 1)
    print(f"  infer: {infer_ms:.3f} ms/frame (one pair, bfloat16)")
    print(f"  infer_chunk: {chunk_ms:.3f} ms per {CHUNK_FRAMES}-frame chunk = "
          f"{per_frame_chunk:.3f} ms/frame")

    rows = []
    print("  device ms per call (torch.profiler); event: CUDA-event ms per call "
          "back to back, host gaps included")
    print("  kernel           shape                            ms      event_ms  plain_ms  "
          "library_ms  bound_ms (by)           share  launches/call")
    for case in timing_cases(chk):
        # CUDA events in turns: plain, library, kernel, kernel, library, plain
        p1 = time_cuda(case["pfn"], reps=5, rounds=3)
        l1 = time_cuda(case["lfn"], reps=20) if case["lfn"] else None
        k1 = time_cuda(case["kfn"], reps=20)
        k2 = time_cuda(case["kfn"], reps=20)
        l2 = time_cuda(case["lfn"], reps=20) if case["lfn"] else None
        p2 = time_cuda(case["pfn"], reps=5, rounds=3)
        bound_ms, bound_by = case["bound"]
        row = {"kernel": case["kernel"], "shape": case["shape"], "n": case["n"],
               "launches_per_call": case["per_call"],
               "ms": device_ms(case["kfn"]), "plain_ms": device_ms(case["pfn"], reps=3),
               "library_ms": device_ms(case["lfn"]) if case["lfn"] else None,
               "event_ms": statistics.median([k1, k2]),
               "event_plain_ms": statistics.median([p1, p2]),
               "event_library_ms": None if l1 is None else statistics.median([l1, l2]),
               "bound_ms": bound_ms, "bound_by": bound_by}
        row["share_of_bound"] = bound_ms / row["ms"]
        rows.append(row)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"  {row['kernel']:16s} {row['shape']:32s} {row['ms']:.4f}  {row['event_ms']:.4f}  "
              f"{row['plain_ms']:8.4f}  {lib:>10s}  {bound_ms:.4f} ({bound_by:10s})  "
              f"{100 * row['share_of_bound']:5.1f} %  {row['launches_per_call']}", flush=True)
    sums = {}
    for name in PER_CALL:
        mine = [r for r in rows if r["kernel"] == name and r["launches_per_call"]]
        tot = lambda key: sum(r["launches_per_call"] * r[key] for r in mine)
        by_bytes = sum(r["launches_per_call"] * r["bound_ms"] for r in mine
                       if r["bound_by"] == "bytes")
        sums[name] = {
            "ms": tot("ms"), "event_ms": tot("event_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if by_bytes >= tot("bound_ms") / 2 else "operations",
            "library_ms": (tot("library_ms") if all(r["library_ms"] is not None for r in mine)
                           else None),
            "launches_per_call": sum(r["launches_per_call"] for r in mine)}
        s = sums[name]
        lib = "none: no single PyTorch call computes this" if s["library_ms"] is None \
            else f"{s['library_ms']:.4f} ms"
        print(f"  per infer_chunk network call, {name}: {s['launches_per_call']} launches, "
              f"kernel {s['ms']:.4f} ms, bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
              f"share {100 * s['bound_ms'] / s['ms']:.1f} %, plain {s['plain_ms']:.4f} ms, "
              f"library {lib}")
    return infer_ms, per_frame_chunk, rows, sums


@phase("profile")
def profile_phase(fe, variables, imgs, out_dir):
    """Device time by kernel name for one `infer` and one `infer_chunk` call
    (torch.profiler), and the device-busy share of the call's wall time. The
    profiler's own host cost lengthens the wall time, so the share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    result = {}
    calls = (("infer", lambda: fe.infer(variables, imgs[1], imgs[0])),
             ("infer_chunk", lambda: fe.infer_chunk(variables, imgs)))
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(
            ((e.key, e.count, e.self_device_time_total / 1e3)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
            key=lambda r: -r[2],
        )
        busy_ms = sum(r[2] for r in rows)
        launches = sum(r[1] for r in rows)
        # the fused normalisation: no prologue op on a [N,H,W,k²] tensor
        prologue = [(e.name, e.input_shapes[0]) for e in prof.events()
                    if e.name in PROLOGUE_OPS and e.input_shapes
                    and len(e.input_shapes[0]) == 4 and e.input_shapes[0][-1] in (9, 25, 49)]
        print(f"  {name}: {len(prologue)} pow/neg/amax/sub/exp ops on [N,H,W,k²] tensors")
        if prologue:
            fail(f"{name}: normalisation ops outside the kernel: {prologue[:5]}")
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(f"{name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
                    f"{launches} kernels\n")
            for key, count, ms in rows:
                f.write(f"{ms:10.4f} ms {count:6d}x  {key}\n")
        print(f"  {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
              f"({100 * busy_ms / wall_ms:.1f} %), {launches} kernels")
        for key, count, ms in rows[:8]:
            print(f"    {ms:8.3f} ms {count:5d}x  {key[:90]}")
        result[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "kernels": launches,
                        "top": [[k, c, ms] for k, c, ms in rows[:20]]}
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke", "chip_smoke.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "one NVIDIA GPU", file=sys.stderr)
        return 1
    import dfvo_torch  # noqa: F401  (fails here outside a checkout)

    t_start = time.perf_counter()

    smi = device_phase()
    ptxas = build_phase()
    chk = Checker(SEED)
    kernels_phase(chk)
    fe, variables, imgs, launches = slice_phase(SEED)
    parity = parity_phase(SEED, imgs)
    infer_ms, chunk_ms, rows, sums = times_phase(chk, fe, variables, imgs)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    profile = profile_phase(fe, variables, imgs, out_dir)

    sources = {
        "correlation": ("dfvo_torch/csrc/correlation.cu", "dfvo_tpu/ops/pallas_corr.py:30"),
        "reg_dist_filter": ("dfvo_torch/csrc/regfilter.cu", "dfvo_tpu/ops/regfilter.py:64"),
        "head_conv": ("dfvo_torch/csrc/headconv.cu", "dfvo_tpu/ops/headconv.py:65"),
    }
    # times, bounds and library times are sums over one infer_chunk network
    # call (N = 64 LiteFlowNet, N = 32 depth), weighted by the launches at
    # each shape; per-shape rows are in the report
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "variant": MAIN_VARIANT[name], "launches": launches[name],
         "launches_per_call": sums[name]["launches_per_call"],
         "max_abs_err": chk.max_abs_err[name],
         "ms": sums[name]["ms"], "plain_ms": sums[name]["plain_ms"],
         "bound_ms": sums[name]["bound_ms"], "bound_by": sums[name]["bound_by"],
         "library_ms": sums[name]["library_ms"]}
        for name, (src, rep) in sources.items()
    ]
    report = {
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "infer_ms_per_frame": infer_ms, "infer_chunk_ms_per_frame": chunk_ms,
        "kernel_rows": rows, "per_call": sums, "ptxas": ptxas,
        "max_abs_err_f32": chk.max_abs_err_f32,
        "parity": parity, "kernels": kernels, "profile": profile,
        "seconds": time.perf_counter() - t_start,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"total {report['seconds']:.1f} s; report in {os.path.relpath(args.out, ROOT)}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
