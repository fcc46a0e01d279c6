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
   every shape the main path gives it, in float32 (the cost volume's and
   the head conv's reg_tile variants) and bfloat16 (the
   tensor_core variants of the head conv and the cost volume, the fused
   normalisation and filter from the raw confidence logits), and the
   off-path cases (the cost volume's reg_tile at C = 33, C = 24 in bf16,
   C = 1536, a 1x1 map and an unaligned base, each launch of it equal bit
   for bit to a second; the head conv's reg_tile in bf16 at Cin = 3, an
   unaligned base, Cout 3 and 4, k = 1).
4. slice: DeepFrontend from options/examples/default_configuration.yml
   (192x640, bfloat16, seeded random weights) runs `infer` on 8 consecutive
   pairs of synthetic frames, `infer_chunk` on a 33-frame chunk and
   `local_bestN` on every pair; launch counters must show each kernel on
   that path (5 correlations and 14 head convs per network call, all
   tensor_core, and 5 regularization filters, async_tile).
5. parity: the float32 slice on the card against the plain slice on the
   CPU, and the bfloat16 slice with the kernels against the same slice with
   the three CUDA wrappers swapped for their plain versions.
6. times: CUDA-event medians of `infer` and `infer_chunk` per frame, and
   device ms (torch.profiler, each trace's device events counted) of
   every kernel at every main-path shape (N = 64 LiteFlowNet, N = 32 depth,
   and level 2 at N = 2) beside its plain version, its bound and, for the
   head conv, one cuDNN `F.conv2d` call (the yardstick; the port never
   calls it).
7. profile: device time by kernel name of one `infer` and one
   `infer_chunk` call (torch.profiler), written next to the report as
   profile_infer.txt and profile_infer_chunk.txt; no pow, neg, amax, sub or
   exp may run on a [N,H,W,k²] confidence tensor (the kernel normalises it).
8. track: `tracking_step` at 192x640 on the scenes of tests/test_pipeline.py
   (E success, planar -> PnP, constant motion) and the scale spike of
   tests/test_tracking_options.py, built with the port's geometry on
   smooth oracle depth fields, held to the JAX tests' pose bounds and to
   the same step on the CPU; the RANSAC hash draws on the card equal to
   the CPU's bit for bit. TF32 is on around the step (highp turns it off).
9. frame: `TrackingConfig.from_cfg` of the YAML, `depth_only` on frame 0
   and 8 chained `frame_step`s (bf16, the kernels), poses chained with
   `update_global_pose`; the launch counters must show 5 / 5 / 14 per
   network call.
10. tracking: CUDA-event medians of `tracking_step` (E and planar scenes)
   and of `frame_step`, host syncs per `tracking_step` (one: the PnP
   decision), and torch.profiler kernels, busy share and top device ops of
   each (profile_tracking_step_*.txt, profile_frame_step.txt).
11. run: the port's CLI, ``python -m dfvo_torch.apis.run``'s ``main``, in
   this process on the card over a synthetic KITTI-odometry sequence of
   RUN_FRAMES 1241x376 JPEG frames (a smooth texture panning 2 px per
   frame, calib.txt and GT poses, under build/chip_smoke/run/) with the
   default YAML and a custom YAML that sets only the sequence and the
   directories: 192x640, bf16, visualization on. It checks the trajectory
   file (RUN_FRAMES finite poses), the annotated configuration.yml, the
   port's KittiEvalOdom.eval_seq against the GT (finite ATE and RPE), the
   launches (5 / 5 / 14 per tracked frame and 4 head convs on the first,
   all on their Hopper variants) and the host reads of every frame (CUDA
   sync debug mode). Then the same loop in float32 on PARITY_FRAMES frames
   on the card and on the CPU, drawer off: equal modes, valid keypoints
   and inliers, each frame's relative pose within 0.01 deg and F32_T_REL
   of its translation, two host reads per tracked frame.
12. scan: the CLI again with `tpu.execution: scan` (chunks of 32, bf16,
   drawer on) over SCAN_FRAMES frames, a full chunk and a padded
   second: SCAN_FRAMES finite poses starting at the GT's first pose,
   eval_seq, the map, 5 / 5 / 14 launches per chunk (all Hopper
   variants) and 4 on the first frame, and SCAN_HOST_READS host reads per
   chunk by source line (none on the first frame). Then one chunk_step on
   bench.py's coherent oracle drive: every frame by E, within 0.1 deg and
   5 % of |t| of the GT; CUDA-event medians, kernels, busy share, host
   syncs (one) and peak memory of that chunk and of the same chunk without
   the oracle (PnP on every frame); and the float32 oracle chunk of
   SCAN_PARITY_PAIRS pairs on the card against the CPU (equal modes,
   rotation within 0.01 deg, translation within SCAN_T_REL of |t|).
13. finetune: online finetuning. Each kernel's autograd Function at every
   shape of one update (192x640 float32: the cost volume at levels 6 -> 2
   and the filter at its five levels on the [2, ...] pair batch, the ten
   flow heads and the four disparity heads) against autograd of the plain
   version on the same inputs and cotangent, launching the float32
   variants (reg_tile for the cost volume and the head conv; async_tile for
   the filter) and, in the backward, each one's backward kernel once (the
   cost volume's output, the filter's gradients and the head conv's weight
   and bias gradients equal bit for bit over two launches, the head conv's
   in float32 and bf16); the filter's also at level 2 with ties
   at the minimal |raw| and with cotangents that are a permuted view and an
   expanded (stride-0) one; the backward kernels also in bf16 at those
   shapes against their plain versions; each one's forward and backward
   device ms beside their bounds, the plain VJP's and, for the head conv,
   cuDNN's conv2d and convolution_backward. Then the CLI with
   ablation_self_flow_online.yml's options plus depth finetuning and
   save_model, in frame execution over FT_FRAMES frames and in scan
   execution over FT_SCAN_FRAMES frames: one update per tracked frame, the
   weights moved and the running statistics fixed, finite losses,
   finetuned_model/ written, launches (inference + 5 / 5 / 14 float32
   launches, as many Function backward passes and 5 / 5 / 14
   backward-kernel launches per update) and host
   reads (3 per frame; 2 per chunk and 1 for the saved model) under CUDA
   sync debug mode. Then one update at 192x640 on the card (TF32 off, and
   cuDNN's TF32 convolutions, PyTorch's default) against the CPU, beside
   the CPU's own change under a 1e-6 change of the image; and the update's
   CUDA-event ms split into forward, backward and Adam, the chunk update
   per pair, kernels, busy share, host syncs (none) and peak memory.
14. extend: the extended paper's kitti_stereo_train_extend.yml merged on
   the default, at its 370x1226 (LiteFlowNet and the depth network fed at
   384x1248). Each kernel against its plain version at every shape it gets
   there (N = 2 and 64; the disparity heads at N = 1 and 32) and their
   times per infer_chunk call beside the bounds, and LiteFlowNet's per
   pair at N = 2 (the flow export's feed); the flow finetuning's Functions
   at N = 2 with the backward kernels (float32, and the backward kernels
   in bf16) against autograd of the plain version, and the filter's and
   the head conv's forward and backward times per update; the CLI with flow
   finetuning (scales 1-5), rigid-flow keypoints and iterative scale in
   frame execution over EXT_FRAMES frames and in scan execution over
   EXT_SCAN_FRAMES frames (one full chunk of 32 and a padded one): finite
   poses, one update per tracked frame, launches (inference + 5 / 5 / 10
   float32 launches and 5 / 5 / 10 backward-kernel launches per update) and
   host reads (3 per frame with the
   drawer; 2 per chunk) under CUDA sync debug mode, the timer scopes and
   peak memory. Then the iterative step (iterative scale, the E and PnP
   trackers' iterative keypoints) on the track scenes at 370x1226 on the
   card against the CPU, with one host sync; CUDA-event ms, kernels, busy
   share and peak memory of that step, of frame_step and of one update;
   bench.py's oracle drive through one iterative chunk_step (every frame
   by E, held to the GT; one host sync; timed and profiled), through the
   same chunk with the bestN and sampled selectors, and its first
   SCAN_PARITY_PAIRS pairs' tracking on the card against the CPU; and the
   pose CNN through EXT_POSE_FRAMES frames of frame execution, once with
   tracking_method: deep_pose (mode 3, one host read per frame) and once
   with depth consistency under hybrid tracking (a depth-consistency map
   per frame, two reads).
15. hd3: default_configuration.yml with deep_flow.network: hd3 (192x640,
   bf16, seeded weights). The D = 4 cost volume at HD3's five level shapes
   (3x10x512 .. 48x160x64) at N = 2 and 64 against its plain version
   (tensor_core up to 256 channels, reg_tile at 512) and its times per
   network call at N = 64 and N = 2 in bf16 and at N = 2 in float32 (an
   update) beside the bound; its Function at a flow update's N = 2 in
   float32 with the backward kernel at D = 4 (and that kernel in bf16)
   against autograd of the plain version, with the forward and backward
   times; HD3 infer in float32 on the card against the CPU on one pair;
   the CLI in frame execution over HD3_FRAMES frames
   (drawer on) and in scan execution over HD3_SCAN_FRAMES frames, then both
   with flow finetuning at scales 1-5 (HD3_FT_PAIRS updates): finite poses,
   launches (5 cost volumes at D = 4 and 4 disparity heads per network
   call, 5 float32 cost volumes, their backward passes and 5 backward
   kernels at D = 4 per update),
   host reads (3 per frame, 2 per chunk) and the timer scopes; bench.py's
   oracle drive through one HD3 chunk_step (every frame by E, held to the
   GT); CUDA-event ms, kernels, busy share, host syncs and peak memory of
   infer, infer_chunk, frame_step, chunk_step and one update; one update
   (float32, scales 1-5) on the card against the CPU.

16. multiseq: the multi-sequence CLI, ``python -m dfvo_torch.apis.run_multiseq``'s
   ``main``, over 11 synthetic KITTI-layout sequences named 00-10 (each with
   its KITTI sequence's left camera) at the default YAML's 192x640 bf16: in
   frame execution over MS_FRAMES frames (batched steps over the 11
   sequences: the cost volume, the filter and the flow heads at N = 22, the
   disparity heads at N = 11) and in scan execution over MS_SCAN_FRAMES
   frames (a full chunk of 32 and a padded one, each sequence's chunk
   step): finite trajectories, eval_seq, launches by batch size and
   variant, host reads per step by source line (2 per frame step; 12 per
   chunk), the timers; the batched step in float32 over 4 sequences on the
   card against the CPU; one sequence-averaged update over 4 pairs in
   float32 (TF32 off) against the CPU's loss and gradient, and
   make_train_step's launches at N = 8 (the backward kernels' too); each
   Function at N = 8 with the forward and backward times per update;
   CUDA-event ms, per sequence-frame,
   kernels, busy share, host syncs and peak memory of the batched VO step
   and the chunk step over the 11 sequences, beside the single-sequence
   frame_step. The run phase also saves a float32 run after frame 5,
   loads it into a fresh DFVO and continues it, against the straight run.
17. datasets: the shipped tum_rgbd_slam.yml (480x640, frame_step 5),
   adelaide_driving.yml (256x832) and oxford_robotcar.yml (256x640) at
   their own sizes, bf16, seeded weights, the drawer on. Each kernel
   against its plain version at every shape of each feed, at N = 2 / 1
   (LiteFlowNet / depth) and for TUM also N = 64 / 32, with the variant
   each launch took, and their times per network call beside the bounds;
   the CLI over synthetic sequences in each dataset's layout
   (dfvo_torch.synth.layouts): TUM in frame execution over 31 frames (6
   tracked) and in scan execution over 161 frames (one chunk of 32),
   Adelaide and RobotCar over 8 frames: finite poses, the TUM file's 8
   columns stamped with the tracked frames' own synchronised timestamps,
   launches and variants (5 / 5 / 14 per network call, 4 on the first
   frame), host reads per frame or chunk; TUM's float32 `infer` on the
   card against the CPU; and the flow export
   (``python -m dfvo_torch.tools.generate_flow_prediction``) over two
   375x1242 pairs through a --model checkpoint, its PNGs read back
   against the port's own flows.

Weights and inputs are drawn from SEED.

It ends with a JSON line of the CLI run (timer means per scope,
frames/s, host reads per frame, the frame loader), a JSON line of the
tracking numbers, a JSON line of the scan execution, a JSON line of
finetuning, a JSON line of the extend phase, a JSON line of the hd3 phase,
a JSON line of the multiseq phase, a JSON line of the datasets phase, a JSON line of the kernels (HD3's D = 4 cost volume as an entry of its
own, correlation_d4, the head conv's float32 forward of the finetuning
update as head_conv_f32, and the backward kernels as correlation_backward,
reg_dist_filter_backward and head_conv_backward, timed per finetuning
update; launches from the slice phase, from the CLI run as launches_cli, from the
scan execution as launches_scan, from the finetuning updates of both CLI
runs as launches_finetune and from the extend phase's two CLI runs as
launches_extend, from the multiseq phase's two CLI runs and its update by
batch size as launches_multiseq and launches_multiseq_update, from the
datasets phase's CLI runs and flow export as launches_datasets and
launches_flow_export; their times at 370x1226 as at_370x1226 and at the
datasets phase's feeds as at_tum_480x640, at_adelaide_256x832 and
at_robotcar_256x640),
the nvidia-smi line, and the result line {"ok": true, "device": {...}}.
It exits non-zero, printing no result, when no CUDA device is available
or any phase fails.
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

# main-path shapes (N = 2 in infer, 2(M-1) = 64 in infer_chunk)
LFN_BATCHES = (2, 64)
DEPTH_BATCHES = (1, 32)


def main_path_shapes(flow_hw, depth_hw):
    """The kernels' shapes on the networks' path for LiteFlowNet's feed
    size and the depth network's: (CORR_SHAPES, REG_SHAPES, LFN_HEADS,
    DEPTH_HEADS). Level l of LiteFlowNet is at 1/2^(l-1) of its feed.
    CORR: (level, n-independent f1/f2 shape [H, W, C]); levels 3 and 2 are
    the stride-2 subsamples of the level 3 and level 2 maps. REG: (level,
    [H, W], k). Heads: (name, [H, W, Cin], Cout, k, prepadded); the
    disparity heads see the reflect-padded map."""
    lv = {lvl: (flow_hw[0] >> (lvl - 1), flow_hw[1] >> (lvl - 1)) for lvl in range(2, 7)}
    corr = ((6, (*lv[6], 192)), (5, (*lv[5], 128)), (4, (*lv[4], 96)), (3, (*lv[4], 64)),
            (2, (*lv[3], 64)))
    reg = tuple((lvl, lv[lvl], k) for lvl, k in ((2, 7), (3, 5), (4, 5), (5, 3), (6, 3)))
    lfn_heads = tuple((f"main_3 L{lvl}", (h, w, 32), 2, k, False) for lvl, (h, w), k in reg)
    depth_heads = tuple((f"dispconv_{s}", ((depth_hw[0] >> s) + 2, (depth_hw[1] >> s) + 2, c),
                         1, 3, True) for s, c in enumerate((16, 32, 64, 128)))
    return corr, reg, lfn_heads, depth_heads


# at 192x640 (the default configuration): CORR_SHAPES L6 [6, 20, 192] ..
# L2 [48, 160, 64], REG_SHAPES L2 [96, 320] k7 .. L6 [6, 20] k3, the
# disparity heads from [194, 642, 16]
CORR_SHAPES, REG_SHAPES, LFN_HEADS, DEPTH_HEADS = main_path_shapes((192, 640), (192, 640))
SEED = 0
INFER_PAIRS = 8
CHUNK_FRAMES = 33
PER_CALL = {"correlation": 5, "reg_dist_filter": 5, "head_conv": 14}
# the depth network alone (depth_only): its four disparity heads
DEPTH_ONLY_CALL = {"correlation": 0, "reg_dist_filter": 0, "head_conv": 4}
FRAME_STEPS = 8
RUN_FRAMES = 12
PARITY_FRAMES = 4
# the float32 loop's card-vs-CPU translation limit per frame, relative to
# the estimate (run phase)
F32_T_REL = 2e-2
# the resume check (run phase): a float32 run saved after frame RESUME_AT
# and continued in a fresh DFVO against the straight run of RESUME_FRAMES
RESUME_FRAMES, RESUME_AT, RESUME_TOL = 8, 5, 1e-5
RUN_SEQ = "09"
# KITTI odometry sequence 00's left camera (calib.txt P2), 1241x376 frames
RUN_CALIB = "718.856 0.0 607.1928 45.38225 0.0 718.856 185.2157 -0.1130887 0.0 0.0 1.0 0.003779761"
RUN_SIZE = (376, 1241)
# host reads per tracked frame: the PnP decision and the pose, plus one
# batched download for the drawer
RUN_HOST_READS = {False: 2, True: 3}
# the scan execution's sequence: a full chunk of 32 and a padded second
SCAN_FRAMES = 1 + 32 + 9
# host reads per chunk of the scan execution: the chunk's decision tensors
# and its poses
SCAN_HOST_READS = 2
# the float32 oracle chunk on the card and on the CPU (scan phase)
SCAN_PARITY_PAIRS = 8
SCAN_T_REL = 1e-3
# online finetuning (finetune phase): options/examples/ablation_self_flow_online.yml
# merged on the default, plus depth finetuning at the default's scales
ABLATION_CFG = os.path.join(ROOT, "options", "examples", "ablation_self_flow_online.yml")
# launches per update: LiteFlowNet in "two" mode on the [2, ...] forward and
# backward pair (5 levels, 10 flow-delta heads) and Monodepth2's 4 disparity
# heads, all float32 (reg_tile for the cost volume and the head conv;
# async_tile for the filter); as many backward passes of each Function
FT_PER_UPDATE = {"correlation": 5, "reg_dist_filter": 5, "head_conv": 14}
FT_VARIANT = {"correlation": "reg_tile", "reg_dist_filter": "async_tile",
              "head_conv": "reg_tile"}
FT_LR = 1e-5
FT_CHUNK_PAIRS = 8
# the finetuning CLI runs: 7 updates in frame execution; a full chunk of 32
# and a padded one of 1 in scan execution
FT_FRAMES = 8
FT_SCAN_FRAMES = 1 + 32 + 1
# one update on the card against the CPU in float32: the loss, each
# network's gradient by relative norm, and the share of the moving weights
# whose Adam step (about lr·sign(g)) has the CPU's sign. With TF32 off the
# two differ in summation order only. The depth gradient turns on
# discontinuities (the per-pixel minimum of the auto-masking, the border
# sampler's cells) that rounding moves, so it gets a wider limit; the CPU's
# own change under a 1e-6 relative change of the image is printed beside
# (measured first at 192x640: 1.2e-2 card vs CPU). cuDNN's TF32
# convolutions (10-bit mantissas, PyTorch's default, as the CLIs ran) move
# the forward by about 1e-3 per convolution: measured first 1.0e-3 (flow)
# and 0.165 (depth) by norm, 99.87 % and 93.5 % of the steps' signs
FT_F32_LIMITS = {"loss_rel": 1e-4, "flow_grad_rel": 1e-3, "depth_grad_rel": 5e-2,
                 "flow_same_sign": 0.99, "depth_same_sign": 0.99}
FT_TF32_LIMITS = {"loss_rel": 1e-2, "flow_grad_rel": 5e-2, "depth_grad_rel": 0.5,
                  "flow_same_sign": 0.95, "depth_same_sign": 0.8}
# the extended paper's configuration (extend phase): kitti_stereo_train_extend.yml
# merged on the default, at its 370x1226
EXTEND_CFG = os.path.join(ROOT, "options", "examples", "kitti_stereo_train_extend.yml")
EXT_SIZE = (370, 1226)
# frame execution: 5 tracked frames and updates; scan execution: one full
# chunk of 32 and a padded second one
EXT_FRAMES = 6
EXT_SCAN_FRAMES = 1 + 32 + 5
# the pose CNN's frame runs (deep_pose tracking; depth consistency)
EXT_POSE_FRAMES = 4
# the extend configuration finetunes the flow only: LiteFlowNet's 5 levels
# and 10 flow-delta heads per update
EXT_FT_PER_UPDATE = {"correlation": 5, "reg_dist_filter": 5, "head_conv": 10}
# host reads of the pose CNN's frame runs (drawer off): deep_pose tracking
# reads the pose only; hybrid tracking the PnP decision and the pose
EXT_POSE_READS = {"deep_pose": 1, "hybrid": 2}
# the iterative option set held on the card against the CPU (extend phase)
EXT_ITERATIVE = dict(scale_method="iterative", e_iterative_kp=True, scale_iterative_kp=True,
                     pnp_iterative_kp=True)
# the multiseq phase: KITTI odometry 00-10, the sequences that KITTI scores,
# each with its own left camera (fx, cx, cy of its calib.txt P2)
MS_SEQS = tuple(f"{i:02d}" for i in range(11))
MS_CAMS = {**{f"{i:02d}": (718.856, 607.1928, 185.2157) for i in range(3)},
           "03": (721.5377, 609.5593, 172.854),
           **{f"{i:02d}": (707.0912, 601.8873, 183.1104) for i in range(4, 11)}}
# frame execution: 3 batched steps; scan execution: one full chunk of 32
# and a padded one
MS_FRAMES = 4
MS_SCAN_FRAMES = 1 + 32 + 5
# the batched step and the update on the card against the CPU (float32)
MS_PARITY_S = 4
MS_DEPTH_REL = 1e-4
# the tracking scenes' intrinsics (tests/test_pipeline.py)
TRACK_K = np.array([[370.0, 0, 320.0], [0, 371.0, 96.0], [0, 0, 1.0]], np.float32)
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
    """Holds the generator of the inputs and the worst errors per kernel.
    The inputs are drawn on the card: numpy took over a minute for the
    gigabytes of the shapes at 370x1226."""

    def __init__(self, seed):
        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        # bf16, main-path variant; HD3's D = 4 cost volume on its own
        self.max_abs_err = {k: 0.0 for k in (*PER_CALL, "correlation_d4")}
        self.max_abs_err_f32 = {k: 0.0 for k in (*PER_CALL, "correlation_d4")}
        # (kernel, label) -> (float32 max abs err, bf16 max abs err), and
        # the variant its bf16 launch took
        self.errs, self.variants = {}, {}

    def randn(self, shape, scale=1.0):
        return torch.randn(shape, generator=self.gen, device="cuda") * scale

    def rand(self, shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=self.gen, device="cuda") * (hi - lo) + lo

    def compare(self, kernel, label, kernel_fn, plain_fn, inputs, prep=None,
                main_path=True, expect=None, record=None):
        """Kernel vs plain version in float32, then in bfloat16 against the
        plain version in float32 on the same bf16-rounded inputs. ``prep``
        re-lays the kernel's inputs (same values) before the launch. At a
        main-path shape the bf16 launch must take the kernel's main-path
        variant, or ``expect`` where given (a path's shape that takes
        another); the errors count under ``record`` (default ``kernel``)."""
        record = record or kernel
        prep = prep or (lambda t: t)
        counter = launch_counts()[kernel]
        # float32: max abs error <= 1e-4 * max(1, max|ref|)
        got = kernel_fn(*[prep(t) for t in inputs])
        if kernel == "correlation":
            same_launches(label + " float32", kernel_fn, prep, inputs, got)
        ref = plain_fn(*inputs)
        err = (got - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        torch.cuda.synchronize()
        if not err <= 1e-4 * scale:
            fail(f"{kernel} {label} float32: max abs err {err:.3e} > {1e-4 * scale:.3e}")
        self.max_abs_err_f32[record] = max(self.max_abs_err_f32[record], err)
        # bfloat16: |got - ref| <= 2e-2 |ref| (output rounding) + the float32
        # bound above (summation order)
        inputs_bf = [t.bfloat16() for t in inputs]
        before = dict(getattr(counter, "variant_launches", {}))
        got = kernel_fn(*[prep(t) for t in inputs_bf])
        after = getattr(counter, "variant_launches", {})
        ran = next((v for v in after if after[v] != before.get(v)), "none")
        if got.dtype != torch.bfloat16:
            fail(f"{kernel} {label}: bfloat16 input gave {got.dtype}")
        if kernel == "correlation" and ran == "reg_tile":
            same_launches(label + " bfloat16", kernel_fn, prep, inputs_bf, got)
        ref = plain_fn(*[t.float() for t in inputs_bf])
        abs_err = (got.float() - ref).abs()
        excess = (abs_err - 2e-2 * ref.abs()).max().item()
        scale = max(1.0, ref.abs().max().item())
        torch.cuda.synchronize()
        if not excess <= 1e-4 * scale:
            fail(f"{kernel} {label} bfloat16 ({ran}): error exceeds 2e-2 |ref| "
                 f"by {excess:.3e}")
        if main_path:
            want = expect or MAIN_VARIANT[kernel]
            if ran != want:
                fail(f"{kernel} {label} bfloat16 ran {ran}, not {want}")
            self.max_abs_err[record] = max(self.max_abs_err[record], abs_err.max().item())
        self.errs[kernel, label] = (err, abs_err.max().item())
        self.variants[kernel, label] = ran
        print(f"  {kernel:16s} {label:34s} f32 err {err:.2e}  bf16 ok ({ran}, "
              f"max abs err {abs_err.max().item():.2e})", flush=True)


def same_launches(label, kernel_fn, prep, inputs, first):
    """A second launch of the cost volume on the same inputs gives the first
    one's output bit for bit (fixed summation order, no atomics)."""
    if not torch.equal(kernel_fn(*[prep(t) for t in inputs]), first):
        fail(f"correlation {label}: two launches differ")


@phase("kernels")
def kernels_phase(chk):
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.headconv import head_conv_cuda, head_conv_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda
    from dfvo_torch.ops.regfilter import reg_dist_filter_cuda

    check_main_path_shapes(chk, (CORR_SHAPES, REG_SHAPES, LFN_HEADS, DEPTH_HEADS))
    # off the main path (the reg_tile variants in bf16 too): channel counts
    # that do not fill 16-byte vectors and a base address that is not 16-byte
    # aligned take the kernels' scalar loads; the cost volume at C = 24 in
    # bf16 (vector staging outside the tensor-core set), at its largest C and
    # on a 1x1 map; the head conv at Cout 3 and 4 and k = 1 (reg_tile)
    if set(correlation_cuda.variant_launches) != {"tensor_core", "reg_tile"}:
        fail(f"correlation variants {sorted(correlation_cuda.variant_launches)}, expected "
             "tensor_core and reg_tile")
    for label, shape, prep in (("c=33", (2, 12, 40, 33), None),
                               ("unaligned", (2, 12, 40, 64), misaligned),
                               ("c=24", (2, 12, 40, 24), None),
                               ("c=1536", (2, 6, 20, 1536), None),
                               ("1x1", (2, 1, 1, 64), None)):
        f1, f2 = chk.randn(shape), chk.randn(shape)
        chk.compare("correlation", f"{label} {list(shape)}",
                    lambda a, b: correlation_cuda(a, b, 3, 1),
                    lambda a, b: correlation_plain(a, b, 3, 1), (f1, f2), prep=prep,
                    main_path=False)
        ran = chk.variants["correlation", f"{label} {list(shape)}"]
        if ran != ("tensor_core" if label == "1x1" else "reg_tile"):
            fail(f"correlation {label}: bf16 ran {ran}")
    check_head(chk, "cin=3", 2, (24, 80, 3), 2, 5, False, head_conv_cuda,
               head_conv_plain, main_path=False)
    check_head(chk, "unaligned", 2, (24, 80, 32), 2, 5, False, head_conv_cuda,
               head_conv_plain, prep=misaligned, main_path=False)
    check_head(chk, "cout=3 k7 pre", 2, (30, 86, 20), 3, 7, True, head_conv_cuda,
               head_conv_plain, main_path=False)
    check_head(chk, "cout=4 k1", 2, (24, 80, 12), 4, 1, False, head_conv_cuda,
               head_conv_plain, main_path=False)
    # the regularization filter off the path: ragged tiles on both edges, a
    # raw and flow one element past an aligned address (unaligned spans and
    # element-wise flow staging), and logits of +-300 where every tap but the
    # minimum underflows
    check_reg(chk, "ragged [2, 13, 41] k7", 2, 13, 41, 7, main_path=False)
    check_reg(chk, "unaligned [2, 24, 80] k5", 2, 24, 80, 5, prep=misaligned, main_path=False)
    big = torch.sign(chk.randn((2, 12, 40, 49))) * chk.rand((2, 12, 40, 49), 300.0, 305.0)
    check_reg(chk, "+-300 [2, 12, 40] k7", 2, 12, 40, 7, raw=big, main_path=False)
    # the cost volume's other window (HD3's; its shapes in the hd3 phase)
    # and its stride-2 form (tensor_core in bf16)
    f1, f2 = chk.randn((2, 24, 80, 64)), chk.randn((2, 24, 80, 64))
    chk.compare("correlation", "D=4 [2, 24, 80, 64]",
                lambda a, b: correlation_cuda(a, b, 4, 1),
                lambda a, b: correlation_plain(a, b, 4, 1), (f1, f2), main_path=False)
    chk.compare("correlation", "stride 2 [2, 48, 160, 64]",
                lambda a, b: correlation_cuda(a, b, 3, 2),
                lambda a, b: correlation_plain(a, b, 3, 2),
                (chk.randn((2, 48, 160, 64)), chk.randn((2, 48, 160, 64))),
                main_path=False)
    # the raw forward wrappers record no gradient (the Functions carry the
    # backward kernels): a CUDA input that requires grad is refused while
    # autograd records, before any launch
    x = chk.randn((2, 12, 40, 64)).bfloat16()
    raw, flow = chk.randn((2, 12, 40, 9)).bfloat16(), chk.randn((2, 12, 40, 2)).bfloat16()
    wts = [chk.randn((1, 9, 1, 1)).bfloat16(), chk.randn((1,)).bfloat16()] * 2
    head = chk.randn((3, 3, 64, 2)).bfloat16()
    calls = {"correlation": (correlation_cuda, lambda g: (g(x), x, 3, 1)),
             "reg_dist_filter": (reg_dist_filter_cuda, lambda g: (raw, g(flow), *wts, 3)),
             "head_conv": (head_conv_cuda, lambda g: (x, g(head)))}
    for name, (fn, args) in calls.items():
        before = fn.launches
        try:
            fn(*args(lambda t: t.clone().requires_grad_(True)))
        except RuntimeError as e:
            if "no backward pass" not in str(e):
                raise
        else:
            fail(f"{name}: a CUDA input that requires grad was not refused")
        with torch.no_grad():
            fn(*args(lambda t: t.clone().requires_grad_(True)))
        if fn.launches != before + 1:
            fail(f"{name}: {fn.launches - before} launches around the grad refusal, expected 1")
    print("  correlation, reg_dist_filter, head_conv: CUDA inputs that require grad refused "
          "while autograd records (no launch); launched under no_grad")


def check_reg(chk, label, n, h, w, k, raw=None, prep=None, main_path=True):
    """The regularization filter from the raw moduleDist logits, as the
    path gives them, against its plain version."""
    from dfvo_torch.ops.regfilter import reg_dist_filter_cuda, reg_dist_filter_plain

    raw = chk.randn((n, h, w, k * k), 2.0) if raw is None else raw
    flow = chk.randn((n, h, w, 2), 4.0)
    wts = [chk.randn((1, k * k, 1, 1)), chk.randn((1,)),
           chk.randn((1, k * k, 1, 1)), chk.randn((1,))]
    chk.compare("reg_dist_filter", label,
                lambda d, f, *p: reg_dist_filter_cuda(d, f, *p, k),
                lambda d, f, *p: reg_dist_filter_plain(d, f, *p, k),
                (raw, flow, *wts), prep=prep, main_path=main_path)


def check_main_path_shapes(chk, shapes, lfn_batches=LFN_BATCHES, depth_batches=DEPTH_BATCHES,
                           suffix=""):
    """Each kernel against its plain version at every main-path shape of
    ``shapes`` (``main_path_shapes``), at each batch of the path."""
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.headconv import head_conv_cuda, head_conv_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda

    corr_shapes, reg_shapes, lfn_heads, depth_heads = shapes
    for n in lfn_batches:
        for lvl, (h, w, c) in corr_shapes:
            f1, f2 = chk.randn((n, h, w, c)), chk.randn((n, h, w, c))
            if lvl <= 3:
                # as on the path: f1 is the [::2, ::2] view of the full map
                f1 = chk.randn((n, 2 * h, 2 * w, c))[:, ::2, ::2]
            chk.compare("correlation", f"L{lvl} {[n, h, w, c]}{suffix}",
                        lambda a, b: correlation_cuda(a, b, 3, 1),
                        lambda a, b: correlation_plain(a, b, 3, 1), (f1, f2))
        for lvl, (h, w), k in reg_shapes:
            check_reg(chk, f"L{lvl} k{k} {[n, h, w]}{suffix}", n, h, w, k)
        for name, hwc, cout, k, pre in lfn_heads:
            check_head(chk, name + suffix, n, hwc, cout, k, pre, head_conv_cuda,
                       head_conv_plain)
    for n in depth_batches:
        for name, hwc, cout, k, pre in depth_heads:
            check_head(chk, name + suffix, n, hwc, cout, k, pre, head_conv_cuda,
                       head_conv_plain)


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


def backward_counts():
    """The backward kernels' wrappers, by the forward kernel they belong to."""
    from dfvo_torch.ops.headconv import head_conv_backward_cuda
    from dfvo_torch.ops.pallas_corr import correlation_backward_cuda
    from dfvo_torch.ops.regfilter import reg_dist_filter_backward_cuda

    return {"correlation": correlation_backward_cuda,
            "reg_dist_filter": reg_dist_filter_backward_cuda,
            "head_conv": head_conv_backward_cuda}


def reset_launch_counts():
    """Every count of the forward and backward kernels to 0; returns the
    forward ones (``backward_counts`` has the others)."""
    counters = launch_counts()
    for fn in (*counters.values(), *backward_counts().values()):
        fn.launches = 0
        for counts in (getattr(fn, "variant_launches", {}), getattr(fn, "disp_launches", {}),
                       getattr(fn, "dtype_launches", {})):
            for v in counts:
                counts[v] = 0
        fn.batch_launches.clear()
    return counters


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

    counters = reset_launch_counts()
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


# A torch.profiler trace on the card drops the first device events of
# the trace: none early in a process, 3 a trace a few minutes in, up to
# 15 late in this script, and now and then many more
# (scripts/profiler_trace_check.py; PERF.md section 6). Each trace
# therefore opens with spin kernels, which its sums leave out; while no
# spin kernel reaches the trace the lead-in doubles, up to 1,024, and the
# next trace waits longer (0.5 s, then twice as long each time: a loss
# of every event has held for six traces in a row). The rarer larger
# losses are caught by counting (device_ms, profile_call).
SPIN = "spin_kernel"


class DeviceOp:
    """The device events of one name in a trace: their number and summed
    time, named as torch.profiler's ``key_averages()`` names them."""

    __slots__ = ("key", "count", "self_device_time_total")

    def __init__(self, key):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_ops(prof):
    """The device events of a finished trace, summed by name, read from the
    profiler's raw events. ``prof.key_averages()`` gives the same sums but
    first builds a tree of every host op, about a millisecond per kernel on
    the card's host: minutes for the traces of the larger steps. The
    profile phase holds the two against each other."""
    from torch.autograd import DeviceType

    raw = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_hidden_event", lambda: False)():
            continue
        op = raw.get(e.name()) or raw.setdefault(e.name(), DeviceOp(e.name()))
        op.count += 1
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            op.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
    ops = {}
    for name, op in raw.items():
        key = torch._C._demangle(name) if len(name) > 1 else name
        merged = ops.setdefault(key, DeviceOp(key))
        merged.count += op.count
        merged.self_device_time_total += op.self_device_time_total
    return list(ops.values())


def profiled(fn, lead_in=32, **kw):
    """(profile, device events without the lead-in, wall ms) of one
    ``fn()`` under torch.profiler, after ``lead_in`` spin kernels."""
    from torch.profiler import ProfilerActivity, profile

    misses = 0
    while True:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
            for _ in range(lead_in):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_ops(prof)
        if any(SPIN in e.key for e in events):
            return prof, [e for e in events if SPIN not in e.key], wall_ms
        misses += 1
        held = sum(e.count for e in events)
        LOST_TRACES.append(("spin lead-in", 1, held, None))
        print(f"  (no spin kernel of a lead-in of {lead_in} reached the trace; {held} "
              "device events; traced again)", flush=True)
        if misses == 8:
            fail(f"no spin kernel of 8 lead-ins up to {lead_in} reached the trace")
        lead_in = min(2 * lead_in, 1024)
        time.sleep(0.25 * 2 ** misses)


def trace(fn, calls):
    """(device ms, device events) of ``calls`` calls of ``fn`` in one
    trace: the time of every device event, summed, and their number."""
    def run():
        for _ in range(calls):
            fn()

    _, events, _ = profiled(run)
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


# every trace that held another number of device events than its calls
# launched: (label, calls in the trace, events held, events expected;
# None where no spin kernel of the lead-in reached the trace)
LOST_TRACES = []


def device_ms(fn, reps=20, label="call"):
    """Device time per call: the device time of every kernel that ``reps``
    calls launch (torch.profiler), summed, over ``reps``. Unlike a CUDA-event
    interval it leaves out the gaps while the host launches the next call,
    which set the pace of small shapes on a slow host.

    A trace counts only when it holds every device event of its calls:
    ``reps`` times the events of one call, on which two traces of one call
    must agree (of at most six: a trace can lose events of its call too,
    and the calls are traced until two agree). A trace that holds another
    number is recorded in ``LOST_TRACES`` and taken again, four times at
    most; then the script fails. No other measure stands in for it."""
    fn()
    torch.cuda.synchronize()
    one = []
    while True:
        one.append(trace(fn, 1)[1])
        # the largest count that two traces agree on: a trace can only lose
        # events, and one that lost every event of the call says nothing
        agreed = [n for n in set(one) if n > 0 and one.count(n) >= 2]
        if agreed:
            per_call = max(agreed)
            break
        if len(one) == 6:
            fail(f"{label}: six traces of one call held {one} device events")
    for n in one:
        if n != per_call:
            LOST_TRACES.append((label, 1, n, per_call))
            print(f"  ({label}: a trace of one call held {n} device events, not "
                  f"{per_call}; traced again)", flush=True)
    for _ in range(5):
        ms, events = trace(fn, reps)
        if events == per_call * reps:
            return ms / reps
        LOST_TRACES.append((label, reps, events, per_call * reps))
        print(f"  ({label}: a trace of {reps} calls held {events} device events, "
              f"not {per_call * reps}; traced again)", flush=True)
    fail(f"{label}: five traces of {reps} calls lost device events ({LOST_TRACES[-5:]})")


def bound(nbytes, flops, peak_flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    each input byte read once and each output byte written once against
    the HBM rate, the operations against the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_cases(chk, shapes=(CORR_SHAPES, REG_SHAPES, LFN_HEADS, DEPTH_HEADS),
                 batches=((64, 1, (6, 5, 4, 3, 2)), (2, 0, (2,))), depth_n=32):
    """Every kernel at every main-path shape of one `infer_chunk` network
    call (N = 64 LiteFlowNet, N = 32 depth), with its launches in that call,
    and level 2 at N = 2 (`infer`, not in the per-call sums). Inputs in
    bf16, laid out as the path gives them. ``batches`` holds (LiteFlowNet's
    N, calls per network call, levels); the first entry also times the
    disparity heads, at N = ``depth_n``."""
    corr_shapes, reg_shapes, lfn_heads, depth_heads = shapes
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.headconv import head_conv_cuda, head_conv_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda
    from dfvo_torch.ops.regfilter import reg_dist_filter_cuda, reg_dist_filter_plain

    bf = torch.bfloat16
    cases = []
    for n, per_call, levels in batches:
        for lvl, (h, w, c) in corr_shapes:
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
        for lvl, (h, w), k in reg_shapes:
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
        heads = [(name, hwc, cout, k, pre, 2 * per_call) for name, hwc, cout, k, pre in lfn_heads
                 if int(name.split("L")[1]) in levels]
        if n == batches[0][0]:
            heads += [(name, hwc, cout, k, pre, 1) for name, hwc, cout, k, pre in depth_heads]
        for name, (h, w, cin), cout, k, pre, calls in heads:
            nn_ = depth_n if name.startswith("dispconv") else n
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

    rows, sums = kernel_times(timing_cases(chk))
    return infer_ms, per_frame_chunk, rows, sums


def kernel_times(cases, names=tuple(PER_CALL), per="infer_chunk network call"):
    """Device ms (torch.profiler) and CUDA-event ms of each case beside its
    plain version, its library call and its bound; and the sums per
    ``per`` (an `infer_chunk` network call), weighted by the launches at
    each shape, for each kernel of ``names``."""
    rows = []
    print("  device ms per call (torch.profiler); event: CUDA-event ms per call "
          "back to back, host gaps included")
    print("  kernel           shape                            ms      event_ms  plain_ms  "
          "library_ms  bound_ms (by)           share  launches/call")
    for case in cases:
        # CUDA events in turns: plain, library, kernel, kernel, library, plain
        p1 = time_cuda(case["pfn"], reps=5, rounds=3)
        l1 = time_cuda(case["lfn"], reps=20) if case["lfn"] else None
        k1 = time_cuda(case["kfn"], reps=20)
        k2 = time_cuda(case["kfn"], reps=20)
        l2 = time_cuda(case["lfn"], reps=20) if case["lfn"] else None
        p2 = time_cuda(case["pfn"], reps=5, rounds=3)
        bound_ms, bound_by = case["bound"]
        label = f"{case['kernel']} {case['shape']}"
        row = {"kernel": case["kernel"], "shape": case["shape"], "n": case["n"],
               "launches_per_call": case["per_call"],
               "ms": device_ms(case["kfn"], 20, label),
               "plain_ms": device_ms(case["pfn"], 3, label + " plain"),
               "library_ms": None if l1 is None else device_ms(
                   case["lfn"], 20, label + " library"),
               "event_ms": statistics.median([k1, k2]),
               "event_plain_ms": statistics.median([p1, p2]),
               "event_library_ms": None if l1 is None else statistics.median([l1, l2]),
               "bound_ms": bound_ms, "bound_by": bound_by}
        row["share_of_bound"] = bound_ms / row["ms"]
        if row["ms"] < bound_ms:
            print(f"  ({label}: {row['ms']:.4f} ms is below its bound {bound_ms:.4f} ms, "
                  "which counts every byte at the HBM rate)")
        rows.append(row)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"  {row['kernel']:16s} {row['shape']:32s} {row['ms']:.4f}  {row['event_ms']:.4f}  "
              f"{row['plain_ms']:8.4f}  {lib:>10s}  {bound_ms:.4f} ({bound_by:10s})  "
              f"{100 * row['share_of_bound']:5.1f} %  {row['launches_per_call']}", flush=True)
    sums = {}
    for name in names:
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
        print(f"  per {per}, {name}: {s['launches_per_call']} launches, "
              f"kernel {s['ms']:.4f} ms, bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
              f"share {100 * s['bound_ms'] / s['ms']:.1f} %, plain {s['plain_ms']:.4f} ms, "
              f"library {lib}")
    return rows, sums


@phase("profile")
def profile_phase(fe, variables, imgs, out_dir):
    """Device time by kernel name for one `infer` and one `infer_chunk` call
    (torch.profiler), and the device-busy share of the call's wall time. The
    profiler's own host cost lengthens the wall time, so the share is a
    lower bound."""
    result = {}
    calls = (("infer", lambda: fe.infer(variables, imgs[1], imgs[0])),
             ("infer_chunk", lambda: fe.infer_chunk(variables, imgs)))
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        prof, events, wall_ms = counted_profile(fn, name, record_shapes=True)
        rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3) for e in events),
                      key=lambda r: -r[2])
        busy_ms = sum(r[2] for r in rows)
        launches = sum(r[1] for r in rows)
        # the fused normalisation: no prologue op on a [N,H,W,k²] tensor
        prologue = [(e.name, e.input_shapes[0]) for e in prof.events()
                    if e.name in PROLOGUE_OPS and e.input_shapes
                    and len(e.input_shapes[0]) == 4 and e.input_shapes[0][-1] in (9, 25, 49)]
        print(f"  {name}: {len(prologue)} pow/neg/amax/sub/exp ops on [N,H,W,k²] tensors")
        if prologue:
            fail(f"{name}: normalisation ops outside the kernel: {prologue[:5]}")
        # device_ops against the profiler's own sums of the same trace
        from torch.autograd import DeviceType

        slow = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and SPIN not in e.key}
        fast = {e.key: (e.count, e.self_device_time_total) for e in events}
        if slow.keys() != fast.keys() or any(
                slow[k][0] != fast[k][0]
                or not math.isclose(slow[k][1], fast[k][1], rel_tol=1e-9, abs_tol=1e-3 * slow[k][0])
                for k in slow):
            fail(f"{name}: device_ops disagrees with key_averages: "
                 f"{sorted(set(slow.items()) ^ set(fast.items()))[:5]}")
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


def track_tcfg():
    """tests/test_pipeline.py's TCFG: the YAML defaults at 192x640, with the
    whole image kept for depth (the scenes are synthetic)."""
    from dfvo_torch.pipeline.tracking import TrackingConfig

    return TrackingConfig(height=192, width=640, depth_crop=((0.0, 1.0), (0.0, 1.0)),
                          max_depth=50.0)


def gt_motion(scale):
    """(T_cur2ref, T_ref2cur) of tests/test_pipeline.py: a small rotation
    and a translation of norm ``scale``."""
    from dfvo_torch.geometry.lie import so3_exp

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = so3_exp(torch.tensor([0.005, -0.01, 0.002])).numpy()
    t = np.array([0.1, -0.05, 0.98])
    T[:3, 3] = t / np.linalg.norm(t) * scale
    return T, np.linalg.inv(T).astype(np.float32)


def synthesize(depth_ref, T_ref2cur, K=TRACK_K):
    """Exact rigid flow ref -> cur of a depth map, and the current view's
    depth scattered at the projected pixels (the port's geometry, on the
    CPU)."""
    from dfvo_torch.geometry.ops import backproject_depth, project_points

    h, w = depth_ref.shape
    K_inv = np.linalg.inv(K).astype(np.float32)
    pts_ref = backproject_depth(torch.from_numpy(depth_ref)[None], torch.from_numpy(K_inv))
    pts_cur = torch.einsum("ij,nhwj->nhwi", torch.from_numpy(T_ref2cur), pts_ref)
    pix = project_points(pts_cur, torch.from_numpy(K))[0].numpy()
    flow = pix - np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    z = pts_cur[0, ..., 2].numpy()
    px = np.floor(pix[..., 0]).astype(int)
    py = np.floor(pix[..., 1]).astype(int)
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
    depth_cur = np.zeros((h, w), np.float32)
    depth_cur[py[ok], px[ok]] = z[ok]
    return flow.astype(np.float32), depth_cur


def track_scenes(h=192, w=640, K=TRACK_K):
    """The scenes of tests/test_pipeline.py (E success, planar -> PnP,
    constant motion) and the spike case of tests/test_tracking_options.py,
    on smooth oracle depth fields: name -> (inputs, T_cur2ref or None)."""
    from dfvo_torch.synth.oracle import smooth_field

    zeros = np.zeros((h, w), np.float32)
    eye = np.eye(4, dtype=np.float32)

    def depth(seed):
        return smooth_field(np.random.RandomState(seed), h, w, lo=5.0, hi=40.0).astype(np.float32)

    scenes = {}
    for name, seed, scale, prev_scale in (("essential", 0, 1.5, 1.0), ("planar", None, 0.8, 1.0),
                                          ("spike", 3, 1.5, 0.1)):
        d_ref = np.full((h, w), 15.0, np.float32) if seed is None else depth(seed)
        T_gt, T_r2c = gt_motion(scale)
        flow, d_cur = synthesize(d_ref, T_r2c, K)
        scenes[name] = ((flow, zeros, d_cur, d_ref, eye, prev_scale), T_gt)
    rng = np.random.RandomState(1)
    d_ref = depth(2)
    prev = eye.copy()
    prev[2, 3] = 0.7
    flow = rng.randn(h, w, 2).astype(np.float32)
    scenes["const"] = ((flow, np.ones((h, w), np.float32), d_ref, d_ref, prev, 1.0), None)
    return scenes


def track_call(inputs, device, tcfg, key=None, K=TRACK_K):
    """A closure running tracking_step on ``inputs`` moved to ``device``."""
    from dfvo_torch.pipeline.tracking import tracking_step
    from dfvo_torch.utils import prng

    flow, fd, dc, dr, prev, ps = inputs
    args = [torch.from_numpy(a).to(device) for a in (flow, fd, dc, dr, prev)]
    K_inv = torch.from_numpy(np.linalg.inv(K).astype(np.float32)).to(device)
    K = torch.from_numpy(K).to(device)
    key = prng.PRNGKey(0) if key is None else key
    return lambda: tracking_step(key, *args, K, K_inv, tcfg, prev_scale=ps)


def rot_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees (atan2 form, exact near zero)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    v = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arctan2(np.linalg.norm(v) / 2, (np.trace(M) - 1) / 2)))


# mode per scene; pose bounds of the JAX tests (tests/test_pipeline.py,
# tests/test_tracking_options.py)
TRACK_MODES = {"essential": 1, "planar": 2, "const": 0, "spike": 2}


def check_track_bounds(name, out, inputs, T_gt):
    P = out["pose"].astype(np.float64)
    mode, scale = int(out["mode"]), float(out["scale"])
    if mode != TRACK_MODES[name]:
        fail(f"track {name}: mode {mode}, expected {TRACK_MODES[name]}")
    if T_gt is None:
        if not np.allclose(P, inputs[4], atol=1e-6):
            fail(f"track {name}: pose is not the previous motion")
        return {}
    ang = rot_deg(P[:3, :3], T_gt[:3, :3])
    terr = float(np.linalg.norm(P[:3, 3] - T_gt[:3, 3]))
    tnorm = float(np.linalg.norm(P[:3, 3]))
    bounds = {"essential": ang < 0.1 and abs(tnorm - 1.5) / 1.5 < 0.05 and terr < 0.15,
              "planar": ang < 0.1 and terr < 0.1,
              "spike": scale == -1.0 and terr < 0.1}
    if not bounds[name]:
        fail(f"track {name}: rotation {ang:.4f} deg, |t| {tnorm:.4f}, t error {terr:.4f}, "
             f"scale {scale} outside the JAX tests' bounds")
    return {"rot_err_deg": ang, "t_err": terr, "t_norm": tnorm}


def compare_track(name, got, want, inliers_by_count=False):
    """The card's tracking_step against the CPU's, with the CPU parity
    tests' tolerances (tests/test_torch_tracking.py). With
    ``inliers_by_count`` (a PnP frame with pnp_iterative_kp: its inliers
    index rigid-flow keypoints chosen by a score that is rounding noise on
    an exact scene, so the card and the CPU pick other pixels) the inlier
    counts agree within 20 % (9.7 % apart on the planar scene at 370x1226,
    measured first)."""
    if int(got["mode"]) != int(want["mode"]):
        fail(f"track {name}: card mode {int(got['mode'])} != CPU mode {int(want['mode'])}")
    if not np.array_equal(got["kp_ref"], want["kp_ref"]):
        fail(f"track {name}: card keypoints differ from the CPU's")
    P, Q = got["pose"].astype(np.float64), want["pose"].astype(np.float64)
    ang = rot_deg(P[:3, :3], Q[:3, :3])
    dt = float(np.linalg.norm(P[:3, 3] - Q[:3, 3]))
    s, sq = float(got["scale"]), float(want["scale"])
    valid = want["kp_valid"]
    agree = float((got["inliers"] == want["inliers"])[valid].mean()) if valid.any() else 1.0
    if inliers_by_count:
        n, nq = int(got["inliers"].sum()), int(want["inliers"].sum())
        agree = 1.0 - abs(n - nq) / max(nq, 1)
        ok_inliers = agree >= 0.8
    else:
        ok_inliers = agree >= 0.995
    if not (ang < 0.01 and dt <= 1e-3 * np.linalg.norm(Q[:3, 3]) and abs(s - sq) <= 1e-3 * abs(sq)
            and ok_inliers):
        fail(f"track {name}: card vs CPU rotation {ang:.2e} deg, translation {dt:.2e}, "
             f"scale {s} vs {sq}, inliers agree {agree:.4f}")
    return {"rot_deg": ang, "t": dt, "scale_rel": abs(s - sq) / abs(sq), "inliers_agree": agree}


def to_numpy(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


@phase("track")
def track_phase():
    """tracking_step on the four scenes at 192x640 on the card, held to the
    JAX tests' bounds and to the same step on the CPU; the RANSAC hash
    draws on the card against the CPU's bit for bit. TF32 is switched on for
    matmuls around the step: highp must switch it off inside."""
    from dfvo_torch.solvers.ransac import _hash_draw, sample_points
    from dfvo_torch.utils import prng

    tcfg = track_tcfg()
    scenes = track_scenes()
    results = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for name, (inputs, T_gt) in scenes.items():
            got = to_numpy(track_call(inputs, "cuda", tcfg)())
            if torch.backends.cuda.matmul.allow_tf32 is not True:
                fail("highp did not restore the caller's matmul precision")
            want = to_numpy(track_call(inputs, "cpu", tcfg)())
            res = check_track_bounds(name, got, inputs, T_gt)
            res.update(mode=int(got["mode"]), scale=float(got["scale"]),
                       card_vs_cpu=compare_track(name, got, want))
            results[name] = res
            print(f"  {name:9s} mode {res['mode']} scale {res['scale']:.4f} "
                  + " ".join(f"{k} {v:.4g}" for k, v in res.items()
                             if k in ("rot_err_deg", "t_err", "t_norm"))
                  + f"; card vs CPU {({k: f'{v:.2e}' for k, v in res['card_vs_cpu'].items()})}",
                  flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(SEED)
    for i, n in enumerate((1, 37, 1999, 2000, 100000)):
        key = prng.fold_in(prng.PRNGKey(4869), i)
        mask = rng.rand(n) > 0.3
        count = torch.tensor(max(int(mask.sum()), 1))
        cpu = _hash_draw(key, 10240, count, "cpu")
        gpu = _hash_draw(key, 10240, count.cuda(), "cuda").cpu()
        pts = torch.from_numpy(rng.randn(n, 5).astype(np.float32))
        m = torch.from_numpy(mask)
        same = torch.equal(cpu, gpu) and torch.equal(
            sample_points(key, pts, m, 1280, 8),
            sample_points(key, pts.cuda(), m.cuda(), 1280, 8).cpu())
        if not same:
            fail(f"hash draws or sampled points on the card differ from the CPU's (n={n})")
    print("  _hash_draw and sample_points: card equal to CPU bit for bit (5 keys, n up to 100000)")
    return scenes, results


@phase("frame")
def frame_phase(fe, variables, seed):
    """depth_only on frame 0, then FRAME_STEPS chained frame_steps of the
    default configuration (bf16, the kernels), poses chained on the host."""
    from dfvo_torch.geometry.camera import SE3
    from dfvo_torch.pipeline.dfvo import depth_only, frame_step, next_prev_scale, update_global_pose
    from dfvo_torch.pipeline.tracking import TrackingConfig
    from dfvo_torch.utils import prng

    cfg = load_cfg()  # the YAML as it is
    tcfg = TrackingConfig.from_cfg(cfg)
    h, w = cfg.image.height, cfg.image.width
    frames = torch.from_numpy(make_frames(seed, CHUNK_FRAMES, h, w)[:FRAME_STEPS + 1]).cuda()
    K = torch.from_numpy(TRACK_K).cuda()
    K_inv = torch.from_numpy(np.linalg.inv(TRACK_K).astype(np.float32)).cuda()
    print(f"  TrackingConfig.from_cfg(default YAML): {tcfg.tracking_method}, {tcfg.kp_method} "
          f"{tcfg.num_kp}, {tcfg.e_repeat} x {tcfg.num_hypotheses} E hypotheses, "
          f"{tcfg.scale_max_trials} scale trials, {tcfg.pnp_repeat} x {tcfg.pnp_iter} PnP, "
          f"guard {tcfg.scale_jump_guard}")

    counters = reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth = depth_only(fe, variables, frames[0])
    prev_motion = torch.eye(4, device="cuda")
    prev_scale = torch.ones((), device="cuda")
    poses, modes, last = [SE3()], [], None
    for i in range(1, FRAME_STEPS + 1):
        out = frame_step(fe, tcfg, variables, frames[i], frames[i - 1], depth, prev_motion,
                         prng.fold_in(prng.PRNGKey(cfg.seed), i), K, K_inv, prev_scale)
        rel = SE3(out["pose"].double().cpu().numpy())
        poses.append(update_global_pose(poses[-1], rel))
        modes.append(int(out["mode"]))
        prev_motion, depth = out["pose"], out["depth_cur_raw"]
        prev_scale = next_prev_scale(out["scale"], prev_scale)
        last = (frames[i], frames[i - 1], out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    expected = {k: FRAME_STEPS * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    if not all(np.isfinite(p.pose).all() for p in poses):
        fail("frame: a chained pose is not finite")
    check_finite("depth_cur_raw", last[2]["depth_cur_raw"], (h, w))
    print(f"  depth_only + {FRAME_STEPS} frame_step in {wall:.2f} s (first calls included); "
          f"modes {modes}; final position {np.round(poses[-1].t[:, 0], 6).tolist()}")
    print(f"  launches {launches}, expected {expected} ({PER_CALL} per network call, "
          f"{DEPTH_ONLY_CALL} in depth_only)")
    if launches != expected:
        fail(f"frame launch counts {launches} != {expected}")
    return {"tcfg": tcfg, "K": K, "K_inv": K_inv, "last": last, "modes": modes,
            "launches": launches, "seed": cfg.seed}


def count_syncs(fn):
    """Host synchronisations in one call of ``fn`` (CUDA sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def counted_profile(fn, label, **kw):
    """``profiled(fn)`` whose number of device events the trace before it
    agrees on: a trace whose count differs from the one before is recorded
    in ``LOST_TRACES`` and the call traced again, four times at most."""
    prof, events, wall_ms = profiled(fn, **kw)
    n = sum(e.count for e in events)
    for _ in range(4):
        prof, events, wall_ms = profiled(fn, **kw)
        n, last = sum(e.count for e in events), n
        if n == last:
            return prof, events, wall_ms
        LOST_TRACES.append((label, 1, min(n, last), max(n, last)))
        print(f"  ({label}: two traces of one call held {last} and {n} device events; "
              "traced again)", flush=True)
    fail(f"{label}: no two traces in a row held the same device events ({LOST_TRACES[-4:]})")


def profile_call(fn, label, out_dir):
    """Kernels, device busy share and top device ops of one call."""
    fn()
    torch.cuda.synchronize()
    _, events, wall_ms = counted_profile(fn, label)
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3) for e in events),
                  key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    kernels = sum(r[1] for r in rows)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(f"{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
                f"{kernels} kernels\n")
        for key, count, ms in rows:
            f.write(f"{ms:10.4f} ms {count:6d}x  {key}\n")
    print(f"  {label}: wall {wall_ms:.2f} ms under the profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), {kernels} kernels")
    for key, count, ms in rows[:6]:
        print(f"    {ms:8.3f} ms {count:5d}x  {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "kernels": kernels, "top": [[k, c, ms] for k, c, ms in rows[:10]]}


@phase("tracking")
def tracking_phase(fe, variables, scenes, frame, out_dir):
    """CUDA-event medians of tracking_step (E and planar scenes) and of
    frame_step, host syncs per tracking_step, and profiles of one
    tracking_step per scene and of one frame_step."""
    from dfvo_torch.pipeline.dfvo import frame_step
    from dfvo_torch.utils import prng

    tcfg = track_tcfg()
    calls = {name: track_call(scenes[name][0], "cuda", tcfg) for name in ("essential", "planar")}
    cur, ref, out = frame["last"]
    key = prng.fold_in(prng.PRNGKey(frame["seed"]), FRAME_STEPS)

    def one_frame():
        return frame_step(fe, frame["tcfg"], variables, cur, ref, out["depth_cur_raw"],
                          out["pose"], key, frame["K"], frame["K_inv"], 1.0)

    result = {"tracking_step": {}}
    for name, fn in calls.items():
        syncs = count_syncs(fn)
        if syncs != 1:
            fail(f"tracking_step ({name}): {syncs} host syncs, expected 1 (the PnP decision)")
        ms = time_cuda(fn, reps=5, rounds=3)
        prof = profile_call(fn, f"tracking_step_{name}", out_dir)
        result["tracking_step"][name] = {"ms": ms, "host_syncs": syncs, **prof}
        print(f"  tracking_step {name}: {ms:.3f} ms (CUDA events, median), {syncs} host sync",
              flush=True)
    frame_ms = time_cuda(one_frame, reps=3, rounds=3)
    result["frame_step"] = {"ms_per_frame": frame_ms, "modes": frame["modes"],
                            **profile_call(one_frame, "frame_step", out_dir)}
    print(f"  frame_step: {frame_ms:.3f} ms/frame (CUDA events, median; bfloat16, 192x640)")
    return result


def write_run_sequence(root, seed, frames=RUN_FRAMES, seq=RUN_SEQ, calib=RUN_CALIB):
    """A KITTI-odometry-layout sequence ``seq`` of ``frames`` JPEG frames (a
    smooth texture panning 2 px per frame), its calib.txt (``calib``, one
    P line's 12 numbers) and GT poses (the camera moving 5.6 cm right per
    frame, a 2 px shift at 20 m)."""
    import cv2

    h, w = RUN_SIZE
    rng = np.random.default_rng(seed)
    span = w + 2 * frames
    coarse = rng.integers(0, 256, (h // 8, span // 8, 3)).astype(np.uint8)
    texture = cv2.resize(coarse, (span, h), interpolation=cv2.INTER_CUBIC)
    seq_dir = os.path.join(root, "odom_data", seq)
    os.makedirs(os.path.join(seq_dir, "image_2"), exist_ok=True)
    os.makedirs(os.path.join(root, "gt_poses"), exist_ok=True)
    lines = []
    for i in range(frames):
        cv2.imwrite(os.path.join(seq_dir, "image_2", f"{i:06d}.jpg"),
                    texture[:, 2 * i : 2 * i + w])
        P = np.eye(4)
        P[0, 3] = 2 * 20.0 / 718.856 * i
        lines.append(" ".join(str(v) for v in P.flatten()[:12]))
    with open(os.path.join(root, "gt_poses", f"{seq}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("".join(f"P{j}: {calib}\n" for j in range(4)))


class FrameRecorder:
    """Wraps DFVO.run_frame: host synchronisations of each frame (CUDA sync
    debug mode; none are counted on the CPU) and each tracked frame's mode,
    valid keypoints and inliers, read after the frame so the read is not
    counted."""

    def __init__(self):
        from dfvo_torch.pipeline.dfvo import DFVO

        self.cls, self.orig = DFVO, DFVO.run_frame
        self.syncs, self.modes, self.counts, self.where = [], [], [], {}
        rec = self

        def run_frame(vo, img_id, img=None):
            import warnings

            on_card = vo.device.type == "cuda"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if on_card:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    mode = rec.orig(vo, img_id, img=img)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(0)
            found = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
                     if "called a synchronizing CUDA operation" in str(w.message)]
            rec.syncs.append(len(found))
            for loc in found:
                rec.where[loc] = rec.where.get(loc, 0) + 1
            if vo.tracking_stage > 1:
                out = vo.cur_data["vo_out"]
                mode_i, valid, inliers = torch.stack(
                    [out["mode"].long(), out["kp_valid"].sum(), out["inliers"].sum()]).tolist()
                rec.modes.append(mode_i)
                rec.counts.append((valid, inliers))
            return mode

        DFVO.run_frame = run_frame

    def close(self):
        self.cls.run_frame = self.orig


def relative_pose(global_poses, i):
    """Frame i's pose relative to frame i - 1 from the chained global
    poses (float64): the inverse of update_global_pose."""
    A, B = global_poses[i - 1].pose, global_poses[i].pose
    return A[:3, :3].T @ B[:3, :3], A[:3, :3].T @ (B[:3, 3] - A[:3, 3])


def run_loop(cfg, device, frames):
    """DFVO(cfg, device).main over ``frames`` frames, recorded."""
    from dfvo_torch.pipeline.dfvo import DFVO

    rec = FrameRecorder()
    try:
        vo = DFVO(cfg, device=device)
        vo.main(num_frames=frames)
    finally:
        rec.close()
    return vo, rec


@phase("run")
def run_phase(seed, smi):
    """The CLI on the card (bf16, drawer on), then the float32 loop on the
    card against the CPU (drawer off)."""
    from dfvo_torch.apis import run as cli
    from dfvo_torch.evaluation import KittiEvalOdom
    from dfvo_torch.utils.io import load_poses_from_txt

    root = os.path.join(ROOT, "build", "chip_smoke", "run")
    data, result = os.path.join(root, "data"), os.path.join(root, "result")
    write_run_sequence(data, seed)
    custom = os.path.join(root, "custom.yml")
    with open(custom, "w") as f:
        f.write(f'seq: "{RUN_SEQ}"\n'
                f"directory: {{img_seq_dir: {data}/odom_data, gt_pose_dir: {data}/gt_poses, "
                f"result_dir: {result}}}\n")
    print(f"  {RUN_FRAMES} frames {RUN_SIZE[1]}x{RUN_SIZE[0]} jpg in {os.path.relpath(data, ROOT)}")

    counters = reset_launch_counts()
    rec = FrameRecorder()
    try:
        t0 = time.perf_counter()
        vo = cli.main(["-d", CFG, "-c", custom, "--no_confirm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    launches = {k: fn.launches for k, fn in counters.items()}
    variants = {k: dict(fn.variant_launches) for k, fn in counters.items()
                if hasattr(fn, "variant_launches")}
    cfg = vo.cfg
    print(f"  {cfg.image.height}x{cfg.image.width} {vo.frontend.dtype}, loader {vo.loader}, "
          f"drawer {'on' if vo.drawer is not None else 'off'}; main() in {wall:.2f} s "
          f"(setup included)")

    traj = load_poses_from_txt(os.path.join(result, f"{RUN_SEQ}.txt"))
    if sorted(traj) != list(range(RUN_FRAMES)) or not all(np.isfinite(p).all()
                                                        for p in traj.values()):
        fail(f"run: {RUN_SEQ}.txt holds frames {sorted(traj)}, expected {RUN_FRAMES} finite poses")
    with open(os.path.join(result, "configuration.yml")) as f:
        if "|CHANGED|" not in f.read():
            fail("run: configuration.yml has no |CHANGED| annotation")
    gt = load_poses_from_txt(os.path.join(data, "gt_poses", f"{RUN_SEQ}.txt"))
    ev = KittiEvalOdom().eval_seq(gt, traj, alignment="6dof")
    if not all(np.isfinite(ev[k]) for k in ("ate", "rpe_m", "rpe_deg")):
        fail(f"run: eval_seq gave ATE {ev['ate']}, RPE {ev['rpe_m']} m / {ev['rpe_deg']} deg")
    tracked = RUN_FRAMES - 1
    expected = {k: tracked * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    print(f"  launches {launches}, expected {expected} ({PER_CALL} per tracked frame, "
          f"{DEPTH_ONLY_CALL} on the first); by variant {variants}")
    if launches != expected:
        fail(f"run launch counts {launches} != {expected}")
    for k, by in variants.items():
        if by[MAIN_VARIANT[k]] != expected[k]:
            fail(f"run: {k} launches by variant {by}, expected all {MAIN_VARIANT[k]}")
    reads = RUN_HOST_READS[vo.drawer is not None]
    print(f"  host reads per frame {rec.syncs} (expected 0, then {reads}), by source line "
          f"{rec.where}; modes {rec.modes}")
    if rec.syncs != [0] + [reads] * tracked:
        fail(f"run: host reads per frame {rec.syncs}, expected 0 then {reads}; "
             f"by source line {rec.where}")
    scopes = ("data_loading", "depth_cnn", "vo_step", "visualization", "DF-VO")
    means = {k: 1e3 * vo.timers.get_mean(k) for k in scopes if k in vo.timers.timers}
    frame_ms = [1e3 * t for t in vo.timers.timers["DF-VO"]["times"]]
    step_ms = [1e3 * t for t in vo.timers.timers["vo_step"]["times"]]
    # steady state: the tracked frames after the first two
    steady = {k: statistics.median(1e3 * t for t in vo.timers.timers[k]["times"][-(tracked - 2):])
              for k in ("vo_step", "visualization", "DF-VO")}
    print("  timer means (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in means.items())
          + f"; DF-VO per frame {[round(t, 2) for t in frame_ms]}; vo_step per tracked "
          f"frame {[round(t, 2) for t in step_ms]}; medians of the last {tracked - 2} "
          + ", ".join(f"{k} {v:.2f}" for k, v in steady.items()))
    print(f"  eval_seq (6dof): ATE {ev['ate']:.4f} m, RPE {ev['rpe_m']:.4f} m / "
          f"{ev['rpe_deg']:.4f} deg over {ev['seq_len']:.2f} m of GT")

    # float32, drawer off: the card against the CPU, each tracked frame's
    # relative pose. The seeded weights' flows are incoherent and under a
    # pixel, so the PnP translation (~2e-5 m on depths of ~0.1 m) is
    # ill-conditioned: the flows' float32 differences (~6e-8 px, card vs
    # CPU convolutions) move it by ~5e-3 of itself, and by 3e-4 to 1.3e-1
    # with other seeds and head scalings (scripts/f32_loop_conditioning.py).
    # F32_T_REL holds it relative to the estimate, so a zero or a doubled
    # translation fails.
    runs = {}
    for device in ("cuda", "cpu"):
        f32 = load_cfg("float32")
        f32.seq = RUN_SEQ
        f32.directory.img_seq_dir = f"{data}/odom_data"
        f32.directory.gt_pose_dir = f"{data}/gt_poses"
        f32.directory.result_dir = os.path.join(root, f"f32_{device}")
        f32.visualization.enable = False
        t0 = time.perf_counter()
        fvo, frec = run_loop(f32, device, PARITY_FRAMES)
        runs[device] = (fvo, frec, time.perf_counter() - t0)
    (cvo, crec, cwall), (hvo, hrec, hwall) = runs["cuda"], runs["cpu"]
    if crec.modes != hrec.modes or crec.counts != hrec.counts:
        fail(f"run f32: card modes {crec.modes}, (valid, inliers) {crec.counts} != "
             f"CPU modes {hrec.modes}, {hrec.counts}")
    worst_rot = worst_t = 0.0
    t_est = []
    for i in range(1, PARITY_FRAMES):
        (Ra, ta), (Rb, tb) = (relative_pose(v.global_poses, i) for v in (cvo, hvo))
        ang, dt, tn = rot_deg(Ra, Rb), float(np.linalg.norm(ta - tb)), float(np.linalg.norm(tb))
        t_est.append(tn)
        worst_rot = max(worst_rot, ang)
        worst_t = max(worst_t, dt / tn if tn > 0 else math.inf)
        if not (ang < 0.01 and tn > 0 and dt <= F32_T_REL * tn):
            fail(f"run f32 frame {i}: card vs CPU rotation {ang:.2e} deg, translation "
                 f"{dt:.2e} on |t| {tn:.2e} (limit {F32_T_REL:g} |t|)")
    if crec.syncs != [0] + [RUN_HOST_READS[False]] * (PARITY_FRAMES - 1):
        fail(f"run f32: host reads per frame {crec.syncs}, expected 0 then "
             f"{RUN_HOST_READS[False]}; by source line {crec.where}")
    print(f"  float32 {PARITY_FRAMES} frames, drawer off: card {cwall:.2f} s, CPU {hwall:.2f} s; "
          f"modes {crec.modes}, (valid, inliers) {crec.counts}; relative |t| "
          f"{[f'{t:.2e}' for t in t_est]} m; worst rotation {worst_rot:.2e} deg, translation "
          f"{worst_t:.2e} of |t| (limit {F32_T_REL:g}); host reads per frame {crec.syncs}")
    resume = resume_check(data, root)
    return {
        "frames": RUN_FRAMES, "size": [cfg.image.height, cfg.image.width],
        "dtype": str(vo.frontend.dtype).replace("torch.", ""), "loader": vo.loader,
        "drawer": vo.drawer is not None,
        "timer_mean_ms": means, "df_vo_ms_per_frame": frame_ms,
        "frames_per_s": 1e3 / means["DF-VO"],
        "steady_median_ms": steady, "vo_step_ms_per_frame": step_ms,
        "host_reads_per_frame": rec.syncs, "modes": rec.modes, "launches": launches,
        "eval_6dof": {"ate_m": ev["ate"], "rpe_m": ev["rpe_m"], "rpe_deg": ev["rpe_deg"]},
        "f32_card_vs_cpu": {"frames": PARITY_FRAMES, "modes": crec.modes,
                            "valid_inliers": crec.counts, "t_norm_m": t_est,
                            "worst_rot_deg": worst_rot, "worst_t_of_t": worst_t,
                            "t_limit_of_t": F32_T_REL, "host_reads_per_frame": crec.syncs},
        "resume": resume, "nvidia_smi": smi,
    }


def resume_check(data, root):
    """A float32 frame run on the card (drawer off) saved with
    ``save_state`` after frame RESUME_AT, loaded into a fresh DFVO and
    continued with ``main(start_frame=RESUME_AT + 1)``, against the straight
    run of RESUME_FRAMES frames: the same poses within RESUME_TOL."""
    from dfvo_torch.pipeline.dfvo import DFVO

    def vo(name):
        cfg = load_cfg("float32")
        cfg.seq = RUN_SEQ
        cfg.directory.img_seq_dir = f"{data}/odom_data"
        cfg.directory.gt_pose_dir = f"{data}/gt_poses"
        cfg.directory.result_dir = os.path.join(root, "resume", name)
        cfg.visualization.enable = False
        return DFVO(cfg, device="cuda")

    straight = vo("straight")
    straight.main(num_frames=RESUME_FRAMES)
    first = vo("first")
    first.main(num_frames=RESUME_AT + 1)
    path = first.save_state(os.path.join(root, "resume", "vo_state"))
    resumed = vo("resumed")
    ref_id = resumed.load_state(path)
    if ref_id != RESUME_AT:
        fail(f"resume: load_state gave ref_id {ref_id}, expected {RESUME_AT}")
    resumed.main(start_frame=ref_id + 1, num_frames=RESUME_FRAMES - RESUME_AT - 1)
    if not (sorted(resumed.global_poses) == sorted(straight.global_poses)
            == list(range(RESUME_FRAMES))):
        fail(f"resume: frames {sorted(resumed.global_poses)} against "
             f"{sorted(straight.global_poses)}")
    worst = max(float(np.abs(resumed.global_poses[i].pose - straight.global_poses[i].pose).max())
                for i in straight.global_poses)
    moved = max(float(np.linalg.norm(p.pose[:3, 3])) for p in straight.global_poses.values())
    print(f"  resume: saved after frame {RESUME_AT}, loaded into a fresh DFVO and continued "
          f"to frame {RESUME_FRAMES - 1}: worst pose difference {worst:.2e} against the "
          f"straight run (limit {RESUME_TOL:g}; the camera moved {moved:.2e} m)")
    if not worst <= RESUME_TOL:
        fail(f"resume: poses {worst:.2e} from the straight run")
    return {"saved_after": RESUME_AT, "frames": RESUME_FRAMES, "worst_pose_diff": worst,
            "moved_m": moved, "limit": RESUME_TOL}


def oracle_chunk(h, w, pairs, seed):
    """bench.py's coherent-motion drive: a rigid scene (synth/oracle.py),
    photometrically consistent frames, and flows corrupted in two
    rectangles that the forward-backward map flags. Returns (K, frames
    [pairs+1,h,w,3], depths [pairs+1,h,w], flows [pairs,h,w,2], diffs
    [pairs,h,w], motions [pairs] T_cur2ref)."""
    from dfvo_torch.synth.oracle import (corrupt_flow, make_oracle_sequence, render_images,
                                         structured_flow_diff)

    K = np.array([[0.58 * w, 0, 0.5 * w], [0, 1.92 * h, 0.5 * h], [0, 0, 1]], np.float32)
    depths, flows, motions = make_oracle_sequence(h, w, K, pairs + 1, seed=seed)
    images = render_images(depths, flows, seed=seed)
    rng = np.random.RandomState(seed + 1)
    diffs, flows_c = [], []
    for f in flows:
        d, bad = structured_flow_diff(rng, h, w, n_bad=2)
        diffs.append(d)
        flows_c.append(corrupt_flow(f, bad, rng))
    return (K, np.stack(images), np.stack(depths), np.stack(flows_c), np.stack(diffs),
            motions)


class ScanRecorder:
    """Wraps DFVO._main_scan (or ``cls.attr``, a loop timed the same way)
    under CUDA sync debug mode and splits its host synchronisations,
    located by source line, at the end of the first frame's depth and of
    each chunk (the ``depth_cnn`` and ``DF-VO`` timers)."""

    def __init__(self, cls=None, attr="_main_scan"):
        import warnings

        from dfvo_torch.utils.timer import Timer

        if cls is None:
            from dfvo_torch.pipeline.dfvo import DFVO as cls
        self.cls, self.attr, self.orig = cls, attr, getattr(cls, attr)
        self.timer, self.orig_end = Timer, Timer.end
        self.caught, self.marks, self.found = None, [], []
        rec = self

        def end(timer, name):
            rec.orig_end(timer, name)
            if name in ("depth_cnn", "DF-VO") and rec.caught is not None:
                rec.marks.append(len(rec.caught))

        def main_scan(vo, *a, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rec.caught = caught
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return rec.orig(vo, *a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    rec.found = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                                 if "called a synchronizing CUDA operation" in str(w.message)
                                 else None for w in caught]
                    rec.caught = None

        Timer.end = end
        setattr(cls, attr, main_scan)

    def windows(self):
        """Host reads before the first chunk, in each chunk, and after."""
        bounds = [0] + self.marks + [len(self.found)]
        return [[f for f in self.found[a:b] if f] for a, b in zip(bounds, bounds[1:])]

    def close(self):
        self.timer.end = self.orig_end
        setattr(self.cls, self.attr, self.orig)


@phase("scan")
def scan_phase(seed, out_dir):
    """The CLI in scan execution on the card (192x640 bf16, chunks of 32,
    drawer on) over SCAN_FRAMES frames; then one chunk_step on the oracle
    drive (the E path) held to the GT, timed and profiled beside the same
    chunk without the oracle (random weights: PnP on every frame), and
    the float32 oracle chunk on the card against the CPU."""
    from dfvo_torch.apis import run as cli
    from dfvo_torch.evaluation import KittiEvalOdom
    from dfvo_torch.pipeline.frontend import DeepFrontend
    from dfvo_torch.pipeline.scan_runner import make_chunk_step
    from dfvo_torch.pipeline.tracking import TRACK_MODE_ESSENTIAL, TrackingConfig
    from dfvo_torch.utils import prng
    from dfvo_torch.utils.io import load_poses_from_txt

    root = os.path.join(ROOT, "build", "chip_smoke", "scan")
    data, result = os.path.join(root, "data"), os.path.join(root, "result")
    write_run_sequence(data, seed, SCAN_FRAMES)
    custom = os.path.join(root, "custom.yml")
    with open(custom, "w") as f:
        f.write(f'seq: "{RUN_SEQ}"\n'
                f"directory: {{img_seq_dir: {data}/odom_data, gt_pose_dir: {data}/gt_poses, "
                f"result_dir: {result}}}\n"
                "tpu: {execution: scan}\n")
    print(f"  {SCAN_FRAMES} frames {RUN_SIZE[1]}x{RUN_SIZE[0]} jpg in {os.path.relpath(data, ROOT)}")

    counters = reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = ScanRecorder()
    try:
        t0 = time.perf_counter()
        vo = cli.main(["-d", CFG, "-c", custom, "--no_confirm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    cli_peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in counters.items()}
    variants = {k: dict(fn.variant_launches) for k, fn in counters.items()
                if hasattr(fn, "variant_launches")}
    cfg = vo.cfg
    chunk = int(cfg.tpu.scan_chunk)
    tracked = SCAN_FRAMES - 1
    n_chunks = math.ceil(tracked / chunk)
    print(f"  {cfg.image.height}x{cfg.image.width} {vo.frontend.dtype}, chunks of {chunk}, "
          f"loader {vo.loader}, drawer {'on' if vo.drawer is not None else 'off'}; main() in "
          f"{wall:.2f} s (setup included); peak memory {cli_peak / 2**30:.2f} GiB")
    if chunk != 32 or str(vo.frontend.dtype) != "torch.bfloat16" or vo.drawer is None:
        fail(f"scan: the default YAML gave chunk {chunk}, {vo.frontend.dtype}, drawer "
             f"{vo.drawer is not None}")

    traj = load_poses_from_txt(os.path.join(result, f"{RUN_SEQ}.txt"))
    if sorted(traj) != list(range(SCAN_FRAMES)) or not all(np.isfinite(p).all()
                                                         for p in traj.values()):
        fail(f"scan: {RUN_SEQ}.txt holds frames {sorted(traj)}, expected {SCAN_FRAMES} "
             "finite poses")
    if vo.tracking_stage != SCAN_FRAMES or not os.path.isfile(os.path.join(result, "map.png")):
        fail(f"scan: tracking_stage {vo.tracking_stage}, map.png written "
             f"{os.path.isfile(os.path.join(result, 'map.png'))}")
    with open(os.path.join(result, "configuration.yml")) as f:
        if "execution: scan  # |CHANGED|" not in f.read():
            fail("scan: configuration.yml does not record tpu.execution: scan")
    gt = load_poses_from_txt(os.path.join(data, "gt_poses", f"{RUN_SEQ}.txt"))
    if not np.allclose(traj[0], gt[0]):
        fail("scan: the trajectory does not start at the GT's first pose")
    ev = KittiEvalOdom().eval_seq(gt, traj, alignment="6dof")
    if not all(np.isfinite(ev[k]) for k in ("ate", "rpe_m", "rpe_deg")):
        fail(f"scan: eval_seq gave ATE {ev['ate']}, RPE {ev['rpe_m']} m / {ev['rpe_deg']} deg")
    expected = {k: n_chunks * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    print(f"  launches {launches}, expected {expected} ({PER_CALL} per chunk, "
          f"{DEPTH_ONLY_CALL} on the first frame); by variant {variants}")
    if launches != expected:
        fail(f"scan launch counts {launches} != {expected}")
    for k, by in variants.items():
        if by[MAIN_VARIANT[k]] != expected[k]:
            fail(f"scan: {k} launches by variant {by}, expected all {MAIN_VARIANT[k]}")
    windows = rec.windows()
    reads = [len(x) for x in windows]
    where = {}
    for loc in (loc for x in windows for loc in x):
        where[loc] = where.get(loc, 0) + 1
    want_reads = [0] + [SCAN_HOST_READS] * n_chunks + [0]
    print(f"  host reads: first frame, each chunk, after: {reads} (expected {want_reads}); "
          f"by source line {where}")
    if reads != want_reads:
        fail(f"scan: host reads {reads}, expected {want_reads}; by source line {where}")
    chunk_ms = [1e3 * t for t in vo.timers.timers["DF-VO"]["times"]]
    scope_ms = {k: 1e3 * sum(vo.timers.timers[k]["times"]) / tracked
                for k in ("data_loading", "vo_step", "visualization", "DF-VO")}
    scope_ms["depth_cnn_first_frame"] = 1e3 * vo.timers.timers["depth_cnn"]["times"][0]
    steady = chunk_ms[1] / chunk
    print("  DF-VO per chunk (ms) " + str([round(t, 2) for t in chunk_ms])
          + "; per tracked frame (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in scope_ms.items())
          + f"; the second (full, warm) chunk {steady:.2f} ms/frame")
    print(f"  eval_seq (6dof): ATE {ev['ate']:.4f} m, RPE {ev['rpe_m']:.4f} m / "
          f"{ev['rpe_deg']:.4f} deg over {ev['seq_len']:.2f} m of GT")

    # one chunk on the oracle drive: the E path
    fe, variables, tcfg = vo.frontend, vo.infer_variables, vo.tcfg
    h, w = cfg.image.height, cfg.image.width
    K, frames, depths, flows, diffs, motions = oracle_chunk(h, w, chunk, seed)
    step, init_depth = make_chunk_step(fe, tcfg)
    dev = torch.device("cuda")
    Kd = torch.from_numpy(K).to(dev)
    Kid = torch.from_numpy(np.linalg.inv(K).astype(np.float32)).to(dev)
    imgs = torch.from_numpy(frames).to(dev)
    keys = torch.from_numpy(prng.step_keys(seed, range(1, chunk + 1)).astype(np.int64)).to(dev)
    oracle = {"depths": torch.from_numpy(depths[1:]).to(dev),
              "flow_fwd": torch.from_numpy(flows).to(dev),
              "flow_diff": torch.from_numpy(diffs).to(dev)}
    eye = torch.eye(4, device=dev)
    carry_oracle = (imgs[0], torch.from_numpy(depths[0]).to(dev), eye, np.float32(1.0))
    carry_net = (imgs[0], init_depth(variables, imgs[0]), eye, np.float32(1.0))
    info = {}

    def e_chunk():
        return step(variables, imgs[1:], carry_oracle, keys, Kd, Kid, oracle=oracle, info=info)

    def pnp_chunk():
        return step(variables, imgs[1:], carry_net, keys, Kd, Kid)

    counters = reset_launch_counts()
    poses, modes, _ = e_chunk()
    per_chunk = {k: fn.launches for k, fn in counters.items()}
    if per_chunk != PER_CALL:
        fail(f"scan chunk_step launches {per_chunk} != {PER_CALL}")
    poses = poses.cpu().numpy().astype(np.float64)
    errs = []
    for i, T_gt in enumerate(motions):
        ang = rot_deg(poses[i][:3, :3], T_gt[:3, :3])
        tn = float(np.linalg.norm(T_gt[:3, 3]))
        errs.append((ang, float(np.linalg.norm(poses[i][:3, 3] - T_gt[:3, 3])) / tn))
    worst_rot, worst_t = max(e[0] for e in errs), max(e[1] for e in errs)
    print(f"  oracle chunk: modes {modes.tolist()}, worst rotation {worst_rot:.3e} deg, "
          f"translation {worst_t:.3e} of |t_gt| (bounds 0.1 deg, 0.05 |t|)")
    if not (modes == TRACK_MODE_ESSENTIAL).all() or worst_rot >= 0.1 or worst_t >= 0.05:
        fail(f"scan oracle chunk: modes {modes.tolist()}, rotation {worst_rot:.3e} deg, "
             f"translation {worst_t:.3e} of |t|")
    pnp_modes = pnp_chunk()[1]

    result_t = {}
    for name, fn in (("e_path", e_chunk), ("pnp_every_frame", pnp_chunk)):
        syncs = count_syncs(fn)
        if syncs != 1:
            fail(f"scan chunk_step ({name}): {syncs} host syncs, expected 1 (the decision)")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_cuda(fn, reps=1, rounds=5)
        prof = profile_call(fn, f"chunk_step_{name}", out_dir)
        result_t[name] = {"ms_per_chunk": ms, "ms_per_frame": ms / chunk, "host_syncs": syncs,
                          "peak_mem_gib": peak / 2**30, **prof}
        print(f"  chunk_step {name}: {ms:.2f} ms per chunk of {chunk}, {ms / chunk:.3f} ms/frame "
              f"(CUDA events, median); {prof['kernels']} kernels, busy "
              f"{100 * prof['busy_share']:.1f} %; peak {peak / 2**30:.2f} GiB above "
              f"{base / 2**30:.2f} GiB", flush=True)
    result_t["pnp_every_frame"]["modes"] = pnp_modes.tolist()

    # float32: the oracle chunk's first pairs on the card and on the CPU
    f32 = load_cfg("float32")
    p = SCAN_PARITY_PAIRS
    outs = {}
    for device in ("cuda", "cpu"):
        fe32 = DeepFrontend(f32, device)
        v32 = fe32.prepare_variables(fe32.init_variables(torch.Generator().manual_seed(seed)))
        step32, _ = make_chunk_step(fe32, TrackingConfig.from_cfg(f32))
        to = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
        t0 = time.perf_counter()
        pz, md, _ = step32(v32, to(frames[1 : p + 1]),
                           (to(frames[0]), to(depths[0]), torch.eye(4, device=device),
                            np.float32(1.0)),
                           to(prng.step_keys(seed, range(1, p + 1)).astype(np.int64)), to(K),
                           to(np.linalg.inv(K).astype(np.float32)),
                           oracle={"depths": to(depths[1 : p + 1]), "flow_fwd": to(flows[:p]),
                                   "flow_diff": to(diffs[:p])})
        outs[device] = (pz.cpu().numpy().astype(np.float64), md, time.perf_counter() - t0)
    (pc, mc, tc), (ph, mh, th) = outs["cuda"], outs["cpu"]
    par_rot = par_t = 0.0
    for i in range(p):
        ang = rot_deg(pc[i][:3, :3], ph[i][:3, :3])
        tn = float(np.linalg.norm(ph[i][:3, 3]))
        par_rot = max(par_rot, ang)
        par_t = max(par_t, float(np.linalg.norm(pc[i][:3, 3] - ph[i][:3, 3])) / tn)
    print(f"  float32 oracle chunk of {p}: card {tc:.2f} s, CPU {th:.2f} s; modes {mc.tolist()}; "
          f"worst rotation {par_rot:.2e} deg, translation {par_t:.2e} of |t| "
          f"(limits 0.01 deg, {SCAN_T_REL:g} |t|)")
    if mc.tolist() != mh.tolist() or not (mc == TRACK_MODE_ESSENTIAL).all() \
            or par_rot >= 0.01 or par_t > SCAN_T_REL:
        fail(f"scan f32 card vs CPU: modes {mc.tolist()} / {mh.tolist()}, rotation "
             f"{par_rot:.2e} deg, translation {par_t:.2e} of |t|")
    return {
        "frames": SCAN_FRAMES, "chunk": chunk, "chunks": n_chunks,
        "size": [h, w], "dtype": str(fe.dtype).replace("torch.", ""), "loader": vo.loader,
        "drawer": vo.drawer is not None, "df_vo_ms_per_chunk": chunk_ms,
        "ms_per_tracked_frame": scope_ms, "df_vo_steady_ms_per_frame": steady,
        "frames_per_s": 1e3 / scope_ms["DF-VO"], "host_reads": reads,
        "host_reads_by_line": where, "launches": launches, "cli_peak_mem_gib": cli_peak / 2**30,
        "eval_6dof": {"ate_m": ev["ate"], "rpe_m": ev["rpe_m"], "rpe_deg": ev["rpe_deg"]},
        "oracle_modes": modes.tolist(), "oracle_worst_rot_deg": worst_rot,
        "oracle_worst_t_of_t": worst_t, "chunk_step": result_t,
        "f32_card_vs_cpu": {"pairs": p, "modes": mc.tolist(), "worst_rot_deg": par_rot,
                            "worst_t_of_t": par_t, "t_limit_of_t": SCAN_T_REL},
    }


def ft_cases(chk, n=2, depth=True, shapes=None):
    """Every kernel at every shape of one finetuning update (float32;
    ``shapes`` as ``main_path_shapes`` gives them, 192x640 by default;
    LiteFlowNet N = ``n``, depth N = 1 where ``depth``). Each case is a
    dict: kernel, label, the Function, the plain version, the kernel
    wrapper, the tensor inputs, the other arguments, calls per update, the
    forward and backward bounds, the library forward and backward (the head
    conv's cuDNN calls), and the backward kernel's wrapper and its plain
    version."""
    from dfvo_torch.ops.correlation import (CorrelationFunction, correlation_backward_plain,
                                            correlation_plain)
    from dfvo_torch.ops.headconv import (HeadConvFunction, head_conv_backward_cuda,
                                         head_conv_backward_plain, head_conv_cuda,
                                         head_conv_plain)
    from dfvo_torch.ops.pallas_corr import correlation_backward_cuda, correlation_cuda

    corr_shapes, reg_shapes, lfn_heads, depth_heads = shapes or (
        CORR_SHAPES, REG_SHAPES, LFN_HEADS, DEPTH_HEADS)
    cases = []
    for lvl, (h, w, c) in corr_shapes:
        # levels 3 and 2 read the stride-2 view of the level's features
        f1 = chk.randn((n, 2 * h, 2 * w, c))[:, ::2, ::2] if lvl <= 3 else chk.randn((n, h, w, c))
        f2 = chk.randn((n, h, w, c))
        io = 4 * (2 * n * h * w * c + n * h * w * 49)
        ops = 2 * n * h * w * 49 * c
        cases.append(dict(
            kernel="correlation", label=f"L{lvl} [{n}, {h}, {w}, {c}]", fn=CorrelationFunction,
            plain=correlation_plain, kfn=correlation_cuda, ins=(f1, f2), rest=(3, 1), calls=1,
            fwd_bound=bound(io, ops, PEAK_F32),
            # read f1, f2 and the cotangent, write both gradients; two
            # products per tap and channel
            bwd_bound=bound(io + 4 * 2 * n * h * w * c, 2 * ops, PEAK_F32),
            lib_fwd=None, lib_bwd=None, bwd_kfn=correlation_backward_cuda,
            bwd_plain=correlation_backward_plain))
    for lvl, (h, w), k in reg_shapes:
        cases.append(reg_ft_case(chk, f"L{lvl} k{k} [{n}, {h}, {w}]", n, h, w, k))
    heads = [(name, (n, *hwc), cout, k, pre, 2) for name, hwc, cout, k, pre in lfn_heads]
    heads += [(name, (1, *hwc), cout, k, pre, 1) for name, hwc, cout, k, pre in depth_heads
              if depth]
    for name, (nn_, h, w, cin), cout, k, pre, calls in heads:
        x = chk.randn((nn_, h, w, cin))
        w_oihw = chk.randn((cout, cin, k, k), 1.0 / math.sqrt(k * k * cin))
        bias = chk.randn((cout,), 0.1)
        pad = 0 if pre else (k - 1) // 2
        oh, ow = h - 2 * ((k - 1) // 2 - pad), w - 2 * ((k - 1) // 2 - pad)
        x_b, g_b, w_b = 4 * nn_ * h * w * cin, 4 * nn_ * oh * ow * cout, 4 * k * k * cin * cout
        ops = 2 * nn_ * oh * ow * k * k * cin * cout

        def lib_fwd(x=x, w=w_oihw, b=bias, pad=pad):
            return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, b, padding=pad)

        def lib_bwd(x=x, w=w_oihw, pad=pad, g=chk.randn((nn_, oh, ow, cout)).permute(0, 3, 1, 2)):
            return torch.ops.aten.convolution_backward(
                g, x.permute(0, 3, 1, 2), w, [w.shape[0]], [1, 1], [pad, pad], [1, 1],
                False, [0, 0], 1, [True, True, True])
        cases.append(dict(
            kernel="head_conv", label=f"{name} [{nn_}, {h}, {w}, {cin}]", fn=HeadConvFunction,
            plain=head_conv_plain, kfn=head_conv_cuda,
            ins=(x, w_oihw.permute(2, 3, 1, 0), bias), rest=(pre,), calls=calls,
            fwd_bound=bound(x_b + g_b + w_b + 4 * cout, ops, PEAK_F32),
            # read x, the weights and the cotangent, write the three
            # gradients; the input and weight gradients each as many
            # products as the forward
            bwd_bound=bound(2 * x_b + g_b + 2 * w_b + 4 * cout, 2 * ops, PEAK_F32),
            lib_fwd=lib_fwd, lib_bwd=lib_bwd, bwd_kfn=head_conv_backward_cuda,
            bwd_plain=head_conv_backward_plain))
    return cases


def reg_ft_case(chk, label, n, h, w, k, raw=None, cot=None):
    """The filter's case of ``ft_cases`` (raw logits drawn unless given;
    ``cot``: the cotangent to use, drawn by ``ft_kernel_checks`` if None)."""
    from dfvo_torch.ops.regfilter import (RegDistFilterFunction, reg_dist_filter_backward_cuda,
                                          reg_dist_filter_backward_plain, reg_dist_filter_cuda,
                                          reg_dist_filter_plain)

    kk = k * k
    raw = chk.randn((n, h, w, kk), 2.0) if raw is None else raw
    ins = (raw, chk.randn((n, h, w, 2), 4.0), chk.randn((1, kk, 1, 1)), chk.randn((1,)),
           chk.randn((1, kk, 1, 1)), chk.randn((1,)))
    io = 4 * (n * h * w * (kk + 4) + 2 * kk + 2)
    ops = n * h * w * (11 * kk + 6)
    return dict(
        kernel="reg_dist_filter", label=label, fn=RegDistFilterFunction,
        plain=reg_dist_filter_plain, kfn=reg_dist_filter_cuda, ins=ins, rest=(k,), calls=1,
        fwd_bound=bound(io, ops, PEAK_F32),
        # read raw, the flow, the cotangent and the parameters once, write a
        # gradient of each input; the operations counted as twice the
        # forward's
        bwd_bound=bound(4 * (n * h * w * (2 * kk + 6) + 4 * kk + 4), 2 * ops, PEAK_F32),
        lib_fwd=None, lib_bwd=None, bwd_kfn=reg_dist_filter_backward_cuda,
        bwd_plain=reg_dist_filter_backward_plain, cot=cot)


def reg_ft_edge_cases(chk, n=2, h=96, w=320, k=7):
    """The filter's case at the update's level 2 three more times for
    ``ft_kernel_checks``: with ties at the minimal |raw| (at every pixel the
    minimal tap j and tap j + 1 set to its negation, and at every other
    column tap j + 2 set to it too: the bias's cotangent goes to the tied
    taps in equal parts), and with cotangents that are not contiguous: the
    permuted view of an [N,2,H,W] tensor and an expanded one (stride 0, as
    autograd hands on the cotangent of a sum), which the kernel reads
    through their strides."""
    kk = k * k
    raw = chk.randn((n, h, w, kk), 2.0)
    j = raw.abs().argmin(dim=-1, keepdim=True)
    v = torch.gather(raw, -1, j)
    raw.scatter_(-1, (j + 1) % kk, -v)
    third = (j + 2) % kk
    every_other = (torch.arange(w, device=raw.device) % 2 == 0).view(1, 1, w, 1)
    raw.scatter_(-1, third, torch.where(every_other, v, torch.gather(raw, -1, third)))
    sq = raw * raw
    ties = (sq == sq.amin(dim=-1, keepdim=True)).sum(dim=-1)
    if not (ties.min().item() >= 2 and ties.max().item() == 3):
        fail(f"finetune reg_dist_filter: the tie case has {ties.min().item()} to "
             f"{ties.max().item()} tied taps per pixel, expected 2 and 3")
    label = f"L2 k{k} [{n}, {h}, {w}]"
    return [reg_ft_case(chk, f"{label} ties", n, h, w, k, raw=raw),
            reg_ft_case(chk, f"{label} permuted cot", n, h, w, k,
                        cot=chk.randn((n, 2, h, w)).permute(0, 2, 3, 1)),
            reg_ft_case(chk, f"{label} expanded cot", n, h, w, k,
                        cot=chk.randn((1, 1, 1, 2)).expand(n, h, w, 2))]


def ft_bwd_bf16(case, cot):
    """The case's backward kernel in bf16 against its plain version in
    float32 on the same bf16-rounded inputs and cotangent: |got - ref| <=
    2e-2 |ref| (the gradient's rounding to bf16) + 1e-4 max(1, max |ref|)
    (summation order). Returns the largest error."""
    ins = [t.bfloat16() for t in case["ins"]]
    g = cot.bfloat16()
    needs = (True,) * len(ins)
    counter = backward_counts()[case["kernel"]]
    before = counter.dtype_launches[torch.bfloat16]
    got = case["bwd_kfn"](g, *ins, *case["rest"], needs=needs)
    if counter.dtype_launches[torch.bfloat16] != before + 1:
        fail(f"finetune {case['kernel']} {case['label']}: the bf16 backward kernel did not "
             "launch once")
    ref = case["bwd_plain"](g.float(), *[t.float() for t in ins], *case["rest"], needs=needs)
    if case["kernel"] == "head_conv":
        same_bits(case, case["bwd_kfn"](g, *ins, *case["rest"], needs=needs)[1:], got[1:], "bf16")
    elif case["kernel"] == "reg_dist_filter":
        same_bits(case, case["bwd_kfn"](g, *ins, *case["rest"], needs=needs), got, "bf16")
    worst = 0.0
    for i, (a, r) in enumerate(zip(got, ref)):
        if a.dtype != torch.bfloat16:
            fail(f"finetune {case['kernel']} {case['label']}: bf16 gradient {i} is {a.dtype}")
        err = (a.float() - r).abs()
        excess = (err - 2e-2 * r.abs()).max().item()
        scale = max(1.0, r.abs().max().item())
        torch.cuda.synchronize()
        if not excess <= 1e-4 * scale:
            fail(f"finetune {case['kernel']} {case['label']}: bf16 gradient {i} exceeds "
                 f"2e-2 |ref| by {excess:.3e}")
        worst = max(worst, err.max().item())
    return worst


def same_bits(case, again, first, what):
    """The outputs of two launches (the head conv's weight and bias
    gradients, the filter's gradients, the cost volume: their partials are
    summed in a fixed order, with no atomics): equal bit for bit."""
    if not all(torch.equal(a, b) for a, b in zip(again, first)):
        fail(f"finetune {case['kernel']} {case['label']}: {what} outputs differ between two "
             "launches")


def ft_kernel_checks(cases):
    """Each case through its Function on the card (the float32 kernel, then
    the backward: the backward kernel, launched once) against autograd of
    the plain version on the same inputs and cotangent (the case's ``cot``,
    or drawn): the output within 1e-4·max(1, |ref|) and each input gradient
    within 1e-4·max(1, |ref|); then each backward kernel in bf16
    (``ft_bwd_bf16``). Returns {kernel: (forward err, backward err)} and
    the worst bf16 backward error per kernel."""
    counters = launch_counts()
    bwd = backward_counts()
    worst = {k: [0.0, 0.0] for k in PER_CALL}
    worst_bf16 = {k: 0.0 for k in bwd}
    for case in cases:
        kernel, label, fn_cls, plain = case["kernel"], case["label"], case["fn"], case["plain"]
        ins, rest = case["ins"], case["rest"]
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        before = dict(counters[kernel].variant_launches)
        calls = fn_cls.backward_calls
        bwd_before = bwd[kernel].dtype_launches[torch.float32]
        out = fn_cls.apply(*leaves, *rest)
        after = counters[kernel].variant_launches
        ran = [v for v in after if after[v] != before[v]]
        if ran != [FT_VARIANT[kernel]]:
            fail(f"finetune {kernel} {label}: ran {ran}, not {FT_VARIANT[kernel]}")
        cot = torch.randn_like(out) if case.get("cot") is None else case["cot"]
        grads = torch.autograd.grad(out, leaves, cot)
        if fn_cls.backward_calls != calls + 1:
            fail(f"finetune {kernel} {label}: the Function's backward did not run")
        launched = bwd[kernel].dtype_launches[torch.float32] - bwd_before
        if launched != 1:
            fail(f"finetune {kernel} {label}: the backward kernel launched {launched} times "
                 "in one backward pass, expected 1")
        ref_leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        ref = plain(*ref_leaves, *rest)
        ref_grads = torch.autograd.grad(ref, ref_leaves, cot)
        errs = []
        for name, got, want in [("out", out, ref)] + [
                (f"grad {i}", g, r) for i, (g, r) in enumerate(zip(grads, ref_grads))]:
            err = (got.detach() - want.detach()).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            if not err <= 1e-4 * scale:
                fail(f"finetune {kernel} {label}: {name} max abs err {err:.3e} > "
                     f"{1e-4 * scale:.3e}")
            errs.append(err)
        if kernel == "head_conv":
            needs = (True,) * len(ins)
            first = case["bwd_kfn"](cot, *ins, *rest, needs=needs)[1:]
            same_bits(case, case["bwd_kfn"](cot, *ins, *rest, needs=needs)[1:], first, "f32")
        elif kernel == "reg_dist_filter":
            same_bits(case, case["bwd_kfn"](cot, *ins, *rest), case["bwd_kfn"](cot, *ins, *rest),
                      "f32 backward")
        else:
            with torch.no_grad():
                same_bits(case, [case["kfn"](*ins, *rest)], [case["kfn"](*ins, *rest)],
                          "f32 forward")
        worst[kernel][0] = max(worst[kernel][0], errs[0])
        worst[kernel][1] = max(worst[kernel][1], max(errs[1:]))
        e16 = ft_bwd_bf16(case, cot)
        worst_bf16[kernel] = max(worst_bf16[kernel], e16)
        print(f"  {kernel:16s} {label:34s} f32 {FT_VARIANT[kernel]}: out err {errs[0]:.2e}, "
              f"input grads err {max(errs[1:]):.2e} (backward kernel); bf16 backward kernel "
              f"ok, max abs err {e16:.2e}; "
              + {"head_conv": "dW, db", "reg_dist_filter": "gradients",
                 "correlation": "out"}[kernel] + " equal bit for bit over two launches",
              flush=True)
    return worst, worst_bf16


def ft_kernel_times(cases, per="update"):
    """Device ms (torch.profiler) of each case's float32 kernel forward and
    of its backward kernel, beside the plain forward, the plain version's
    VJP (autograd of the recomputed forward), the library calls and the
    bounds; summed per ``per``."""
    rows = []
    for case in cases:
        kernel, label, plain, kfn = case["kernel"], case["label"], case["plain"], case["kfn"]
        ins, rest, calls = case["ins"], case["rest"], case["calls"]
        bfwd, bbwd, lfwd, lbwd, bkfn = (case[k] for k in (
            "fwd_bound", "bwd_bound", "lib_fwd", "lib_bwd", "bwd_kfn"))
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        cot = torch.randn_like(plain(*ins, *rest))

        def vjp(leaves=leaves, plain=plain, rest=rest, cot=cot):
            with torch.enable_grad():
                return torch.autograd.grad(plain(*leaves, *rest), leaves, cot)

        with torch.no_grad():
            row = {"kernel": kernel, "shape": label, "per_update": calls,
                   "fwd_ms": device_ms(lambda: kfn(*ins, *rest), label=f"{label} fwd"),
                   "plain_fwd_ms": device_ms(lambda: plain(*ins, *rest), reps=3,
                                             label=f"{label} plain fwd"),
                   "library_fwd_ms": device_ms(lfwd, label=f"{label} library fwd")
                   if lfwd else None,
                   "library_bwd_ms": device_ms(lbwd, label=f"{label} library bwd")
                   if lbwd else None,
                   "fwd_bound_ms": bfwd[0], "fwd_bound_by": bfwd[1],
                   "bwd_bound_ms": bbwd[0], "bwd_bound_by": bbwd[1],
                   "bwd_ms": device_ms(lambda: bkfn(cot, *ins, *rest), label=f"{label} bwd")}
        row["plain_bwd_ms"] = device_ms(vjp, reps=3, label=f"{label} plain bwd")
        rows.append(row)
        lf = "none" if lfwd is None else f"{row['library_fwd_ms']:.4f}"
        lb = "none" if lbwd is None else f"{row['library_bwd_ms']:.4f}"
        print(f"  {kernel:16s} {label:32s} fwd {row['fwd_ms']:.4f} (bound {bfwd[0]:.4f} "
              f"{bfwd[1]}, plain {row['plain_fwd_ms']:.4f}, library {lf})  bwd "
              f"{row['bwd_ms']:.4f} (bound {bbwd[0]:.4f} {bbwd[1]}, "
              f"plain VJP {row['plain_bwd_ms']:.4f}, library {lb})  x{calls}", flush=True)
    sums = {}
    for name in sorted({r["kernel"] for r in rows}, key=list(PER_CALL).index):
        mine = [r for r in rows if r["kernel"] == name]

        def tot(key, mine=mine):
            vals = [r[key] for r in mine]
            return None if None in vals else sum(r["per_update"] * v for r, v in zip(mine, vals))

        def by(key, mine=mine):
            b = sum(r["per_update"] * r[f"{key}_bound_ms"] for r in mine
                    if r[f"{key}_bound_by"] == "bytes")
            return "bytes" if b >= tot(f"{key}_bound_ms") / 2 else "operations"

        sums[name] = {"launches_per_update": sum(r["per_update"] for r in mine),
                      "fwd_ms": tot("fwd_ms"), "plain_fwd_ms": tot("plain_fwd_ms"),
                      "fwd_bound_ms": tot("fwd_bound_ms"), "fwd_bound_by": by("fwd"),
                      "library_fwd_ms": tot("library_fwd_ms"),
                      "bwd_ms": tot("bwd_ms"),
                      "plain_bwd_ms": tot("plain_bwd_ms"), "bwd_bound_ms": tot("bwd_bound_ms"),
                      "bwd_bound_by": by("bwd"), "library_bwd_ms": tot("library_bwd_ms")}
        s = sums[name]
        print(f"  per {per}, {name}: {s['launches_per_update']} launches; forward "
              f"{s['fwd_ms']:.4f} ms (bound {s['fwd_bound_ms']:.4f}, {s['fwd_bound_by']}); "
              f"backward {s['bwd_ms']:.4f} ms (bound "
              f"{s['bwd_bound_ms']:.4f}, {s['bwd_bound_by']}; plain VJP "
              f"{s['plain_bwd_ms']:.4f} ms)", flush=True)
    return rows, sums


def ft_config(root, data, result, execution):
    """A custom YAML: ablation_self_flow_online.yml's options, depth
    finetuning on (the default's scales, pose_src DF-VO), save_model, the
    sequence and the directories."""
    import yaml

    with open(ABLATION_CFG) as f:
        custom = yaml.safe_load(f)
    custom["online_finetune"]["save_model"] = True
    custom["online_finetune"]["depth"] = {"enable": True}
    custom["seq"] = RUN_SEQ
    custom["directory"] = {"img_seq_dir": f"{data}/odom_data",
                           "gt_pose_dir": f"{data}/gt_poses", "result_dir": result}
    if execution == "scan":
        custom["tpu"] = {"execution": "scan"}
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"custom_{execution}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(custom, f)
    return path


class LossRecorder:
    """Keeps the loss tensor of every finetuning update (read after the
    run, so the reads are not counted)."""

    def __init__(self):
        from dfvo_torch.pipeline.finetune import OnlineFinetuner

        self.cls, self.orig, self.losses = OnlineFinetuner, OnlineFinetuner.value_and_grad, []
        rec = self

        def value_and_grad(ft, *a, **kw):
            loss, grads = rec.orig(ft, *a, **kw)
            rec.losses.append(loss)
            return loss, grads

        OnlineFinetuner.value_and_grad = value_and_grad

    def close(self):
        self.cls.value_and_grad = self.orig


def check_bwd_launches(label, r, want):
    """The backward kernels of a finetuning CLI run: each launched once per
    backward pass of its Function (``want`` of them per kernel), all in
    float32."""
    got = r["bwd_launches"]
    print(f"  {label}: backward-kernel launches {got}, Function backward passes "
          f"{r['backward_calls']}, by dtype {r['bwd_dtypes']}")
    for k in got:
        if not (got[k] == r["backward_calls"][k] == want[k]
                and r["bwd_dtypes"][k]["float32"] == want[k]):
            fail(f"{label}: {k} backward kernel launched {got[k]} times ({r['bwd_dtypes'][k]}), "
                 f"Function backward passes {r['backward_calls'][k]}, expected {want[k]}")


def cli_run(seed, root, execution, frames, custom):
    """The CLI with the custom YAML ``custom`` over ``frames`` frames of a
    sequence written under ``root``/data, recorded (``recorded_cli``)."""
    write_run_sequence(os.path.join(root, "data"), seed, frames)
    return recorded_cli(execution, custom)


def recorded_cli(execution, custom):
    """The CLI with the default YAML and ``custom``, recorded: host reads,
    launches of the kernels and of the backward kernels, Function backward
    passes, losses, peak memory."""
    from dfvo_torch.apis import run as cli
    from dfvo_torch.ops.correlation import CorrelationFunction
    from dfvo_torch.ops.headconv import HeadConvFunction
    from dfvo_torch.ops.regfilter import RegDistFilterFunction

    functions = {"correlation": CorrelationFunction, "reg_dist_filter": RegDistFilterFunction,
                 "head_conv": HeadConvFunction}
    for fn in functions.values():
        fn.backward_calls = 0
    counters = reset_launch_counts()
    bwd = backward_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = FrameRecorder() if execution == "frame" else ScanRecorder()
    losses = LossRecorder()
    try:
        t0 = time.perf_counter()
        vo = cli.main(["-d", CFG, "-c", custom, "--no_confirm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.close()
        losses.close()
    return {"vo": vo, "wall": wall, "peak": torch.cuda.max_memory_allocated(), "rec": rec,
            "losses": torch.stack(losses.losses).cpu().numpy() if losses.losses else np.zeros(0),
            "launches": {k: fn.launches for k, fn in counters.items()},
            "variants": {k: dict(fn.variant_launches) for k, fn in counters.items()},
            "disp_launches": dict(counters["correlation"].disp_launches),
            "backward_calls": {k: fn.backward_calls for k, fn in functions.items()},
            "bwd_launches": {k: fn.launches for k, fn in bwd.items()},
            "bwd_disp_launches": dict(bwd["correlation"].disp_launches),
            "bwd_dtypes": {k: {str(d)[6:]: v for d, v in fn.dtype_launches.items()}
                           for k, fn in bwd.items()}}


def ft_cli_run(seed, execution, frames):
    """The CLI with the finetuning YAML over ``frames`` frames of the run
    phase's sequence, recorded (``cli_run``)."""
    root = os.path.join(ROOT, "build", "chip_smoke", "finetune", execution)
    data, result = os.path.join(root, "data"), os.path.join(root, "result")
    r = cli_run(seed, root, execution, frames, ft_config(root, data, result, execution))
    r["result"] = result
    return r


def ft_check_cli(r, execution, frames):
    """The finetuning CLI run's checks; returns its summary."""
    from dfvo_torch.utils.io import load_poses_from_txt

    vo = r["vo"]
    cfg = vo.cfg
    ft = vo.finetuner
    tracked = frames - 1
    if ft is None or ft.num_frames is not None or not (ft.train_flow and ft.train_depth) \
            or list(cfg.online_finetune.flow.scales) != [1, 2, 3, 4, 5] \
            or list(cfg.online_finetune.depth.scales) != [0, 1, 2, 3]:
        fail(f"finetune {execution}: the configuration did not take "
             f"(num_frames {None if ft is None else ft.num_frames})")
    if vo.finetune_cnt != tracked or vo.opt_state["count"] != tracked:
        fail(f"finetune {execution}: finetune_cnt {vo.finetune_cnt}, Adam count "
             f"{vo.opt_state['count']}, expected {tracked}")
    traj = load_poses_from_txt(os.path.join(r["result"], f"{RUN_SEQ}.txt"))
    if sorted(traj) != list(range(frames)) or not all(np.isfinite(p).all()
                                                    for p in traj.values()):
        fail(f"finetune {execution}: {sorted(traj)} poses, expected {frames} finite")
    if not os.path.isfile(os.path.join(r["result"], "finetuned_model", "variables.pt")):
        fail(f"finetune {execution}: no finetuned_model/variables.pt")
    losses = r["losses"]
    if len(losses) != tracked or not np.isfinite(losses).all():
        fail(f"finetune {execution}: {len(losses)} losses, finite "
             f"{bool(np.isfinite(losses).all())}, expected {tracked}")
    init = vo.frontend.init_variables(torch.Generator().manual_seed(int(cfg.seed)))
    moved = {net: max((vo.variables[net][k].cpu() - init[net][k]).abs().max().item()
                      for k in vo.frontend.trainable_keys(net)) for net in ("flow", "depth")}
    stats_fixed = all(torch.equal(vo.variables["depth"][k].cpu(), init["depth"][k])
                      for k in init["depth"] if k.endswith(("running_mean", "running_var")))
    # Adam moves a weight by about lr per update
    if not (0.5 * FT_LR < min(moved.values()) and max(moved.values()) < 3 * FT_LR * tracked
            and stats_fixed):
        fail(f"finetune {execution}: weights moved {moved}, running statistics fixed "
             f"{stats_fixed}")
    if execution == "frame":
        infer = {k: tracked * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    else:
        n_chunks = math.ceil(tracked / int(cfg.tpu.scan_chunk))
        infer = {k: n_chunks * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    want_ft = {k: tracked * FT_PER_UPDATE[k] for k in PER_CALL}
    launches_ft = {k: r["launches"][k] - infer[k] for k in PER_CALL}
    print(f"  launches {r['launches']} = inference {infer} + updates {launches_ft} "
          f"(expected {want_ft}); by variant {r['variants']}; Function backward passes "
          f"{r['backward_calls']}")
    if launches_ft != want_ft or r["backward_calls"] != want_ft:
        fail(f"finetune {execution}: update launches {launches_ft}, backward passes "
             f"{r['backward_calls']}, expected {want_ft}")
    check_bwd_launches(f"finetune {execution}", r, want_ft)
    for k in ("correlation", "head_conv"):
        by = r["variants"][k]
        if by["tensor_core"] != infer[k] or by[FT_VARIANT[k]] != want_ft[k]:
            fail(f"finetune {execution}: {k} by variant {by}, expected {infer[k]} "
                 f"tensor_core (inference) and {want_ft[k]} {FT_VARIANT[k]} (updates)")
    if execution == "frame":
        reads = RUN_HOST_READS[vo.drawer is not None]
        syncs, where = r["rec"].syncs, r["rec"].where
        if syncs != [0] + [reads] * tracked:
            fail(f"finetune frame: host reads per frame {syncs}, expected 0 then {reads}; "
                 f"by source line {where}")
    else:
        windows = r["rec"].windows()
        syncs = [len(x) for x in windows]
        where = {}
        for loc in (loc for x in windows for loc in x):
            where[loc] = where.get(loc, 0) + 1
        n_chunks = math.ceil(tracked / int(cfg.tpu.scan_chunk))
        # after the last chunk: one read, the finetuned model's download
        if syncs != [0] + [SCAN_HOST_READS] * n_chunks + [1]:
            fail(f"finetune scan: host reads {syncs}, expected 0, {SCAN_HOST_READS} per chunk, "
                 f"1 (the saved model); by source line {where}")
    times = vo.timers.timers
    per_frame = {k: 1e3 * sum(times[k]["times"]) / tracked
                 for k in ("data_loading", "vo_step", "finetune", "visualization", "DF-VO")
                 if k in times}
    print(f"  {execution}: {frames} frames, {tracked} updates, main() in {r['wall']:.2f} s; "
          f"per tracked frame (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in per_frame.items())
          + f"; losses {losses[0]:.4f} .. {losses[-1]:.4f}; weights moved "
          f"{ {k: f'{v:.2e}' for k, v in moved.items()} }; host reads {syncs} by source line "
          f"{where}; peak memory {r['peak'] / 2**30:.2f} GiB", flush=True)
    # one update per tracked frame: per_frame["finetune"] is ms per update
    return {"frames": frames, "updates": tracked, "ms_per_tracked_frame": per_frame,
            "host_reads": syncs, "host_reads_by_line": where, "launches": r["launches"],
            "launches_finetune": launches_ft, "backward_calls": r["backward_calls"],
            "bwd_launches": r["bwd_launches"],
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "weights_moved_max": moved, "peak_mem_gib": r["peak"] / 2**30}


def ft_update_setup(device, seed, cfg):
    from dfvo_torch.pipeline.finetune import OnlineFinetuner
    from dfvo_torch.pipeline.frontend import DeepFrontend

    fe = DeepFrontend(cfg, device)
    ft = OnlineFinetuner(fe, cfg)
    variables = {net: {k: v.to(device) for k, v in sd.items()}
                 for net, sd in fe.init_variables(torch.Generator().manual_seed(seed)).items()}
    h, w = cfg.image.height, cfg.image.width
    K = np.array([[0.58 * w, 0, 0.5 * w], [0, 1.92 * h, 0.5 * h], [0, 0, 1]], np.float32)
    state = ft.init_state(variables, K, np.linalg.inv(K))
    frames = make_frames(seed, 2, h, w)
    img_ref, img_cur = (torch.from_numpy(f).to(device).float() / 255.0 for f in frames)
    pose = np.eye(4, dtype=np.float32)
    c, s_ = math.cos(0.01), math.sin(0.01)
    pose[:3, :3] = [[c, 0, s_], [0, 1, 0], [-s_, 0, c]]
    pose[:3, 3] = [0.02, 0.0, 0.5]  # metres of the DF-VO pose (/5.4 in network units)
    return ft, variables, state, img_ref, img_cur, torch.from_numpy(pose).to(device)


def ft_one_update(device, seed, cfg, perturb=0.0):
    """(loss, gradients, Adam steps of the weights, seconds) of one update
    from the seeded weights, on the host; ``perturb`` scales a relative
    random change of the current image."""
    ft, variables, state, a, b, pose = ft_update_setup(device, seed, cfg)
    if perturb:
        gen = torch.Generator().manual_seed(seed + 1)
        b = b * (1 + perturb * torch.randn(b.shape, generator=gen).to(device))
    before = {net: {k: t.detach().cpu().clone() for k, t in sd.items()}
              for net, sd in ft._trainable(variables).items()}
    t0 = time.perf_counter()
    loss, grads = ft.value_and_grad(variables, a[None], b[None], pose[None])
    ft.optimizer.update(grads, state, ft._trainable(variables))
    loss = float(loss)
    return (loss, {n: {k: g.cpu() for k, g in sd.items()} for n, sd in grads.items()},
            {n: {k: variables[n][k].cpu() - before[n][k] for k in sd}
             for n, sd in before.items()}, time.perf_counter() - t0)


def ft_compare(got, want):
    """The loss's relative error, and per network the gradient's relative
    error by norm (the whole network, and the median and worst tensor) and
    the share of the moving weights (|step| > lr/2) whose Adam step has
    the same sign."""
    (lc, gc, sc, _), (lh, gh, sh, _) = got, want
    out = {"loss_rel": abs(lc - lh) / abs(lh)}
    for net in gc:
        a = torch.cat([g.ravel() for g in gc[net].values()]).double()
        b = torch.cat([g.ravel() for g in gh[net].values()]).double()
        per = sorted(((gc[net][k] - gh[net][k]).norm() / gh[net][k].norm()).item()
                     for k in gh[net] if gh[net][k].norm() > 0)
        st_c = torch.cat([v.ravel() for v in sc[net].values()])
        st_h = torch.cat([v.ravel() for v in sh[net].values()])
        moving = st_h.abs() > 0.5 * FT_LR
        out[net] = {"grad_rel": ((a - b).norm() / b.norm()).item(),
                    "grad_rel_per_tensor_median": per[len(per) // 2],
                    "grad_rel_per_tensor_max": per[-1],
                    "step_same_sign_share": (torch.sign(st_c[moving])
                                             == torch.sign(st_h[moving])).float().mean().item(),
                    "step_max_abs_diff": (st_c - st_h).abs().max().item()}
    return out


def ft_card_vs_cpu(seed, cfg):
    """One update at 192x640 in float32 on the card, with TF32 off and with
    cuDNN's TF32 convolutions (PyTorch's default, as the CLIs ran), against
    the CPU, for each network that ``cfg`` finetunes."""
    tf32 = torch.backends.cudnn.allow_tf32
    runs = {}
    try:
        for name, on in (("card_tf32_off", False), ("card", True)):
            torch.backends.cudnn.allow_tf32 = on
            runs[name] = ft_one_update("cuda", seed, cfg)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    runs["cpu"] = ft_one_update("cpu", seed, cfg)
    runs["cpu_perturbed"] = ft_one_update("cpu", seed, cfg, perturb=1e-6)
    out = {"loss_cpu": runs["cpu"][0], "cpu_s": runs["cpu"][3]}
    nets = list(runs["cpu"][1])  # the finetuned networks
    for name, limits in (("cpu_perturbed", None), ("card_tf32_off", FT_F32_LIMITS),
                         ("card", FT_TF32_LIMITS)):
        c = out[name] = ft_compare(runs[name], runs["cpu"])
        c["loss"], c["seconds"] = runs[name][0], runs[name][3]
        print(f"  {name} vs CPU, one update at {cfg.image.height}x{cfg.image.width} float32: "
              f"loss {c['loss']:.7f} / {runs['cpu'][0]:.7f} (rel {c['loss_rel']:.2e}); "
              f"{c['seconds']:.2f} s / {runs['cpu'][3]:.2f} s; " + "; ".join(
                  f"{net}: gradient rel {c[net]['grad_rel']:.2e} (per tensor median "
                  f"{c[net]['grad_rel_per_tensor_median']:.2e}, max "
                  f"{c[net]['grad_rel_per_tensor_max']:.2e}), Adam step same sign "
                  f"{100 * c[net]['step_same_sign_share']:.2f} %, max diff "
                  f"{c[net]['step_max_abs_diff']:.2e}" for net in nets)
              + f"; limits {limits}", flush=True)
        if limits is None:  # the CPU's own sensitivity: a yardstick, no check
            continue
        if not c["loss_rel"] <= limits["loss_rel"]:
            fail(f"finetune {name} vs CPU: loss {c['loss']} vs {runs['cpu'][0]}")
        for net in nets:
            if not (c[net]["grad_rel"] <= limits[f"{net}_grad_rel"]
                    and c[net]["step_same_sign_share"] >= limits[f"{net}_same_sign"]):
                fail(f"finetune {name} vs CPU, {net}: {c[net]}")
    return out


def ft_update_times(seed, cfg, out_dir):
    """CUDA-event medians of one update, split into the loss forward, the
    backward and the Adam step; the chunk update per pair; kernels, busy
    share and peak memory of one update."""
    ft, variables, state, a, b, pose = ft_update_setup("cuda", seed, cfg)

    def split():
        """OnlineFinetuner.update with events between its three parts."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        masters = ft._trainable(variables)
        leaves = {n: {k: t.detach().requires_grad_(True) for k, t in sd.items()}
                  for n, sd in masters.items()}
        flat = [(n, k, t) for n, sd in leaves.items() for k, t in sd.items()]
        ev[0].record()
        with torch.enable_grad():
            loss = ft.loss_fn(leaves, variables, a[None], b[None], pose[None])
            ev[1].record()
            got = torch.autograd.grad(loss, [t for *_, t in flat], allow_unused=True)
        grads = {n: {} for n in leaves}
        for (n, k, t), g in zip(flat, got):
            grads[n][k] = torch.zeros_like(t) if g is None else g
        ev[2].record()
        ft.optimizer.update(grads, state, masters)
        ev[3].record()
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    for _ in range(2):
        split()
    samples = [split() for _ in range(5)]
    fwd, bwd, adam = (statistics.median(x[i] for x in samples) for i in range(3))
    update_ms = time_cuda(lambda: ft.update(variables, state, a, b, pose), reps=1, rounds=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ft.update(variables, state, a, b, pose)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    syncs = count_syncs(lambda: ft.update(variables, state, a, b, pose))
    if syncs:
        fail(f"finetune update: {syncs} host syncs, expected none")
    prof = profile_call(lambda: ft.update(variables, state, a, b, pose), "finetune_update",
                        out_dir)
    frames = torch.from_numpy(make_frames(seed, FT_CHUNK_PAIRS + 1, cfg.image.height,
                                          cfg.image.width)).cuda()
    poses = pose.expand(FT_CHUNK_PAIRS, 4, 4).contiguous()
    chunk_update = ft.make_chunk_update_fn()
    chunk_ms = time_cuda(lambda: chunk_update(variables, state, frames, poses, FT_CHUNK_PAIRS),
                         reps=1, rounds=3)
    out = {"update_ms": update_ms, "forward_ms": fwd, "backward_ms": bwd, "adam_ms": adam,
           "chunk_update_ms_per_pair": chunk_ms / FT_CHUNK_PAIRS, "host_syncs": syncs,
           "peak_mem_gib": peak / 2**30, "kernels": prof["kernels"],
           "busy_share": prof["busy_share"], "device_busy_ms": prof["device_busy_ms"],
           "top": prof["top"]}
    print(f"  update: {update_ms:.2f} ms (CUDA events, median; forward {fwd:.2f}, backward "
          f"{bwd:.2f}, Adam {adam:.2f}); chunk update {chunk_ms / FT_CHUNK_PAIRS:.2f} ms per "
          f"pair over {FT_CHUNK_PAIRS}; {prof['kernels']} kernels per update, busy "
          f"{100 * prof['busy_share']:.1f} %; peak {peak / 2**30:.2f} GiB above "
          f"{base / 2**30:.2f} GiB; {syncs} host syncs", flush=True)
    return out


@phase("finetune")
def finetune_phase(chk, seed, out_dir):
    """Online finetuning on the card: each kernel's Function at every
    finetuning shape against the plain version's autograd (and each
    backward kernel in bf16; the filter's also on ties and on cotangents
    that are not contiguous), the forward and backward times; the CLI with
    ablation_self_flow_online.yml plus depth finetuning in both executions;
    one update on the card against the CPU; the times."""
    cases = ft_cases(chk)
    errs, errs_bf16 = ft_kernel_checks(cases + reg_ft_edge_cases(chk))
    rows, sums = ft_kernel_times(cases)
    # the networks at PyTorch's defaults from here on: cuDNN's TF32
    # convolutions on, float32 matmuls in float32 (the geometry's highp)
    torch.backends.cudnn.allow_tf32 = True
    try:
        cli = {}
        for execution, frames in (("frame", FT_FRAMES), ("scan", FT_SCAN_FRAMES)):
            r = ft_cli_run(seed, execution, frames)
            cli[execution] = ft_check_cli(r, execution, frames)
        from dfvo_torch.utils import ConfigLoader

        cfg = ConfigLoader().merge_cfg([CFG, ABLATION_CFG])
        cfg.online_finetune.depth.enable = True
        parity = ft_card_vs_cpu(seed, cfg)
        times = ft_update_times(seed, cfg, out_dir)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return {"kernel_errs": errs, "bwd_kernel_errs_bf16": errs_bf16, "kernel_rows": rows,
            "kernel_sums": sums, "cli": cli, "card_vs_cpu": parity, "update": times}


def ext_config(root, data, result, execution, finetune=True, edit=None):
    """A custom YAML: kitti_stereo_train_extend.yml's options (with or
    without its online finetuning), the sequence and the directories, and
    ``edit``'s changes."""
    import yaml

    with open(EXTEND_CFG) as f:
        custom = yaml.safe_load(f)
    custom["online_finetune"]["enable"] = finetune
    custom["seq"] = RUN_SEQ
    custom["directory"] = {"img_seq_dir": f"{data}/odom_data",
                           "gt_pose_dir": f"{data}/gt_poses", "result_dir": result}
    custom["tpu"] = {"execution": execution}
    if edit:
        edit(custom)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"custom_{execution}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(custom, f)
    return path


def ext_check_cli(r, execution, frames, result):
    """The extend CLI run's checks (the configuration, the trajectory, one
    update per tracked frame, launches, host reads); returns its summary."""
    from dfvo_torch.utils.io import load_poses_from_txt

    vo = r["vo"]
    cfg, ft, tcfg = vo.cfg, vo.finetuner, vo.tcfg
    tracked = frames - 1
    if (cfg.image.height, cfg.image.width) != EXT_SIZE or tcfg.scale_method != "iterative" \
            or tcfg.kp_method != "local_bestN" or str(vo.frontend.dtype) != "torch.bfloat16" \
            or ft is None or not ft.train_flow or ft.train_depth \
            or list(cfg.online_finetune.flow.scales) != [1, 2, 3, 4, 5]:
        fail(f"extend {execution}: the configuration did not take")
    if vo.finetune_cnt != tracked:
        fail(f"extend {execution}: {vo.finetune_cnt} updates, expected {tracked}")
    traj = load_poses_from_txt(os.path.join(result, f"{RUN_SEQ}.txt"))
    if sorted(traj) != list(range(frames)) or not all(np.isfinite(p).all()
                                                    for p in traj.values()):
        fail(f"extend {execution}: {sorted(traj)} poses, expected {frames} finite")
    losses = r["losses"]
    if len(losses) != tracked or not np.isfinite(losses).all():
        fail(f"extend {execution}: {len(losses)} losses, expected {tracked} finite")
    if execution == "frame":
        n_calls = tracked
    else:
        n_calls = math.ceil(tracked / int(cfg.tpu.scan_chunk))
    infer = {k: n_calls * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    want_ft = {k: tracked * EXT_FT_PER_UPDATE[k] for k in PER_CALL}
    launches_ft = {k: r["launches"][k] - infer[k] for k in PER_CALL}
    print(f"  launches {r['launches']} = inference {infer} + updates {launches_ft} "
          f"(expected {want_ft}); by variant {r['variants']}")
    if launches_ft != want_ft:
        fail(f"extend {execution}: update launches {launches_ft}, expected {want_ft}")
    check_bwd_launches(f"extend {execution}", r, want_ft)
    for k in ("correlation", "head_conv"):
        by = r["variants"][k]
        if by["tensor_core"] != infer[k] or by[FT_VARIANT[k]] != want_ft[k]:
            fail(f"extend {execution}: {k} by variant {by}, expected {infer[k]} "
                 f"tensor_core and {want_ft[k]} {FT_VARIANT[k]}")
    if execution == "frame":
        reads = RUN_HOST_READS[vo.drawer is not None]
        syncs, where = r["rec"].syncs, r["rec"].where
        modes = r["rec"].modes
        if syncs != [0] + [reads] * tracked:
            fail(f"extend frame: host reads per frame {syncs}, expected 0 then {reads}; "
                 f"by source line {where}")
    else:
        windows = r["rec"].windows()
        syncs = [len(x) for x in windows]
        where = {}
        for loc in (loc for x in windows for loc in x):
            where[loc] = where.get(loc, 0) + 1
        modes = None
        if syncs != [0] + [SCAN_HOST_READS] * n_calls + [0]:
            fail(f"extend scan: host reads {syncs}, expected 0, {SCAN_HOST_READS} per chunk, 0; "
                 f"by source line {where}")
    times = vo.timers.timers
    per_frame = {k: 1e3 * sum(times[k]["times"]) / tracked
                 for k in ("data_loading", "vo_step", "finetune", "visualization", "DF-VO")
                 if k in times}
    # DF-VO ms of each tracked frame (frame execution) or chunk (scan)
    df_vo = [1e3 * t for t in times["DF-VO"]["times"]]
    print(f"  {execution}: {frames} frames at {EXT_SIZE[1]}x{EXT_SIZE[0]}, {tracked} updates, "
          f"main() in {r['wall']:.2f} s; per tracked frame (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_frame.items())
          + f"; DF-VO per {'frame' if execution == 'frame' else 'chunk'} (ms) "
          + str([round(t, 2) for t in df_vo])
          + f"; modes {modes}; losses {losses[0]:.4f} .. {losses[-1]:.4f}; host reads {syncs} "
          f"by source line {where}; peak memory {r['peak'] / 2**30:.2f} GiB", flush=True)
    return {"frames": frames, "updates": tracked, "ms_per_tracked_frame": per_frame,
            "df_vo_ms": df_vo,
            "modes": modes, "host_reads": syncs, "host_reads_by_line": where,
            "launches": r["launches"], "launches_finetune": launches_ft,
            "bwd_launches": r["bwd_launches"],
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "peak_mem_gib": r["peak"] / 2**30}


def ext_iterative_scenes():
    """The iterative step (iterative scale, the E and PnP trackers'
    iterative keypoints) on the track scenes at 370x1226 on the card,
    held to the JAX tests' bounds and to the CPU; its host syncs (one, the
    PnP decision), time and kernels on the E scene."""
    import dataclasses

    from dfvo_torch.pipeline.tracking import TrackingConfig

    h, w = EXT_SIZE
    # KITTI odometry's left camera (RUN_CALIB) at 1226x370
    K = np.array([[718.856 * w / RUN_SIZE[1], 0, 607.1928 * w / RUN_SIZE[1]],
                  [0, 718.856 * h / RUN_SIZE[0], 185.2157 * h / RUN_SIZE[0]], [0, 0, 1]],
                 np.float32)
    tcfg = dataclasses.replace(
        TrackingConfig(height=h, width=w, depth_crop=((0.0, 1.0), (0.0, 1.0)), max_depth=50.0,
                       scale_max_trials=1024), **EXT_ITERATIVE)
    scenes = track_scenes(h, w, K)
    out = {}
    for name in ("essential", "planar", "spike"):
        inputs, T_gt = scenes[name]
        got = to_numpy(track_call(inputs, "cuda", tcfg, K=K)())
        want = to_numpy(track_call(inputs, "cpu", tcfg, K=K)())
        res = check_track_bounds(name, got, inputs, T_gt)
        res.update(mode=int(got["mode"]), scale=float(got["scale"]),
                   card_vs_cpu=compare_track(name, got, want,
                                             inliers_by_count=name != "essential"))
        out[name] = res
        print(f"  iterative step, {name} scene at {w}x{h}: mode {res['mode']} scale "
              f"{res['scale']:.4f}; card vs CPU "
              f"{({k: f'{v:.2e}' for k, v in res['card_vs_cpu'].items()})}", flush=True)
    fn = track_call(scenes["essential"][0], "cuda", tcfg, K=K)
    syncs = count_syncs(fn)
    if syncs != 1:
        fail(f"extend: the iterative tracking_step made {syncs} host syncs, expected 1")
    return out, fn, syncs


@phase("extend")
def extend_phase(chk, seed, out_dir):
    """The extended paper's configuration at 370x1226: each kernel against
    its plain version at its shapes there and their times (and LiteFlowNet's
    alone at N = 2, the flow export's); the flow finetuning's Functions at
    the feed against the plain version's autograd; the CLI with
    finetuning in frame and scan execution; the iterative step on the card
    against the CPU (track scenes; bench.py's oracle drive through one
    chunk); the pose CNN (deep_pose tracking, depth consistency); the
    bestN and sampled selectors through one chunk; and the timings,
    kernels and busy share of the frame step, the chunk step and one
    update."""
    import dataclasses

    from dfvo_torch.pipeline import tracking as tracking_mod
    from dfvo_torch.pipeline.dfvo import frame_step
    from dfvo_torch.pipeline.frontend import DeepFrontend
    from dfvo_torch.pipeline.scan_runner import make_chunk_step
    from dfvo_torch.pipeline.tracking import TRACK_MODE_ESSENTIAL
    from dfvo_torch.utils import ConfigLoader, prng

    cfg = ConfigLoader().merge_cfg([CFG, EXTEND_CFG])
    fe = DeepFrontend(cfg, "cuda")
    shapes = main_path_shapes(fe.flow_feed, fe.depth_feed)
    print(f"  {cfg.image.width}x{cfg.image.height}: LiteFlowNet feed {fe.flow_feed}, depth "
          f"feed {fe.depth_feed} (multiples of 32; the disparity is resized to the image)")
    check_main_path_shapes(chk, shapes, suffix=f" @{EXT_SIZE[1]}x{EXT_SIZE[0]}")
    rows, sums = kernel_times(timing_cases(chk, shapes))
    # the flow export (generate_flow_prediction, KITTI flow's 375x1242 fed
    # at the same 384x1248): LiteFlowNet alone on one pair, N = 2
    export_rows, export_sums = kernel_times(
        timing_cases(chk, (*shapes[:3], ()), batches=((2, 1, (6, 5, 4, 3, 2)),)),
        per=f"flow export pair (N = 2, {fe.flow_feed[1]}x{fe.flow_feed[0]})")
    # the flow finetuning's Functions at this feed (N = 2, the flow heads),
    # and their forward and backward times per update
    ft = ft_cases(chk, shapes=shapes, depth=False)
    ft_errs, ft_errs_bf16 = ft_kernel_checks(ft)
    ft_rows, ft_sums = ft_kernel_times(
        ft, per=f"flow update (N = 2, {fe.flow_feed[1]}x{fe.flow_feed[0]})")

    result = {"size": list(EXT_SIZE), "flow_feed": list(fe.flow_feed),
              "depth_feed": list(fe.depth_feed), "kernel_rows": rows, "kernel_sums": sums,
              "flow_export_kernel_rows": export_rows, "flow_export_kernel_sums": export_sums,
              "ft_kernel_errs": ft_errs, "ft_bwd_kernel_errs_bf16": ft_errs_bf16,
              "ft_kernel_rows": ft_rows, "ft_kernel_sums": ft_sums}
    base = os.path.join(ROOT, "build", "chip_smoke", "extend")
    cli = {}
    for execution, frames in (("frame", EXT_FRAMES), ("scan", EXT_SCAN_FRAMES)):
        root = os.path.join(base, execution)
        data, res_dir = os.path.join(root, "data"), os.path.join(root, "result")
        custom = ext_config(root, data, res_dir, execution)
        r = cli_run(seed, root, execution, frames, custom)
        cli[execution] = ext_check_cli(r, execution, frames, res_dir)
        if execution == "frame":
            vo_frame = r["vo"]
    result["cli"] = cli

    # the iterative step on the card against the CPU
    result["iterative_scenes"], track_fn, track_syncs = ext_iterative_scenes()

    # the frame step, one update and the chunk step at 370x1226: time,
    # kernels, busy share, host syncs
    vo = vo_frame
    variables, tcfg = vo.infer_variables, vo.tcfg
    img_ref, depth_ref = vo.ref_data["img_dev"], vo.ref_data["raw_depth_dev"]
    key = prng.fold_in(prng.PRNGKey(vo.cfg.seed), EXT_FRAMES)
    eye = torch.eye(4, device="cuda")

    def one_frame():
        return frame_step(vo.frontend, tcfg, variables, img_ref, img_ref, depth_ref, eye, key,
                          vo.K, vo.K_inv, 1.0)

    unit = img_ref.float() / 255.0
    pose = torch.eye(4, device="cuda")
    pose[2, 3] = 0.5

    def one_update():
        return vo.finetuner.update(vo.variables, vo.opt_state, unit, unit, pose)

    steps = {}
    for name, fn, want_syncs in (("tracking_step_iterative", track_fn, 1),
                                 ("frame_step", one_frame, 1), ("update", one_update, 0)):
        syncs = count_syncs(fn)
        if syncs != want_syncs:
            fail(f"extend {name}: {syncs} host syncs, expected {want_syncs}")
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        ms = time_cuda(fn, reps=1, rounds=5)
        prof = profile_call(fn, f"extend_{name}", out_dir)
        steps[name] = {"ms": ms, "host_syncs": syncs, "peak_mem_gib": peak, **prof}
        print(f"  {name} at {EXT_SIZE[1]}x{EXT_SIZE[0]}: {ms:.2f} ms (CUDA events, median), "
              f"{syncs} host syncs, {prof['kernels']} kernels, busy "
              f"{100 * prof['busy_share']:.1f} %, peak {peak:.2f} GiB above the resident",
              flush=True)

    # bench.py's oracle drive through one chunk: the iterative chunk step
    # with the networks in full, held to the GT; then the bestN and sampled
    # selectors through the same chunk
    h, w = EXT_SIZE
    chunk = int(cfg.tpu.scan_chunk)
    K, frames, depths, flows, diffs, motions = oracle_chunk(h, w, chunk, seed)
    dev = torch.device("cuda")
    to = (lambda a, d=dev: torch.from_numpy(np.ascontiguousarray(a)).to(d))
    Kd, Kid = to(K), to(np.linalg.inv(K).astype(np.float32))
    imgs = to(frames)
    keys = to(prng.step_keys(seed, range(1, chunk + 1)).astype(np.int64))
    oracle = {"depths": to(depths[1:]), "flow_fwd": to(flows), "flow_diff": to(diffs)}
    carry = (imgs[0], to(depths[0]), eye, np.float32(1.0))
    chunks = {}
    for kp_method in ("local_bestN", "bestN", "sampled"):
        tc = dataclasses.replace(tcfg, kp_method=kp_method)
        step, _ = make_chunk_step(vo.frontend, tc)
        info = {}

        def run_chunk(step=step, info=info):
            return step(variables, imgs[1:], carry, keys, Kd, Kid, oracle=oracle, info=info)

        counters = reset_launch_counts()
        poses, modes, new_carry = run_chunk()
        launches = {k: fn.launches for k, fn in counters.items()}
        if launches != PER_CALL:
            fail(f"extend chunk ({kp_method}): launches {launches} != {PER_CALL}")
        poses = poses.cpu().numpy().astype(np.float64)
        if not np.isfinite(poses).all():
            fail(f"extend chunk ({kp_method}): non-finite poses")
        errs = [(rot_deg(poses[i][:3, :3], T[:3, :3]),
                 float(np.linalg.norm(poses[i][:3, 3] - T[:3, 3]) / np.linalg.norm(T[:3, 3])))
                for i, T in enumerate(motions)]
        worst_rot, worst_t = max(e[0] for e in errs), max(e[1] for e in errs)
        entry = {"modes": modes.tolist(), "worst_rot_deg": worst_rot, "worst_t_of_t": worst_t,
                 "scale_carry": float(new_carry[3])}
        print(f"  oracle chunk of {chunk} at {w}x{h}, {kp_method}: modes {modes.tolist()}; "
              f"worst rotation {worst_rot:.3e} deg, translation {worst_t:.3e} of |t_gt|",
              flush=True)
        if kp_method == "local_bestN":
            if not (modes == TRACK_MODE_ESSENTIAL).all() or worst_rot >= 0.1 or worst_t >= 0.05:
                fail(f"extend oracle chunk: modes {modes.tolist()}, rotation {worst_rot:.3e} "
                     f"deg, translation {worst_t:.3e} of |t| (bounds 0.1 deg, 0.05 |t|)")
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            syncs = count_syncs(run_chunk)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
            if syncs != 1:
                fail(f"extend chunk_step: {syncs} host syncs, expected 1 (the decision)")
            ms = time_cuda(run_chunk, reps=1, rounds=2)
            prof = profile_call(run_chunk, "extend_chunk_step", out_dir)
            entry.update(ms_per_chunk=ms, ms_per_frame=ms / chunk, host_syncs=syncs,
                         peak_mem_gib=peak, **prof)
            print(f"  chunk_step (iterative, oracle) at {w}x{h}: {ms:.2f} ms per chunk of "
                  f"{chunk}, {ms / chunk:.3f} ms/frame; {syncs} host sync, {prof['kernels']} "
                  f"kernels, busy {100 * prof['busy_share']:.1f} %, peak {peak:.2f} GiB",
                  flush=True)
        chunks[kp_method] = entry
    result["oracle_chunk"] = chunks

    # the iterative chunk's tracking (iterative scale and keypoints) on the
    # card against the CPU (float32, a network stub of zeros: with the
    # oracle the networks add nothing)
    class Zeros:
        def __init__(self, device):
            self.device = device

        def infer_chunk(self, variables, all_imgs):
            m = all_imgs.shape[0] - 1
            z = torch.zeros((m, h, w), device=self.device)
            return {"depths": z, "flow_fwd": torch.zeros((m, h, w, 2), device=self.device),
                    "flow_diff": z}

    p = SCAN_PARITY_PAIRS
    outs = {}
    tc_iter = dataclasses.replace(tcfg, **EXT_ITERATIVE)
    for device in ("cuda", "cpu"):
        step, _ = make_chunk_step(Zeros(device), tc_iter)
        t0 = time.perf_counter()
        pz, md, _ = step(None, to(frames[1 : p + 1], device),
                         (to(frames[0], device), to(depths[0], device),
                          torch.eye(4, device=device), np.float32(1.0)),
                         to(prng.step_keys(seed, range(1, p + 1)).astype(np.int64), device),
                         to(K, device), to(np.linalg.inv(K).astype(np.float32), device),
                         oracle={"depths": to(depths[1 : p + 1], device),
                                 "flow_fwd": to(flows[:p], device),
                                 "flow_diff": to(diffs[:p], device)})
        outs[device] = (pz.cpu().numpy().astype(np.float64), md, time.perf_counter() - t0)
    (pc, mc, tc_), (ph, mh, th) = outs["cuda"], outs["cpu"]
    par_rot = max(rot_deg(pc[i][:3, :3], ph[i][:3, :3]) for i in range(p))
    par_t = max(float(np.linalg.norm(pc[i][:3, 3] - ph[i][:3, 3]) / np.linalg.norm(ph[i][:3, 3]))
                for i in range(p))
    print(f"  iterative chunk of {p} (float32 tracking, oracle, iterative keypoints too): "
          f"card {tc_:.2f} s, CPU "
          f"{th:.2f} s; modes {mc.tolist()}; worst rotation {par_rot:.2e} deg, translation "
          f"{par_t:.2e} of |t| (limits 0.01 deg, {SCAN_T_REL:g} |t|)", flush=True)
    if mc.tolist() != mh.tolist() or not (mc == TRACK_MODE_ESSENTIAL).all() \
            or par_rot >= 0.01 or par_t > SCAN_T_REL:
        fail(f"extend iterative chunk card vs CPU: modes {mc.tolist()} / {mh.tolist()}, "
             f"rotation {par_rot:.2e} deg, translation {par_t:.2e} of |t|")
    result["iterative_chunk_card_vs_cpu"] = {"pairs": p, "modes": mc.tolist(),
                                             "worst_rot_deg": par_rot, "worst_t_of_t": par_t}

    # the pose CNN through a few frames of frame execution (drawer off)
    calls = []
    real_dc = tracking_mod.compute_depth_consistency

    def spy(*args):
        calls.append(1)
        return real_dc(*args)

    pose_runs = {}
    for method in ("deep_pose", "hybrid"):
        def edit(custom, method=method):
            custom["deep_pose"] = {"enable": True}
            custom["tracking_method"] = method
            custom["visualization"] = {"enable": False}
            if method == "hybrid":
                custom["kp_selection"]["depth_consistency"] = {"enable": True}

        root = os.path.join(base, f"pose_{method}")
        data, res_dir = os.path.join(root, "data"), os.path.join(root, "result")
        custom = ext_config(root, data, res_dir, "frame", finetune=False, edit=edit)
        tracking_mod.compute_depth_consistency = spy
        try:
            r = cli_run(seed, root, "frame", EXT_POSE_FRAMES, custom)
        finally:
            tracking_mod.compute_depth_consistency = real_dc
        from dfvo_torch.utils.io import load_poses_from_txt

        traj = load_poses_from_txt(os.path.join(res_dir, f"{RUN_SEQ}.txt"))
        tracked = EXT_POSE_FRAMES - 1
        modes, syncs = r["rec"].modes, r["rec"].syncs
        want_calls = tracked if method == "hybrid" else 0
        expected = {k: tracked * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
        print(f"  pose CNN, tracking_method {method}"
              f"{' + depth consistency' if method == 'hybrid' else ''}: modes {modes}, host "
              f"reads {syncs}, depth-consistency maps {len(calls)}, launches {r['launches']}, "
              f"{1e3 * r['wall'] / EXT_POSE_FRAMES:.1f} ms/frame with setup", flush=True)
        if sorted(traj) != list(range(EXT_POSE_FRAMES)) \
                or not all(np.isfinite(q).all() for q in traj.values()) \
                or (method == "deep_pose" and modes != [3] * tracked) \
                or syncs != [0] + [EXT_POSE_READS[method]] * tracked \
                or len(calls) != want_calls or r["launches"] != expected:
            fail(f"extend pose CNN ({method}): poses {sorted(traj)}, modes {modes}, reads "
                 f"{syncs}, depth-consistency maps {len(calls)}, launches {r['launches']}")
        calls.clear()
        pose_runs[method] = {"modes": modes, "host_reads": syncs,
                             "launches": r["launches"]}
    result["pose_cnn"] = pose_runs
    result["steps"] = steps
    result["launches"] = {k: cli["frame"]["launches"][k] + cli["scan"]["launches"][k]
                          for k in PER_CALL}
    return result


# HD3 (hd3 phase): default_configuration.yml with deep_flow.network: hd3 at
# its 192x640 (HD3's feed: multiples of 64, 192x640 itself), bf16. Per
# network call: the cost volume at D = 4 at HD3's five levels and the depth
# network's four disparity heads; an update (flow only) launches the five
# cost volumes in float32
HD3_PER_CALL = {"correlation": 5, "reg_dist_filter": 0, "head_conv": 4}
HD3_FT_PER_UPDATE = {"correlation": 5, "reg_dist_filter": 0, "head_conv": 0}
HD3_CHANNELS = (512, 512, 256, 128, 64)
HD3_BATCHES = (2, 64)
# frame execution (drawer on) and scan execution (a full chunk of 32 and a
# padded one); then both with flow finetuning at scales 1-5, HD3_FT_PAIRS
# updates each
HD3_FRAMES = 8
HD3_SCAN_FRAMES = 1 + 32 + 5
HD3_FT_PAIRS = 3
# card (float32, TF32 off) vs CPU, one 192x640 pair through HD3 infer: depth
# relative, flows in px at all but HD3_FLIP_SHARE of the pixels (a 2x2 block
# whose probabilities tie within rounding is chosen either way, and moves a
# vector by whole units)
HD3_DEPTH_RTOL, HD3_FLOW_ATOL_PX, HD3_FLIP_SHARE = 1e-3, 1e-2, 1e-3


def hd3_corr_shapes(feed):
    """HD3's cost-volume shapes, coarse to fine: level l of the feed at
    1/2^(6-l), with the encoder's channels there."""
    return tuple((l, (feed[0] >> (6 - l), feed[1] >> (6 - l), c))
                 for l, c in enumerate(HD3_CHANNELS))


def hd3_variant(c):
    """The variant a bf16 D = 4 launch takes at ``c`` channels."""
    from dfvo_torch.ops.pallas_corr import TC_MAX_CHANNELS

    return "tensor_core" if c <= TC_MAX_CHANNELS else "reg_tile"


def hd3_load_cfg(dtype=None, finetune=False):
    cfg = load_cfg(dtype)
    cfg.deep_flow.network = "hd3"
    if finetune:
        cfg.online_finetune.enable = True
        cfg.online_finetune.flow.enable = True
        cfg.online_finetune.flow.scales = [1, 2, 3, 4, 5]
        cfg.online_finetune.depth.enable = False
    return cfg


def hd3_cases(chk, shapes, n, dtype):
    """The D = 4 cost volume at HD3's five shapes at batch ``n`` in
    ``dtype``, one launch each per network call."""
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda

    size = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_BF16_TC if dtype == torch.bfloat16 else PEAK_F32
    cases = []
    for l, (h, w, c) in shapes:
        f1, f2 = chk.randn((n, h, w, c)).to(dtype), chk.randn((n, h, w, c)).to(dtype)
        cases.append(dict(
            kernel="correlation_d4", shape=f"L{l} [{n}, {h}, {w}, {c}] {str(dtype)[6:]}", n=n,
            per_call=1,
            kfn=lambda f1=f1, f2=f2: correlation_cuda(f1, f2, 4, 1),
            pfn=lambda f1=f1, f2=f2: correlation_plain(f1, f2, 4, 1), lfn=None,
            bound=bound(size * (2 * n * h * w * c + n * h * w * 81),
                        2 * n * h * w * 81 * c, peak)))
    return cases


def hd3_ft_cases(chk, shapes, n=2):
    """The D = 4 cost volume's Function at HD3's five levels in one flow
    update (float32, batch ``n``), as ``ft_cases`` gives its cases."""
    from dfvo_torch.ops.correlation import (CorrelationFunction, correlation_backward_plain,
                                            correlation_plain)
    from dfvo_torch.ops.pallas_corr import correlation_backward_cuda, correlation_cuda

    cases = []
    for l, (h, w, c) in shapes:
        f1, f2 = chk.randn((n, h, w, c)), chk.randn((n, h, w, c))
        io = 4 * (2 * n * h * w * c + n * h * w * 81)
        ops = 2 * n * h * w * 81 * c
        cases.append(dict(
            kernel="correlation", label=f"HD3 L{l} D=4 [{n}, {h}, {w}, {c}]",
            fn=CorrelationFunction, plain=correlation_plain, kfn=correlation_cuda,
            ins=(f1, f2), rest=(4, 1), calls=1, fwd_bound=bound(io, ops, PEAK_F32),
            bwd_bound=bound(io + 4 * 2 * n * h * w * c, 2 * ops, PEAK_F32), lib_fwd=None,
            lib_bwd=None, bwd_kfn=correlation_backward_cuda,
            bwd_plain=correlation_backward_plain))
    return cases


def hd3_cli(seed, name, execution, frames, finetune):
    """The CLI with deep_flow.network: hd3 (and flow finetuning at scales
    1-5 for HD3_FT_PAIRS pairs), the default YAML's other options."""
    root = os.path.join(ROOT, "build", "chip_smoke", "hd3", name)
    data, result = os.path.join(root, "data"), os.path.join(root, "result")
    os.makedirs(root, exist_ok=True)
    custom = os.path.join(root, "custom.yml")
    with open(custom, "w") as f:
        f.write(f'seq: "{RUN_SEQ}"\n'
                f"directory: {{img_seq_dir: {data}/odom_data, gt_pose_dir: {data}/gt_poses, "
                f"result_dir: {result}}}\n"
                "deep_flow: {network: hd3}\n"
                f"tpu: {{execution: {execution}}}\n")
        if finetune:
            f.write(f"online_finetune: {{enable: True, num_frames: {HD3_FT_PAIRS}, "
                    "flow: {enable: True, scales: [1, 2, 3, 4, 5]}, depth: {enable: False}}\n")
    r = cli_run(seed, root, execution, frames, custom)
    r["result"] = result
    return r


def hd3_check_cli(r, execution, frames, finetune):
    """An HD3 CLI run's checks: the configuration, the trajectory, the
    launches (all cost volumes at D = 4), the updates, the host reads and
    the timer scopes; returns its summary."""
    from dfvo_torch.utils.io import load_poses_from_txt

    vo = r["vo"]
    cfg, fe = vo.cfg, vo.frontend
    tracked = frames - 1
    label = f"hd3 {execution}{' finetune' if finetune else ''}"
    if fe.flow_kind != "hd3" or fe.flow_feed != (192, 640) or str(fe.dtype) != "torch.bfloat16" \
            or (vo.finetuner is not None) != finetune:
        fail(f"{label}: the configuration did not take ({fe.flow_kind}, {fe.flow_feed}, "
             f"{fe.dtype})")
    traj = load_poses_from_txt(os.path.join(r["result"], f"{RUN_SEQ}.txt"))
    if sorted(traj) != list(range(frames)) or not all(np.isfinite(p).all()
                                                    for p in traj.values()):
        fail(f"{label}: {sorted(traj)} poses, expected {frames} finite")
    n_calls = tracked if execution == "frame" else math.ceil(tracked / int(cfg.tpu.scan_chunk))
    updates = min(tracked, HD3_FT_PAIRS) if finetune else 0
    if finetune:
        losses = r["losses"]
        if vo.finetune_cnt != updates or len(losses) != updates or not np.isfinite(losses).all():
            fail(f"{label}: {vo.finetune_cnt} updates, losses {losses}, expected {updates}")
    infer = {k: n_calls * HD3_PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    want = {k: infer[k] + updates * HD3_FT_PER_UPDATE[k] for k in PER_CALL}
    want_ft = {k: updates * HD3_FT_PER_UPDATE[k] for k in PER_CALL}
    tc_levels = sum(hd3_variant(c) == "tensor_core" for c in HD3_CHANNELS)
    want_corr = {"tensor_core": n_calls * tc_levels,
                 "reg_tile": n_calls * (5 - tc_levels) + want_ft["correlation"]}
    print(f"  {label}: launches {r['launches']} (expected {want}: {HD3_PER_CALL} per network "
          f"call, {HD3_FT_PER_UPDATE} per update), by window {r['disp_launches']}, by variant "
          f"{r['variants']}, Function backward passes {r['backward_calls']}")
    if r["launches"] != want or r["disp_launches"] != {3: 0, 4: want["correlation"]} \
            or r["variants"]["correlation"] != want_corr \
            or r["variants"]["head_conv"]["tensor_core"] != infer["head_conv"] \
            or (finetune and r["backward_calls"] != want_ft):
        fail(f"{label}: launches {r['launches']}, by window {r['disp_launches']}, by variant "
             f"{r['variants']}, backward passes {r['backward_calls']}; expected {want}, "
             f"correlation {want_corr}")
    if finetune:
        check_bwd_launches(label, r, want_ft)
        if r["bwd_disp_launches"] != {3: 0, 4: want_ft["correlation"]}:
            fail(f"{label}: backward cost volumes by window {r['bwd_disp_launches']}, expected "
                 f"all {want_ft['correlation']} at D = 4")
    if execution == "frame":
        reads = RUN_HOST_READS[vo.drawer is not None]
        syncs, where = r["rec"].syncs, r["rec"].where
        want_syncs = [0] + [reads] * tracked
    else:
        windows = r["rec"].windows()
        syncs = [len(x) for x in windows]
        where = {}
        for loc in (loc for x in windows for loc in x):
            where[loc] = where.get(loc, 0) + 1
        want_syncs = [0] + [SCAN_HOST_READS] * n_calls + [0]
    if syncs != want_syncs:
        fail(f"{label}: host reads {syncs}, expected {want_syncs}; by source line {where}")
    times = vo.timers.timers
    scopes = {"data_loading", "depth_cnn", "vo_step", "DF-VO"} | ({"finetune"} if finetune
                                                                    else set())
    if vo.drawer is not None:
        scopes.add("visualization")
    if not scopes <= set(times):
        fail(f"{label}: timer scopes {sorted(times)}, expected {sorted(scopes)}")
    per_frame = {k: 1e3 * sum(times[k]["times"]) / tracked for k in sorted(scopes)
                 if k != "depth_cnn"}
    df_vo = [1e3 * t for t in times["DF-VO"]["times"]]
    print(f"  {label}: {frames} frames, main() in {r['wall']:.2f} s; per tracked frame (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_frame.items())
          + f"; DF-VO per {'frame' if execution == 'frame' else 'chunk'} (ms) "
          + str([round(t, 2) for t in df_vo]) + f"; host reads {syncs} by source line {where}; "
          f"peak memory {r['peak'] / 2**30:.2f} GiB", flush=True)
    return {"frames": frames, "updates": updates, "ms_per_tracked_frame": per_frame,
            "df_vo_ms": df_vo, "host_reads": syncs, "host_reads_by_line": where,
            "launches": r["launches"], "d4_launches": r["disp_launches"][4],
            "d4_per_network_call": HD3_PER_CALL["correlation"],
            "bwd_launches": r["bwd_launches"],
            "d4_per_update": HD3_FT_PER_UPDATE["correlation"],
            "variants": r["variants"], "peak_mem_gib": r["peak"] / 2**30}


def hd3_infer_card_vs_cpu(seed):
    """HD3 infer in float32 on the card and on the CPU, one 192x640 pair,
    the seeded weights."""
    from dfvo_torch.pipeline.frontend import DeepFrontend

    cfg = hd3_load_cfg("float32")
    h, w = cfg.image.height, cfg.image.width
    variables = DeepFrontend(cfg, "cpu").init_variables(torch.Generator().manual_seed(seed))
    imgs = torch.from_numpy(make_frames(seed, 2, h, w)).float() / 255.0
    outs = {}
    for device in ("cuda", "cpu"):
        fe = DeepFrontend(cfg, device)
        t0 = time.perf_counter()
        out = fe.infer(fe.prepare_variables(variables), imgs[1].to(device), imgs[0].to(device))
        outs[device] = ({k: v.cpu() for k, v in out.items()}, time.perf_counter() - t0)
    (got, tg), (want, tc) = outs["cuda"], outs["cpu"]
    res = {"depth_cur_rel": ((got["depth_cur"] - want["depth_cur"]).abs()
                             / want["depth_cur"].abs()).max().item()}
    for key in ("flow_fwd", "flow_bwd", "flow_diff"):
        err = (got[key] - want[key]).abs()
        if err.dim() == 3:
            err = err.amax(-1)
        res[key] = {"max_abs_px": err.max().item(),
                    "share_over_atol": (err > HD3_FLOW_ATOL_PX).float().mean().item(),
                    "max_abs_ref_px": want[key].abs().max().item()}
    print(f"  HD3 infer f32, card ({tg:.2f} s) vs CPU ({tc:.2f} s), one {w}x{h} pair: depth "
          f"relative {res['depth_cur_rel']:.2e} (limit {HD3_DEPTH_RTOL:g}); " + "; ".join(
              f"{k} max {v['max_abs_px']:.2e} px on |{v['max_abs_ref_px']:.1f}| px, "
              f"{100 * v['share_over_atol']:.3f} % over {HD3_FLOW_ATOL_PX:g} px"
              for k, v in res.items() if k != "depth_cur_rel")
          + f" (limit {100 * HD3_FLIP_SHARE:g} %)", flush=True)
    if not res["depth_cur_rel"] <= HD3_DEPTH_RTOL or any(
            res[k]["share_over_atol"] > HD3_FLIP_SHARE
            for k in ("flow_fwd", "flow_bwd", "flow_diff")):
        fail(f"hd3 infer card vs CPU: {res}")
    return res


def hd3_time(name, fn, out_dir, chunk=None):
    """CUDA-event ms, kernels, busy share, host syncs and peak memory of
    one call."""
    syncs = count_syncs(fn)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ms = time_cuda(fn, reps=1, rounds=5)
    prof = profile_call(fn, f"hd3_{name}", out_dir)
    out = {"ms": ms, "host_syncs": syncs, "peak_mem_gib": peak,
           **{k: v for k, v in prof.items() if k != "top"}}
    if chunk:
        out["ms_per_frame"] = ms / chunk
    print(f"  {name}: {ms:.2f} ms (CUDA events, median)"
          + (f", {ms / chunk:.3f} ms/frame over {chunk}" if chunk else "")
          + f"; {syncs} host syncs, {prof['kernels']} kernels, busy "
          f"{100 * prof['busy_share']:.1f} %, peak {peak:.2f} GiB above the resident",
          flush=True)
    return out


@phase("hd3")
def hd3_phase(chk, seed, out_dir):
    """HD3 (deep_flow.network: hd3) at 192x640 bf16: the D = 4 cost volume
    at HD3's five shapes against its plain version and its times, and its
    Function with the backward kernel at a flow update's N = 2; infer on
    the card against the CPU; the CLI in both executions, with and without
    flow finetuning; bench.py's oracle drive through one chunk; one update
    on the card against the CPU; the times of infer, infer_chunk,
    frame_step, chunk_step and the update."""
    from dfvo_torch.ops.correlation import correlation_plain
    from dfvo_torch.ops.pallas_corr import correlation_cuda
    from dfvo_torch.pipeline.dfvo import frame_step
    from dfvo_torch.pipeline.scan_runner import make_chunk_step
    from dfvo_torch.pipeline.tracking import TRACK_MODE_ESSENTIAL
    from dfvo_torch.utils import prng

    shapes = hd3_corr_shapes((192, 640))
    for n in HD3_BATCHES:
        for l, (h, w, c) in shapes:
            f1, f2 = chk.randn((n, h, w, c)), chk.randn((n, h, w, c))
            chk.compare("correlation", f"HD3 L{l} D=4 {[n, h, w, c]}",
                        lambda a, b: correlation_cuda(a, b, 4, 1),
                        lambda a, b: correlation_plain(a, b, 4, 1), (f1, f2),
                        expect=hd3_variant(c), record="correlation_d4")
    rows, sums = [], {}
    for per, n, dtype in (("infer_chunk", 64, torch.bfloat16), ("infer", 2, torch.bfloat16),
                          ("update", 2, torch.float32)):
        r, s = kernel_times(hd3_cases(chk, shapes, n, dtype), names=("correlation_d4",),
                            per=f"HD3 {per} network call")
        rows += r
        sums[per] = s["correlation_d4"]
    # the Function of a flow update (N = 2, float32): forward, the backward
    # kernel (and in bf16), against the plain version's autograd; times
    ft = hd3_ft_cases(chk, shapes)
    ft_errs, ft_errs_bf16 = ft_kernel_checks(ft)
    ft_rows, ft_sums = ft_kernel_times(ft, per="HD3 flow update (D = 4, N = 2)")
    result = {"kernel_rows": rows, "kernel_sums": sums,
              "ft_kernel_errs": ft_errs["correlation"],
              "ft_bwd_kernel_err_bf16": ft_errs_bf16["correlation"], "ft_kernel_rows": ft_rows,
              "ft_kernel_sums": ft_sums["correlation"],
              "infer_card_vs_cpu": hd3_infer_card_vs_cpu(seed)}

    cli, vos = {}, {}
    for name, execution, frames, finetune in (
            ("frame", "frame", HD3_FRAMES, False), ("scan", "scan", HD3_SCAN_FRAMES, False),
            ("frame_finetune", "frame", HD3_FT_PAIRS + 1, True),
            ("scan_finetune", "scan", 1 + 32 + 1, True)):
        r = hd3_cli(seed, name, execution, frames, finetune)
        cli[name] = hd3_check_cli(r, execution, frames, finetune)
        vos[name] = r["vo"]
    result["cli"] = cli

    # bench.py's oracle drive through one HD3 chunk: every frame by E
    vo = vos["scan"]
    fe, variables, tcfg = vo.frontend, vo.infer_variables, vo.tcfg
    h, w = vo.cfg.image.height, vo.cfg.image.width
    chunk = int(vo.cfg.tpu.scan_chunk)
    K, frames, depths, flows, diffs, motions = oracle_chunk(h, w, chunk, seed)
    dev = torch.device("cuda")
    to = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    imgs = to(frames)
    keys = to(prng.step_keys(seed, range(1, chunk + 1)).astype(np.int64))
    oracle = {"depths": to(depths[1:]), "flow_fwd": to(flows), "flow_diff": to(diffs)}
    eye = torch.eye(4, device=dev)
    carry = (imgs[0], to(depths[0]), eye, np.float32(1.0))
    step, _ = make_chunk_step(fe, tcfg)
    Kd, Kid = to(K), to(np.linalg.inv(K).astype(np.float32))

    def run_chunk():
        return step(variables, imgs[1:], carry, keys, Kd, Kid, oracle=oracle)

    counters = reset_launch_counts()
    poses, modes, _ = run_chunk()
    launches = {k: fn.launches for k, fn in counters.items()}
    d4 = counters["correlation"].disp_launches[4]
    poses = poses.cpu().numpy().astype(np.float64)
    errs = [(rot_deg(poses[i][:3, :3], T[:3, :3]),
             float(np.linalg.norm(poses[i][:3, 3] - T[:3, 3]) / np.linalg.norm(T[:3, 3])))
            for i, T in enumerate(motions)]
    worst_rot, worst_t = max(e[0] for e in errs), max(e[1] for e in errs)
    print(f"  oracle chunk of {chunk} with HD3: modes {modes.tolist()}; worst rotation "
          f"{worst_rot:.3e} deg, translation {worst_t:.3e} of |t_gt| (bounds 0.1 deg, "
          f"0.05 |t|); launches {launches}, {d4} at D = 4", flush=True)
    if launches != HD3_PER_CALL or d4 != HD3_PER_CALL["correlation"] \
            or not (modes == TRACK_MODE_ESSENTIAL).all() or worst_rot >= 0.1 or worst_t >= 0.05:
        fail(f"hd3 oracle chunk: launches {launches} ({d4} at D = 4), modes {modes.tolist()}, "
             f"rotation {worst_rot:.3e} deg, translation {worst_t:.3e} of |t|")
    result["oracle_chunk"] = {"modes": modes.tolist(), "worst_rot_deg": worst_rot,
                              "worst_t_of_t": worst_t, "d4_launches": d4}

    # the times: infer, infer_chunk (33 frames), frame_step, chunk_step, update
    fvo = vos["frame"]
    fvars, img_ref = fvo.infer_variables, fvo.ref_data["img_dev"]
    unit = img_ref.float() / 255.0
    key = prng.fold_in(prng.PRNGKey(fvo.cfg.seed), HD3_FRAMES)
    chunk_imgs = torch.from_numpy(make_frames(seed, chunk + 1, h, w)).cuda().float() / 255.0
    tvo = vos["frame_finetune"]
    pose = torch.eye(4, device=dev)
    pose[2, 3] = 0.5
    steps = {}
    for name, fn, n_frames, want_syncs in (
            ("infer", lambda: fe.infer(fvars, unit, unit), None, 0),
            ("infer_chunk", lambda: fe.infer_chunk(fvars, chunk_imgs), chunk, 0),
            ("frame_step", lambda: frame_step(fvo.frontend, fvo.tcfg, fvars, img_ref, img_ref,
                                              fvo.ref_data["raw_depth_dev"], eye, key, fvo.K,
                                              fvo.K_inv, 1.0), None, 1),
            ("chunk_step", run_chunk, chunk, 1),
            ("update", lambda: tvo.finetuner.update(tvo.variables, tvo.opt_state, unit, unit,
                                                   pose), None, 0)):
        counters = reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        d4 = counters["correlation"].disp_launches[4]
        steps[name] = hd3_time(name, fn, out_dir, n_frames)
        steps[name]["d4_launches_per_call"] = d4
        if d4 != 5 or steps[name]["host_syncs"] != want_syncs:
            fail(f"hd3 {name}: {d4} launches at D = 4, {steps[name]['host_syncs']} host syncs; "
                 f"expected 5 and {want_syncs}")
    result["steps"] = steps
    # one HD3 flow update (scales 1-5) on the card against the CPU, held to
    # the finetune phase's limits for the flow network
    result["update_card_vs_cpu"] = ft_card_vs_cpu(seed, hd3_load_cfg("float32", finetune=True))
    result["launches_d4"] = sum(cli[x]["d4_launches"] for x in ("frame", "scan"))
    return result


def ms_cfg(data, result, dtype=None, execution="frame"):
    """The default configuration over the multiseq phase's sequences."""
    cfg = load_cfg(dtype)
    cfg.directory.img_seq_dir = f"{data}/odom_data"
    cfg.directory.gt_pose_dir = f"{data}/gt_poses"
    cfg.directory.result_dir = result
    cfg.tpu.execution = execution
    return cfg


def ms_expected(execution, frames, s):
    """Launches by kernel and batch size, and host reads per window (before
    the first step, each step, after), of the multi-sequence CLI over
    ``frames`` frames of ``s`` sequences. A frame step runs LiteFlowNet on
    the 2S images of the S pairs (5 cost volumes, 5 filters, 10 flow heads)
    and the depth network on S (4 disparity heads), and reads the PnP
    decision and the poses; a chunk runs each sequence's chunk step (the
    networks on 2T = 64 and T = 32 images, one decision read each) and
    reads the poses once. The first frames' depths: 4 heads at N = S."""
    if execution == "frame":
        steps = frames - 1
        by_batch = {"correlation": {2 * s: 5 * steps}, "reg_dist_filter": {2 * s: 5 * steps},
                    "head_conv": {2 * s: 10 * steps, s: 4 * steps + 4}}
        return by_batch, [0] + [2] * steps + [0]
    chunks = -(-(frames - 1) // 32)
    calls = s * chunks
    by_batch = {"correlation": {64: 5 * calls}, "reg_dist_filter": {64: 5 * calls},
                "head_conv": {64: 10 * calls, 32: 4 * calls, s: 4}}
    return by_batch, [0] + [s + 1] * chunks + [0]


def ms_cli(seed, root, data, execution, frames):
    """The multi-sequence CLI on the card over MS_SEQS, recorded and checked:
    trajectories, launches by batch size and variant, host reads per step
    by source line, the timer scopes, peak memory."""
    from dfvo_torch.apis import run_multiseq as cli
    from dfvo_torch.evaluation import KittiEvalOdom
    from dfvo_torch.utils.io import load_poses_from_txt

    s = len(MS_SEQS)
    result = os.path.join(root, f"result_{execution}")
    custom = os.path.join(root, f"custom_{execution}.yml")
    with open(custom, "w") as f:
        f.write(f"directory: {{img_seq_dir: {data}/odom_data, gt_pose_dir: {data}/gt_poses, "
                f"result_dir: {result}}}\ntpu: {{execution: {execution}}}\n")
    counters = reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = ScanRecorder(cli.MultiSeqRun, "run_frames" if execution == "frame" else "run_chunks")
    try:
        t0 = time.perf_counter()
        run = cli.main(["-d", CFG, "-c", custom, "--seqs", *MS_SEQS, "--max_frames", str(frames)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: fn.launches for k, fn in counters.items()}
    by_batch = {k: dict(sorted(fn.batch_launches.items())) for k, fn in counters.items()}
    variants = {k: dict(fn.variant_launches) for k, fn in counters.items()}
    want_batch, want_reads = ms_expected(execution, frames, s)
    print(f"  {execution}: {s} sequences x {frames} frames, {run.cfg.image.height}x"
          f"{run.cfg.image.width} {run.runner.frontend.dtype}, loader {run.loader}; main() "
          f"{wall:.2f} s; launches by batch size {by_batch} (expected {want_batch}); by "
          f"variant {variants}")
    if by_batch != want_batch:
        fail(f"multiseq {execution}: launches by batch size {by_batch} != {want_batch}")
    for k, by in variants.items():
        if by[MAIN_VARIANT[k]] != launches[k]:
            fail(f"multiseq {execution}: {k} launches by variant {by}, expected all "
                 f"{MAIN_VARIANT[k]}")
    windows = rec.windows()
    reads = [len(w) for w in windows]
    where = {}
    for w in windows:
        for loc in w:
            where[loc] = where.get(loc, 0) + 1
    print(f"  host reads per window (first frames, each step, after) {reads}, expected "
          f"{want_reads}; by source line {where}")
    if reads != want_reads:
        fail(f"multiseq {execution}: host reads {reads} != {want_reads} ({where})")
    ev = {}
    for name in MS_SEQS:
        traj = load_poses_from_txt(os.path.join(result, f"{name}.txt"))
        if sorted(traj) != list(range(frames)) or not all(np.isfinite(p).all()
                                                          for p in traj.values()):
            fail(f"multiseq {execution}: {name}.txt holds frames {sorted(traj)}, expected "
                 f"{frames} finite poses")
        gt = load_poses_from_txt(os.path.join(data, "gt_poses", f"{name}.txt"))
        e = KittiEvalOdom().eval_seq(gt, traj, alignment="6dof")
        if not all(np.isfinite(e[k]) for k in ("ate", "rpe_m", "rpe_deg")):
            fail(f"multiseq {execution} {name}: eval_seq {e}")
        ev[name] = e["ate"]
    means = {k: 1e3 * run.timers.get_mean(k) for k in ("data_loading", "depth_cnn", "vo_step",
                                                        "DF-VO") if k in run.timers.timers}
    steps = len(run.timers.timers["vo_step"]["times"])
    step_ms = [1e3 * t for t in run.timers.timers["vo_step"]["times"]]
    per_seq_frame = sum(step_ms) / (s * (frames - 1))
    print(f"  timer means (ms) {', '.join(f'{k} {v:.2f}' for k, v in means.items())}; vo_step "
          f"per step {[round(t, 2) for t in step_ms]}; {per_seq_frame:.2f} ms of vo_step per "
          f"sequence-frame; peak {peak:.2f} GiB; ATE (6dof) {min(ev.values()):.4f}.."
          f"{max(ev.values()):.4f} m")
    return {"sequences": s, "frames": frames, "steps": steps, "wall_s": wall,
            "timer_mean_ms": means, "vo_step_ms": step_ms,
            "vo_step_ms_per_sequence_frame": per_seq_frame, "peak_mem_gib": peak,
            "launches": launches, "launches_by_batch": by_batch,
            "host_reads": reads, "host_reads_by_line": where, "ate_6dof_m": ev}


def ms_step_card_vs_cpu(seed, data, root):
    """The batched VO step in float32 over the first MS_PARITY_S sequences
    on the card and on the CPU, from the same frames, reference depth and
    keys: modes equal, depths within MS_DEPTH_REL, each sequence's pose
    within 0.01 deg and F32_T_REL of its translation (the run phase's
    float32 limits)."""
    from dfvo_torch.apis.run_multiseq import MultiSeqRun
    from dfvo_torch.pipeline.dfvo import depth_only
    from dfvo_torch.utils import prng

    seqs, p = MS_SEQS[:MS_PARITY_S], MS_PARITY_S
    runs = {dev: MultiSeqRun(ms_cfg(data, os.path.join(root, f"f32_{dev}"), "float32"), seqs,
                             torch.device(dev), max_frames=2) for dev in ("cuda", "cpu")}
    host = runs["cpu"]
    host.open_loaders()
    try:
        ref, cur = host.next_batch(), host.next_batch()
    finally:
        host.close()
    depth_ref = depth_only(host.runner.frontend, host.variables, torch.from_numpy(ref))
    keys = prng.fold_in_many(prng.PRNGKey(seed), np.arange(p, 2 * p))
    out = {}
    for dev, r in runs.items():
        t0 = time.perf_counter()
        poses, modes, depth = r.runner.make_vo_step()(
            r.variables, torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev),
            depth_ref.to(dev), torch.eye(4, device=dev).expand(p, 4, 4), keys, r.K, r.K_inv)
        out[dev] = (poses.cpu().double().numpy(), modes.cpu().tolist(), depth.cpu(),
                    time.perf_counter() - t0)
    (cp, cm, cd, cs), (hp, hm, hd, hs) = out["cuda"], out["cpu"]
    depth_rel = float(((cd - hd).abs() / hd.abs().clamp(min=1e-6)).max())
    rot = [rot_deg(cp[i, :3, :3], hp[i, :3, :3]) for i in range(p)]
    t_norm = [float(np.linalg.norm(hp[i, :3, 3])) for i in range(p)]
    t_rel = [float(np.linalg.norm(cp[i, :3, 3] - hp[i, :3, 3])) / t if t > 0 else math.inf
             for i, t in zip(range(p), t_norm)]
    print(f"  batched step float32 S = {p}, card vs CPU: modes {cm} / {hm}; depth rel "
          f"{depth_rel:.2e} (limit {MS_DEPTH_REL:g}); rotation {max(rot):.2e} deg; translation "
          f"{max(t_rel):.2e} of |t| {[f'{t:.2e}' for t in t_norm]} m (limit {F32_T_REL:g}); "
          f"card {cs:.2f} s, CPU {hs:.2f} s", flush=True)
    if cm != hm or not depth_rel <= MS_DEPTH_REL or max(rot) >= 0.01 or max(t_rel) > F32_T_REL:
        fail(f"multiseq step card vs CPU: modes {cm} / {hm}, depth {depth_rel}, rotation {rot}, "
             f"translation {t_rel}")
    return {"sequences": p, "modes": cm, "depth_rel": depth_rel, "worst_rot_deg": max(rot),
            "worst_t_of_t": max(t_rel), "t_norm_m": t_norm, "t_limit_of_t": F32_T_REL,
            "card_s": cs, "cpu_s": hs}


def ms_update(seed, data, out_dir):
    """One sequence-averaged finetuning update over MS_PARITY_S pairs
    (ablation_self_flow_online.yml on the default, float32, TF32 off): the
    loss and the flow gradient on the card against the CPU (FT_F32_LIMITS);
    then ``make_train_step`` on the card: its launches at N = 2S (float32
    variants, and a backward kernel per backward pass of the cost volume
    and the head conv), CUDA-event ms, kernels, busy share and peak
    memory."""
    from dfvo_torch.datasets import datasets as registry
    from dfvo_torch.parallel import MultiSeqRunner
    from dfvo_torch.utils import ConfigLoader

    cfg = ConfigLoader().merge_cfg([CFG, ABLATION_CFG])
    cfg.directory.img_seq_dir = f"{data}/odom_data"
    cfg.directory.gt_pose_dir = f"{data}/gt_poses"
    cams = []
    for name in MS_SEQS[:MS_PARITY_S]:
        cfg.seq = name
        cams.append(registry[cfg.dataset](cfg).cam_intrinsics)
    K = np.stack([c.mat for c in cams]).astype(np.float32)
    K_inv = np.stack([c.inv_mat for c in cams]).astype(np.float32)
    p, h, w = MS_PARITY_S, cfg.image.height, cfg.image.width
    frames = np.stack([make_frames(seed + i, 2, h, w) for i in range(p)])  # [S x 2 x H x W x 3]
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (p, 4, 4)).copy()
    poses[:, :3, 3] = [0.02, 0.0, 0.5]

    def setup(dev):
        runner = MultiSeqRunner(cfg, device=dev)
        fe = runner.frontend
        variables = {net: {k: v.to(dev) for k, v in sd.items()}
                     for net, sd in fe.init_variables(torch.Generator().manual_seed(seed)).items()}
        state = runner.finetuner.init_state(variables, K, K_inv)
        imgs = torch.from_numpy(frames).to(dev).float() / 255.0
        return runner, variables, state, imgs[:, 0], imgs[:, 1], torch.from_numpy(poses).to(dev)

    grads = {}
    for dev in ("cuda", "cpu"):
        runner, variables, _, ref, cur, pose = setup(dev)
        t0 = time.perf_counter()
        loss, g = runner.finetuner.value_and_grad(variables, ref, cur, pose)
        grads[dev] = (float(loss), {k: t.cpu() for k, t in g["flow"].items()},
                      time.perf_counter() - t0)
    (lc, gc, tc), (lh, gh, th) = grads["cuda"], grads["cpu"]
    a = torch.cat([t.ravel() for t in gc.values()]).double()
    b = torch.cat([gh[k].ravel() for k in gc]).double()
    loss_rel, grad_rel = abs(lc - lh) / abs(lh), float((a - b).norm() / b.norm())
    print(f"  sequence-averaged update S = {p} at {h}x{w} float32, TF32 off: loss {lc:.7f} / "
          f"{lh:.7f} (rel {loss_rel:.2e}, limit {FT_F32_LIMITS['loss_rel']:g}); flow gradient "
          f"rel {grad_rel:.2e} by norm (limit {FT_F32_LIMITS['flow_grad_rel']:g}); card "
          f"{tc:.2f} s, CPU {th:.2f} s", flush=True)
    if not (loss_rel <= FT_F32_LIMITS["loss_rel"] and grad_rel <= FT_F32_LIMITS["flow_grad_rel"]):
        fail(f"multiseq update card vs CPU: loss rel {loss_rel}, gradient rel {grad_rel}")

    runner, variables, state, ref, cur, pose = setup("cuda")
    train = runner.make_train_step()

    def step():
        train(variables, state, ref, cur, pose)

    counters = reset_launch_counts()
    bwd = backward_counts()
    step()
    torch.cuda.synchronize()
    by_batch = {k: dict(fn.batch_launches) for k, fn in counters.items()}
    variants = {k: dict(fn.variant_launches) for k, fn in counters.items()}
    bwd_by_batch = {k: dict(fn.batch_launches) for k, fn in bwd.items()}
    want = {"correlation": {2 * p: 5}, "reg_dist_filter": {2 * p: 5}, "head_conv": {2 * p: 10}}
    print(f"  train step launches by batch size {by_batch} (expected {want}); by variant "
          f"{variants}; backward kernels by batch size {bwd_by_batch}")
    if by_batch != want or any(variants[k][FT_VARIANT[k]] != sum(want[k].values())
                               for k in want):
        fail(f"multiseq train step launches {by_batch} / {variants}, expected {want} on "
             f"{FT_VARIANT}")
    if bwd_by_batch != {k: want[k] for k in bwd}:
        fail(f"multiseq train step backward kernels {bwd_by_batch}, expected "
             f"{ {k: want[k] for k in bwd} }")
    syncs = count_syncs(step)
    ms = time_cuda(step, reps=1, rounds=3)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_call(step, "multiseq_train_step", out_dir)
    print(f"  train step S = {p}: {ms:.2f} ms (CUDA events, median), {ms / p:.2f} ms per "
          f"sequence, {syncs} host syncs, peak {peak:.2f} GiB")
    return {"sequences": p, "loss_rel": loss_rel, "flow_grad_rel": grad_rel,
            "limits": {k: FT_F32_LIMITS[k] for k in ("loss_rel", "flow_grad_rel")},
            "launches_by_batch": by_batch, "bwd_launches_by_batch": bwd_by_batch,
            "ms": ms, "ms_per_sequence": ms / p,
            "host_syncs": syncs, "peak_mem_gib": peak,
            **{k: v for k, v in prof.items() if k != "top"}}


def ms_times(data, root, out_dir, single_frame_ms):
    """The batched VO step and chunk step over all MS_SEQS at the default
    configuration (192x640 bf16): CUDA-event ms per call, per
    sequence-frame, host syncs, kernels, busy share and peak memory,
    beside the single-sequence frame_step of the tracking phase."""
    from dfvo_torch.apis.run_multiseq import MultiSeqRun
    from dfvo_torch.pipeline.dfvo import depth_only
    from dfvo_torch.utils import prng
    from dfvo_torch.utils.device import upload

    s, t = len(MS_SEQS), 32
    run = MultiSeqRun(ms_cfg(data, os.path.join(root, "times")), MS_SEQS, torch.device("cuda"),
                      max_frames=t + 1)
    run.open_loaders()
    try:
        batches = [run.next_batch() for _ in range(t + 1)]
    finally:
        run.close()
    ref, cur = upload(batches[0], "cuda"), upload(batches[1], "cuda")
    depth_ref = depth_only(run.runner.frontend, run.variables, ref)
    eye = torch.eye(4, device="cuda").expand(s, 4, 4)
    base = prng.PRNGKey(SEED)
    vo_step = run.runner.make_vo_step()
    keys = prng.fold_in_many(base, np.arange(s, 2 * s))

    def frame():
        return vo_step(run.variables, cur, ref, depth_ref, eye, keys, run.K, run.K_inv)

    chunk_step = run.runner.make_chunk_step()
    imgs = upload(np.stack(batches[1:], axis=1), "cuda")  # [S x T x H x W x 3]
    rngs = prng.fold_in_many(prng.fold_in_many(base, np.arange(1, t + 1))[None],
                             np.arange(s)[:, None])
    carry = (ref, depth_ref, eye, np.ones(s, np.float32))

    def chunk():
        return chunk_step(run.variables, imgs, carry, rngs, run.K, run.K_inv)

    out = {}
    for name, fn, reps, rounds, seq_frames, want_syncs in (
            ("vo_step", frame, 2, 3, s, 1), ("chunk_step", chunk, 1, 2, s * t, s)):
        syncs = count_syncs(fn)
        if syncs != want_syncs:
            fail(f"multiseq {name}: {syncs} host syncs, expected {want_syncs}")
        ms = time_cuda(fn, reps=reps, rounds=rounds)
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the chunk step over S sequences is S single-sequence chunk steps,
        # whose kernels and busy share the scan phase profiles; a trace of
        # its ~140,000 kernels takes minutes to read back (1.2 ms each)
        prof = profile_call(fn, f"multiseq_{name}", out_dir) if name == "vo_step" else {}
        out[name] = {"sequences": s, "ms": ms, "ms_per_sequence_frame": ms / seq_frames,
                     "host_syncs": syncs, "peak_mem_gib": peak,
                     **{k: v for k, v in prof.items() if k != "top"}}
        print(f"  {name} S = {s}: {ms:.2f} ms (CUDA events, median), {ms / seq_frames:.3f} ms "
              f"per sequence-frame, {syncs} host syncs, peak {peak:.2f} GiB"
              + ("" if prof else f"; kernels: {s} x the scan phase's chunk_step"), flush=True)
    out["single_frame_step_ms"] = single_frame_ms
    print(f"  single-sequence frame_step (tracking phase): {single_frame_ms:.2f} ms/frame; "
          f"batched {out['vo_step']['ms_per_sequence_frame']:.2f} ms per sequence-frame "
          f"({single_frame_ms / out['vo_step']['ms_per_sequence_frame']:.2f}x)")
    return out


def ms_kernels(chk):
    """Each kernel against its plain version at the batched frame step's
    shapes (LiteFlowNet at N = 2S = 22, the disparity heads at N = S = 11;
    float32, then bf16 on the main-path variant), each kernel's Function at
    the sequence-averaged update's N = 2 * MS_PARITY_S (float32, output and
    input gradients against the plain version's autograd; the backward
    kernels also in bf16) with its forward and backward times, and the
    kernels' times per network call of the batched frame step. The chunk step runs
    the scan phase's N = 64 / 32, which the kernels phase checks."""
    s = len(MS_SEQS)
    check_main_path_shapes(chk, (CORR_SHAPES, REG_SHAPES, LFN_HEADS, DEPTH_HEADS),
                           lfn_batches=(2 * s,), depth_batches=(s,), suffix=" multiseq")
    errs = {k: {"f32": 0.0, "bf16": 0.0} for k in PER_CALL}
    for (kernel, label), (e32, e16) in chk.errs.items():
        if "multiseq" in label:
            errs[kernel]["f32"] = max(errs[kernel]["f32"], e32)
            errs[kernel]["bf16"] = max(errs[kernel]["bf16"], e16)
    ft = ft_cases(chk, n=2 * MS_PARITY_S, depth=False)
    update, update_bf16 = ft_kernel_checks(ft)
    update_rows, update_sums = ft_kernel_times(
        ft, per=f"sequence-averaged update (N = {2 * MS_PARITY_S})")
    rows, sums = kernel_times(timing_cases(chk, batches=((2 * s, 1, (6, 5, 4, 3, 2)),),
                                           depth_n=s),
                              per=f"batched frame step network call (S = {s})")
    return {"max_abs_err": errs,
            "update_f32_err": {k: {"out": v[0], "input_grads": v[1]} for k, v in update.items()},
            "update_bwd_bf16_err": update_bf16, "update_rows": update_rows,
            "update_sums": update_sums, "kernel_rows": rows, "kernel_sums": sums}


@phase("multiseq")
def multiseq_phase(chk, seed, out_dir, single_frame_ms):
    """Multi-sequence runs on the card: each kernel at the batched steps'
    batch sizes against its plain version; the run_multiseq CLI over the 11
    KITTI-scored sequences in both executions; the batched step in float32
    against the CPU; one sequence-averaged update against the CPU; the
    times of the batched steps."""
    root = os.path.join(ROOT, "build", "chip_smoke", "multiseq")
    data = os.path.join(root, "data")
    for i, name in enumerate(MS_SEQS):
        fx, cx, cy = MS_CAMS[name]
        write_run_sequence(data, seed + i, MS_SCAN_FRAMES, seq=name,
                           calib=f"{fx} 0.0 {cx} 0.0 0.0 {fx} {cy} 0.0 0.0 0.0 1.0 0.0")
    print(f"  {len(MS_SEQS)} sequences of {MS_SCAN_FRAMES} frames {RUN_SIZE[1]}x{RUN_SIZE[0]} "
          f"jpg in {os.path.relpath(data, ROOT)}")
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    lap("write")
    kernels = ms_kernels(chk)
    lap("kernels")
    cli = {}
    for ex, frames in (("frame", MS_FRAMES), ("scan", MS_SCAN_FRAMES)):
        cli[ex] = ms_cli(seed, root, data, ex, frames)
        lap(f"cli_{ex}")
    parity = ms_step_card_vs_cpu(seed, data, root)
    lap("step_card_vs_cpu")
    update = ms_update(seed, data, out_dir)
    lap("update")
    times = ms_times(data, root, out_dir, single_frame_ms)
    lap("times")
    print("  seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return {"kernels": kernels, "cli": cli, "step_card_vs_cpu": parity, "update": update,
            "times": times, "seconds_by_part": parts}


# the datasets phase: the shipped configurations of the other datasets at
# their own sizes (bf16, full width, seeded weights, the drawer as shipped),
# over synthetic sequences in each dataset's layout (dfvo_torch.synth.layouts)
DS_CFG = {"tum": "tum_rgbd_slam.yml", "adelaide": "adelaide_driving.yml",
          "robotcar": "oxford_robotcar.yml"}
DS_SIZE = {"tum": (480, 640), "adelaide": (256, 832), "robotcar": (256, 640)}
# frames written: TUM runs at frame_step 5, so 31 frames give frames
# 0, 5, .., 30 (6 tracked) in frame execution and 161 give 33 (one chunk
# of 32) in scan execution; Adelaide and RobotCar 8 frames each
DS_RUNS = (("tum_frame", "tum", "frame", 31), ("tum_scan", "tum", "scan", 1 + 32 * 5),
           ("adelaide", "adelaide", "frame", 8), ("robotcar", "robotcar", "frame", 8))
# the kernels' batches at each feed: LiteFlowNet's and the depth network's
# N in `infer` (2 / 1) and, for TUM's scan run, in `infer_chunk` (64 / 32)
DS_BATCHES = {"tum": ((2, 1), (64, 32)), "adelaide": ((2, 1),), "robotcar": ((2, 1),)}
# the flow export: two KITTI-flow pairs at KITTI flow's 375x1242 (fed at
# 384x1248); per pair LiteFlowNet's 5 levels and 10 flow-delta heads
EXPORT_SIZE, EXPORT_PAIRS = (375, 1242), 2
EXPORT_PER_PAIR = {"correlation": 5, "reg_dist_filter": 5, "head_conv": 10}


def ds_custom(root, kind, execution):
    """The shipped YAML of ``kind`` with the directories under ``root``
    (and scan execution): one custom file, since ``-c`` takes one."""
    import yaml

    with open(os.path.join(ROOT, "options", "examples", DS_CFG[kind])) as f:
        custom = yaml.safe_load(f)
    data, result = os.path.join(root, "data"), os.path.join(root, "result")
    custom["directory"] = {**custom["directory"], "img_seq_dir": data, "result_dir": result}
    if custom["directory"].get("gt_pose_dir"):
        custom["directory"]["gt_pose_dir"] = data
    if execution == "scan":
        custom["tpu"] = {"execution": "scan"}
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "custom.yml")
    with open(path, "w") as f:
        yaml.safe_dump(custom, f)
    return path, custom


def ds_check_cli(name, kind, r, execution, ids, result, stamps):
    """A datasets CLI run's checks: the configuration as shipped, the
    trajectory (TUM's stamped with its tracked frames' own synchronised
    timestamps), the launches and their variants, the host reads; returns
    its summary."""
    from dfvo_torch.utils.io import load_poses_from_txt

    vo = r["vo"]
    fe, cfg = vo.frontend, vo.cfg
    size = DS_SIZE[kind]
    if (cfg.image.height, cfg.image.width) != size or fe.flow_feed != size \
            or fe.depth_feed != size or fe.dtype != torch.bfloat16 or vo.drawer is None \
            or vo.loader != "dataset" or str(cfg.tpu.get("execution", "frame")) != execution:
        fail(f"datasets {name}: {cfg.image.height}x{cfg.image.width}, feeds {fe.flow_feed} "
             f"{fe.depth_feed}, {fe.dtype}, drawer {vo.drawer is not None}, loader {vo.loader}")
    traj_txt = os.path.join(result, f"{cfg.seq}.txt")
    if kind == "tum":
        traj = np.loadtxt(traj_txt, ndmin=2)
        want = [float(stamps[i]) for i in ids]
        if traj.shape != (len(ids), 8) or not np.isfinite(traj).all() \
                or traj[:, 0].tolist() != want:
            fail(f"datasets {name}: TUM file {traj.shape}, stamps {traj[:, 0].tolist()}, "
                 f"expected {len(ids)} finite lines of 8 stamped {want}")
    else:
        traj = load_poses_from_txt(traj_txt)
        if sorted(traj) != list(ids) or not all(np.isfinite(p).all() for p in traj.values()):
            fail(f"datasets {name}: frames {sorted(traj)}, expected {len(ids)} finite poses")
    tracked = len(ids) - 1
    n_calls = tracked if execution == "frame" else math.ceil(tracked / int(cfg.tpu.scan_chunk))
    want = {k: n_calls * PER_CALL[k] + DEPTH_ONLY_CALL[k] for k in PER_CALL}
    print(f"  {name}: launches {r['launches']} (expected {want}: {PER_CALL} per network call, "
          f"{DEPTH_ONLY_CALL} on the first frame), by variant {r['variants']}")
    if r["launches"] != want or any(r["variants"][k][MAIN_VARIANT[k]] != want[k] for k in want):
        fail(f"datasets {name}: launches {r['launches']}, by variant {r['variants']}; "
             f"expected {want}, all on {MAIN_VARIANT}")
    if execution == "frame":
        syncs, where = r["rec"].syncs, r["rec"].where
        want_syncs = [0] + [RUN_HOST_READS[True]] * tracked
    else:
        windows = r["rec"].windows()
        syncs, where = [len(x) for x in windows], {}
        for loc in (loc for x in windows for loc in x):
            where[loc] = where.get(loc, 0) + 1
        want_syncs = [0] + [SCAN_HOST_READS] * n_calls + [0]
    if syncs != want_syncs:
        fail(f"datasets {name}: host reads {syncs}, expected {want_syncs}; by source line {where}")
    times = vo.timers.timers
    per_frame = {k: 1e3 * sum(times[k]["times"]) / tracked for k in sorted(times)
                 if k != "depth_cnn"}
    print(f"  {name}: {len(ids)} frames, main() in {r['wall']:.2f} s; per tracked frame (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_frame.items())
          + f"; host reads {syncs} by source line {where}; peak memory "
          f"{r['peak'] / 2**30:.2f} GiB", flush=True)
    return {"frames": len(ids), "tracked": tracked, "execution": execution,
            "size": list(size), "wall_s": r["wall"], "ms_per_tracked_frame": per_frame,
            "host_reads": syncs, "launches": r["launches"], "variants": r["variants"],
            "peak_mem_gib": r["peak"] / 2**30}


def ds_kernels(chk, kind):
    """Each kernel against its plain version at every shape of ``kind``'s
    feed at its batches, the variant each launch took, and their times per
    network call beside the bounds."""
    from dfvo_torch.pipeline.frontend import DeepFrontend
    from dfvo_torch.utils import ConfigLoader

    cfg = ConfigLoader().merge_cfg([CFG, os.path.join(ROOT, "options", "examples",
                                                     DS_CFG[kind])])
    fe = DeepFrontend(cfg, "cuda")
    h, w = DS_SIZE[kind]
    if fe.flow_feed != (h, w) or fe.depth_feed != (h, w):
        fail(f"datasets {kind}: feeds {fe.flow_feed} {fe.depth_feed}, expected the image size")
    shapes = main_path_shapes(fe.flow_feed, fe.depth_feed)
    out = {"sums": {}, "rows": {}}
    for n, dn in DS_BATCHES[kind]:
        suffix = f" @{kind} {w}x{h} N={n}"
        check_main_path_shapes(chk, shapes, lfn_batches=(n,), depth_batches=(dn,),
                               suffix=suffix)
        mine = {key: v for key, v in chk.errs.items() if suffix in key[1]}
        rows, sums = kernel_times(timing_cases(chk, shapes, batches=((n, 1, (6, 5, 4, 3, 2)),),
                                               depth_n=dn),
                                  per=f"{kind} {w}x{h} network call at N = {n} / {dn}")
        out["rows"][f"n{n}"] = rows
        out["sums"][f"n{n}"] = {
            name: {**{k: sums[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "launches_per_call")},
                   "n": n, "depth_n": dn,
                   "max_abs_err": max(e16 for (kk, _), (_, e16) in mine.items() if kk == name),
                   "variants": sorted({chk.variants[key] for key in mine if key[0] == name})}
            for name in PER_CALL}
    return out


def ds_infer_card_vs_cpu(seed):
    """TUM's `infer` in float32 on the card and on the CPU, one 480x640
    pair, the parity phase's weights (flow heads x40, flows of pixels),
    held to the parity phase's limits."""
    from dfvo_torch.pipeline.frontend import DeepFrontend
    from dfvo_torch.utils import ConfigLoader

    cfg = ConfigLoader().merge_cfg([CFG, os.path.join(ROOT, "options", "examples",
                                                     DS_CFG["tum"])])
    cfg.tpu.dtype = "float32"
    h, w = cfg.image.height, cfg.image.width
    imgs = torch.from_numpy(make_frames(seed, 2, h, w)).float() / 255.0
    outs = {}
    for device in ("cuda", "cpu"):
        fe = DeepFrontend(cfg, device)
        variables = fe.prepare_variables(parity_variables(fe, seed))
        t0 = time.perf_counter()
        out = fe.infer(variables, imgs[1].to(device), imgs[0].to(device))
        outs[device] = ({k: v.cpu() for k, v in out.items()}, time.perf_counter() - t0)
    (got, tg), (want, tc) = outs["cuda"], outs["cpu"]
    res = {"depth_cur_rel": ((got["depth_cur"] - want["depth_cur"]).abs()
                             / want["depth_cur"].abs()).max().item()}
    for key in ("flow_fwd", "flow_bwd", "flow_diff"):
        res[key] = (got[key] - want[key]).abs().max().item()
    res["max_abs_flow_px"] = want["flow_fwd"].abs().max().item()
    print(f"  TUM infer f32, card ({tg:.2f} s) vs CPU ({tc:.2f} s), one {w}x{h} pair, |flow| up "
          f"to {res['max_abs_flow_px']:.2f} px: depth relative {res['depth_cur_rel']:.2e} "
          f"(limit 1e-3); " + ", ".join(f"{k} {res[k]:.2e} px" for k in
                                         ("flow_fwd", "flow_bwd", "flow_diff"))
          + " (limit 1e-2)", flush=True)
    if not res["depth_cur_rel"] <= 1e-3 or any(
            not res[k] <= 1e-2 for k in ("flow_fwd", "flow_bwd", "flow_diff")):
        fail(f"datasets TUM infer card vs CPU: {res}")
    return res


def ds_flow_export(seed, root):
    """python -m dfvo_torch.tools.generate_flow_prediction on the card over
    EXPORT_PAIRS synthetic KITTI-flow pairs at 375x1242, through a --model
    checkpoint (the parity phase's weights); the PNGs read back against the
    port's own flows of the same pairs within the PNG's 1/64 px and the
    bf16 flow tolerance; the launches per pair."""
    import cv2

    from dfvo_torch.flowlib import read_kitti_png_flow
    from dfvo_torch.pipeline.frontend import DeepFrontend, resize_dense_flow
    from dfvo_torch.synth.layouts import panning_frames
    from dfvo_torch.tools import generate_flow_prediction as gfp

    h, w = EXPORT_SIZE
    data, result = os.path.join(root, "data"), os.path.join(root, "result")
    os.makedirs(data, exist_ok=True)
    frames = panning_frames(seed, 2 * EXPORT_PAIRS, h, w)
    for k in range(EXPORT_PAIRS):
        for j, suffix in enumerate(("_10", "_11")):
            cv2.imwrite(os.path.join(data, f"{k:06d}{suffix}.png"),
                        cv2.cvtColor(frames[2 * k + j], cv2.COLOR_RGB2BGR))
    cfg = load_cfg()
    cfg.image.height, cfg.image.width = gfp.feed_size(h, w)
    fe = DeepFrontend(cfg, "cuda")
    variables = parity_variables(fe, seed)
    model = os.path.join(root, "network-parity.pytorch")
    torch.save(variables["flow"], model)
    counters = reset_launch_counts()
    t0 = time.perf_counter()
    export = gfp.main(["--data_dir", data, "--result", result, "--model", model])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    variants = {k: dict(fn.variant_launches) for k, fn in counters.items()}
    want = {k: EXPORT_PAIRS * v for k, v in EXPORT_PER_PAIR.items()}
    if export.seeded or export.frontend.flow_feed != (384, 1248) \
            or export.frontend.dtype != torch.bfloat16 or launches != want \
            or any(variants[k][MAIN_VARIANT[k]] != want[k] for k in want):
        fail(f"flow export: feed {export.frontend.flow_feed}, {export.frontend.dtype}, launches "
             f"{launches}, by variant {variants}; expected {want}")
    # the port's own flows: the frontend's LiteFlowNet on the same feed with
    # the weights as drawn (not read back from the checkpoint), resized to
    # the image as the JAX tool resizes them
    v = fe.prepare_variables(variables)
    worst, limit = 0.0, 1.0 / 64 + BF16_FLOW_ATOL_PX
    for k in range(EXPORT_PAIRS):
        flow, valid = read_kitti_png_flow(os.path.join(result, f"{k:06d}_10.png"))
        feed = torch.stack([export.prepare(frames[2 * k + j]) for j in (0, 1)]).to(fe.dtype)
        with torch.no_grad():
            native = fe._flow(v, feed, feed.flip(0), "shared")
        mine = resize_dense_flow(native[:1], h, w)[0].cpu().numpy()
        err = float(np.abs(flow - mine).max())
        worst = max(worst, err)
        if flow.shape != (h, w, 2) or not valid.all() or not err <= limit:
            fail(f"flow export pair {k}: {flow.shape}, valid {valid.mean():.3f}, max abs err "
                 f"{err:.3e} px against the port's infer (limit {limit:.3e})")
    print(f"  flow export: {EXPORT_PAIRS} pairs {w}x{h} (fed at {export.frontend.flow_feed}, "
          f"bf16) in {wall:.2f} s; launches {launches} ({EXPORT_PER_PAIR} per pair), by variant "
          f"{variants}; PNGs against the port's infer: max abs err {worst:.3e} px (limit "
          f"{limit:.3e}; |flow| up to {np.abs(mine).max():.2f} px)", flush=True)
    return {"pairs": EXPORT_PAIRS, "size": list(EXPORT_SIZE), "feed": [384, 1248],
            "wall_s": wall, "launches": launches, "variants": variants, "max_abs_err_px": worst,
            "limit_px": limit}


@phase("datasets")
def datasets_phase(chk, seed):
    """The shipped TUM RGB-D, Adelaide and Oxford RobotCar configurations
    on the card: each kernel at each new feed against its plain version
    with the variant named, and its times; the CLI over synthetic
    sequences in each layout (TUM in both executions); TUM's float32
    `infer` against the CPU; the flow export at 375x1242."""
    from dfvo_torch.synth import layouts

    base = os.path.join(ROOT, "build", "chip_smoke", "datasets")
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    kernels = {}
    for kind in DS_CFG:
        kernels[kind] = ds_kernels(chk, kind)
        lap(f"kernels_{kind}")
    cli = {}
    for name, kind, execution, written in DS_RUNS:
        root = os.path.join(base, name)
        custom, cfg = ds_custom(root, kind, execution)
        data, seq = cfg["directory"]["img_seq_dir"], str(cfg["seq"])
        stamps = None
        if kind == "tum":
            stamps = layouts.write_tum(data, seq, written, *DS_SIZE[kind], seed=seed)
        elif kind == "adelaide":
            layouts.write_adelaide(data, seq, written, *DS_SIZE[kind], seed=seed)
        else:
            layouts.write_robotcar(data, seq, written, seed=seed)
        step = int(cfg.get("frame_step", 1))
        r = recorded_cli(execution, custom)
        cli[name] = ds_check_cli(name, kind, r, execution, list(range(0, written, step)),
                                 cfg["directory"]["result_dir"], stamps)
        lap(f"cli_{name}")
    parity = ds_infer_card_vs_cpu(seed)
    lap("infer_card_vs_cpu")
    export = ds_flow_export(seed, os.path.join(base, "export"))
    lap("flow_export")
    print("  seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return {"kernels": kernels, "cli": cli, "infer_card_vs_cpu": parity, "flow_export": export,
            "seconds_by_part": parts}


def hd3_summary(hd3, smi):
    """The hd3 phase's numbers for its JSON line."""
    return {"cli": {k: {kk: vv for kk, vv in v.items() if kk != "host_reads_by_line"}
                    for k, v in hd3["cli"].items()},
            "steps": hd3["steps"], "oracle_chunk": hd3["oracle_chunk"],
            "infer_card_vs_cpu": hd3["infer_card_vs_cpu"],
            "update_card_vs_cpu": hd3["update_card_vs_cpu"],
            "correlation_d4": hd3["kernel_sums"], "ft_kernel_errs": hd3["ft_kernel_errs"],
            "ft_bwd_kernel_err_bf16": hd3["ft_bwd_kernel_err_bf16"],
            "ft_kernel_sums": hd3["ft_kernel_sums"], "nvidia_smi": smi}


def ext_summary(extend, smi):
    """The extend phase's numbers for its JSON line."""
    return {
        "size": extend["size"], "cli": extend["cli"],
        "steps": {k: {kk: vv for kk, vv in v.items() if kk != "top"}
                  for k, v in extend["steps"].items()},
        "oracle_chunk": {k: {kk: vv for kk, vv in v.items() if kk != "top"}
                         for k, v in extend["oracle_chunk"].items()},
        "iterative_scenes": extend["iterative_scenes"],
        "iterative_chunk_card_vs_cpu": extend["iterative_chunk_card_vs_cpu"],
        "pose_cnn": extend["pose_cnn"], "kernel_sums": extend["kernel_sums"],
        "flow_export_kernel_sums": extend["flow_export_kernel_sums"],
        "ft_kernel_errs": extend["ft_kernel_errs"],
        "ft_bwd_kernel_errs_bf16": extend["ft_bwd_kernel_errs_bf16"],
        "ft_kernel_sums": extend["ft_kernel_sums"], "nvidia_smi": smi}


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
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    fe, variables, imgs, launches = slice_phase(SEED)
    parity = parity_phase(SEED, imgs)
    scenes, track = track_phase()
    frame = frame_phase(fe, variables, SEED)
    infer_ms, chunk_ms, rows, sums = times_phase(chk, fe, variables, imgs)
    profile = profile_phase(fe, variables, imgs, out_dir)
    tracking = tracking_phase(fe, variables, scenes, frame, out_dir)
    run = run_phase(SEED, smi)
    scan = scan_phase(SEED, out_dir)
    finetune = finetune_phase(chk, SEED, out_dir)
    extend = extend_phase(chk, SEED, out_dir)
    hd3 = hd3_phase(chk, SEED, out_dir)
    multiseq = multiseq_phase(chk, SEED, out_dir, tracking["frame_step"]["ms_per_frame"])
    datasets = datasets_phase(chk, SEED)

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
         "launches_cli": run["launches"][name],
         "launches_scan": scan["launches"][name],
         "launches_finetune": sum(finetune["cli"][x]["launches_finetune"][name]
                                  for x in ("frame", "scan")),
         "launches_per_call": sums[name]["launches_per_call"],
         "max_abs_err": chk.max_abs_err[name],
         "ms": sums[name]["ms"], "plain_ms": sums[name]["plain_ms"],
         "bound_ms": sums[name]["bound_ms"], "bound_by": sums[name]["bound_by"],
         "library_ms": sums[name]["library_ms"],
         "launches_extend": extend["launches"][name],
         "launches_multiseq": {ex: multiseq["cli"][ex]["launches_by_batch"][name]
                               for ex in ("frame", "scan")},
         "launches_multiseq_update": multiseq["update"]["launches_by_batch"][name],
         "at_multiseq_s11": {
             "max_abs_err": multiseq["kernels"]["max_abs_err"][name]["bf16"],
             "update_f32_err": multiseq["kernels"]["update_f32_err"][name],
             **{k: multiseq["kernels"]["kernel_sums"][name][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "launches_per_call")}},
         "at_370x1226": {k: extend["kernel_sums"][name][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_per_call")},
         **{f"at_{kind}_{DS_SIZE[kind][0]}x{DS_SIZE[kind][1]}": {
             n: by[name] for n, by in datasets["kernels"][kind]["sums"].items()}
            for kind in DS_CFG},
         "launches_datasets": {run: datasets["cli"][run]["launches"][name]
                               for run in datasets["cli"]},
         "launches_flow_export": datasets["flow_export"]["launches"][name]}
        for name, (src, rep) in sources.items()
    ]
    # HD3's use of the cost volume (D = 4, 81 channels): times, bound and
    # plain version per infer_chunk network call (N = 64 bf16), launches over
    # the hd3 phase's two inference CLI runs
    d4 = hd3["kernel_sums"]
    kernels.append({
        "name": "correlation_d4", "route": "cuda", "source": "dfvo_torch/csrc/correlation.cu",
        "replaces": "dfvo_tpu/ops/pallas_corr.py:30 (HD3, dfvo_tpu/models/hd3.py:484)",
        "variant": "tensor_core (C <= 256), reg_tile (C = 512)",
        "launches": hd3["launches_d4"],
        "launches_per_frame": hd3["steps"]["frame_step"]["d4_launches_per_call"],
        "launches_per_chunk": hd3["steps"]["chunk_step"]["d4_launches_per_call"],
        "launches_per_update": hd3["steps"]["update"]["d4_launches_per_call"],
        "launches_per_call": d4["infer_chunk"]["launches_per_call"],
        "max_abs_err": chk.max_abs_err["correlation_d4"],
        **{k: d4["infer_chunk"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms")},
        "per_infer_n2": d4["infer"], "per_update_f32": d4["update"]})
    # the backward kernels of the finetuning update: times, bounds, the
    # plain VJP they replaced and, for the head conv, cuDNN's
    # convolution_backward (the port never calls it), summed per update at
    # 192x640 (float32, N = 2 / 1); launches over both finetuning CLI runs
    bwd_sources = {
        "correlation": ("dfvo_torch/csrc/correlation_bwd.cu",
                        "dfvo_tpu/ops/pallas_corr.py:215 (_corr_bwd, the backward of the "
                        "custom_vjp around the Pallas kernels; not itself a Pallas kernel)"),
        "reg_dist_filter": ("dfvo_torch/csrc/regfilter_bwd.cu",
                            "dfvo_tpu/ops/regfilter.py:242 (_rf_bwd, the backward of the "
                            "custom_vjp around the Pallas kernel, with autodiff of the "
                            "normalisation at dfvo_tpu/models/liteflownet.py:403-404; not "
                            "itself a Pallas kernel)"),
        "head_conv": ("dfvo_torch/csrc/headconv_bwd.cu",
                      "dfvo_tpu/ops/headconv.py:254 (_hc_bwd, the backward of the "
                      "custom_vjp around the Pallas kernel; not itself a Pallas kernel)"),
    }
    for name, (src, rep) in bwd_sources.items():
        ft = finetune["kernel_sums"][name]
        ms_upd = multiseq["kernels"]["update_sums"][name]
        entry = {
            "name": f"{name}_backward", "route": "cuda", "source": src, "replaces": rep,
            "variant": "CUDA cores (f32 FMA)",
            "launches": sum(finetune["cli"][x]["bwd_launches"][name] for x in ("frame", "scan")),
            "launches_per_update": ft["launches_per_update"],
            "max_abs_err": finetune["kernel_errs"][name][1],
            "max_abs_err_bf16": finetune["bwd_kernel_errs_bf16"][name],
            "ms": ft["bwd_ms"], "plain_ms": ft["plain_bwd_ms"], "bound_ms": ft["bwd_bound_ms"],
            "bound_by": ft["bwd_bound_by"], "library_ms": ft["library_bwd_ms"],
            "launches_extend": sum(extend["cli"][x]["bwd_launches"][name]
                                   for x in ("frame", "scan")),
            "at_multiseq_update_n8": {k: ms_upd[k] for k in (
                "bwd_ms", "plain_bwd_ms", "bwd_bound_ms", "bwd_bound_by", "library_bwd_ms")}}
        entry["at_370x1226_update"] = {k: extend["ft_kernel_sums"][name][k] for k in (
            "bwd_ms", "plain_bwd_ms", "bwd_bound_ms", "bwd_bound_by", "library_bwd_ms")}
        if name == "correlation":
            entry["launches_hd3"] = sum(hd3["cli"][x]["bwd_launches"][name]
                                        for x in ("frame_finetune", "scan_finetune"))
            entry["at_hd3_d4_update"] = {k: hd3["ft_kernel_sums"][k] for k in (
                "bwd_ms", "plain_bwd_ms", "bwd_bound_ms", "bwd_bound_by")}
        kernels.append(entry)
    # the head conv's float32 forward (reg_tile), every head of a finetuning
    # update: times per update at 192x640 (N = 2 / 1), launches over both
    # finetuning CLI runs
    ft, ext_ft = finetune["kernel_sums"]["head_conv"], extend["ft_kernel_sums"]["head_conv"]
    ms_ft = multiseq["kernels"]["update_sums"]["head_conv"]
    kernels.insert(3, {
        "name": "head_conv_f32", "route": "cuda", "source": "dfvo_torch/csrc/headconv.cu",
        "replaces": "dfvo_tpu/ops/headconv.py:65 (in float32, the finetuning update)",
        "variant": FT_VARIANT["head_conv"],
        "launches": sum(finetune["cli"][x]["launches_finetune"]["head_conv"]
                        for x in ("frame", "scan")),
        "launches_per_update": ft["launches_per_update"],
        "max_abs_err": finetune["kernel_errs"]["head_conv"][0],
        "ms": ft["fwd_ms"], "plain_ms": ft["plain_fwd_ms"], "bound_ms": ft["fwd_bound_ms"],
        "bound_by": ft["fwd_bound_by"], "library_ms": ft["library_fwd_ms"],
        "launches_extend": sum(extend["cli"][x]["launches_finetune"]["head_conv"]
                               for x in ("frame", "scan")),
        "at_370x1226_update": {k: ext_ft[k] for k in (
            "fwd_ms", "plain_fwd_ms", "fwd_bound_ms", "fwd_bound_by", "library_fwd_ms")},
        "at_multiseq_update_n8": {k: ms_ft[k] for k in (
            "fwd_ms", "plain_fwd_ms", "fwd_bound_ms", "fwd_bound_by", "library_fwd_ms")}})
    # the cost volume's float32 forward (reg_tile), its five levels in a
    # finetuning update: times per update at 192x640 (N = 2), launches over
    # both finetuning CLI runs; at the extend feed, N = 8 and HD3's D = 4
    ft = finetune["kernel_sums"]["correlation"]
    ext_ft = extend["ft_kernel_sums"]["correlation"]
    ms_ft = multiseq["kernels"]["update_sums"]["correlation"]
    kernels.insert(1, {
        "name": "correlation_f32", "route": "cuda", "source": "dfvo_torch/csrc/correlation.cu",
        "replaces": "dfvo_tpu/ops/pallas_corr.py:30 (in float32, the finetuning update)",
        "variant": FT_VARIANT["correlation"],
        "launches": sum(finetune["cli"][x]["launches_finetune"]["correlation"]
                        for x in ("frame", "scan")),
        "launches_per_update": ft["launches_per_update"],
        "max_abs_err": finetune["kernel_errs"]["correlation"][0],
        "ms": ft["fwd_ms"], "plain_ms": ft["plain_fwd_ms"], "bound_ms": ft["fwd_bound_ms"],
        "bound_by": ft["fwd_bound_by"], "library_ms": ft["library_fwd_ms"],
        "launches_extend": sum(extend["cli"][x]["launches_finetune"]["correlation"]
                               for x in ("frame", "scan")),
        "at_370x1226_update": {k: ext_ft[k] for k in (
            "fwd_ms", "plain_fwd_ms", "fwd_bound_ms", "fwd_bound_by", "library_fwd_ms")},
        "at_multiseq_update_n8": {k: ms_ft[k] for k in (
            "fwd_ms", "plain_fwd_ms", "fwd_bound_ms", "fwd_bound_by", "library_fwd_ms")},
        "at_hd3_d4_update": {k: d4["update"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    report = {
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "infer_ms_per_frame": infer_ms, "infer_chunk_ms_per_frame": chunk_ms,
        "kernel_rows": rows, "per_call": sums, "ptxas": ptxas,
        "max_abs_err_f32": chk.max_abs_err_f32,
        "parity": parity, "kernels": kernels, "profile": profile,
        "track": track, "frame": {"modes": frame["modes"], "launches": frame["launches"]},
        "tracking": tracking, "run": run, "scan": scan, "finetune": finetune,
        "extend": extend, "hd3": hd3, "multiseq": multiseq, "datasets": datasets,
        "lost_traces": LOST_TRACES,
        "seconds": time.perf_counter() - t_start,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"total {report['seconds']:.1f} s; report in {os.path.relpath(args.out, ROOT)}")
    print(json.dumps({"run": {k: run[k] for k in (
        "frames", "size", "dtype", "timer_mean_ms", "frames_per_s", "steady_median_ms",
        "host_reads_per_frame", "loader", "drawer", "eval_6dof", "f32_card_vs_cpu",
        "nvidia_smi")}}))
    print(json.dumps({"tracking": {
        "tracking_step_ms": {k: v["ms"] for k, v in tracking["tracking_step"].items()},
        "tracking_step_kernels": {k: v["kernels"] for k, v in tracking["tracking_step"].items()},
        "tracking_step_busy_share": {k: v["busy_share"]
                                     for k, v in tracking["tracking_step"].items()},
        "host_syncs_per_tracking_step": {k: v["host_syncs"]
                                         for k, v in tracking["tracking_step"].items()},
        "frame_step_ms_per_frame": tracking["frame_step"]["ms_per_frame"],
        "frame_step_kernels": tracking["frame_step"]["kernels"],
        "frame_step_busy_share": tracking["frame_step"]["busy_share"],
        "frame_modes": frame["modes"],
        "track": {k: {kk: vv for kk, vv in v.items() if kk != "card_vs_cpu"}
                  for k, v in track.items()}}}))
    print(json.dumps({"scan": {k: scan[k] for k in (
        "frames", "chunk", "size", "dtype", "df_vo_ms_per_chunk", "ms_per_tracked_frame",
        "df_vo_steady_ms_per_frame", "frames_per_s", "host_reads", "host_reads_by_line",
        "launches", "cli_peak_mem_gib", "eval_6dof", "oracle_modes", "oracle_worst_rot_deg",
        "oracle_worst_t_of_t", "f32_card_vs_cpu")} | {"chunk_step": {
            name: {k: v for k, v in r.items() if k != "top"}
            for name, r in scan["chunk_step"].items()}}}))
    print(json.dumps({"finetune": {
        "update": {k: v for k, v in finetune["update"].items() if k != "top"},
        "cli": finetune["cli"], "card_vs_cpu": finetune["card_vs_cpu"],
        "kernel_errs": finetune["kernel_errs"], "kernel_sums": finetune["kernel_sums"],
        "df_vo_ms_per_frame_without_finetuning": {
            "frame": run["timer_mean_ms"]["DF-VO"],
            "scan": scan["ms_per_tracked_frame"]["DF-VO"]},
        "nvidia_smi": smi}}))
    print(json.dumps({"extend": ext_summary(extend, smi)}))
    print(json.dumps({"hd3": hd3_summary(hd3, smi)}))
    print(json.dumps({"multiseq": {
        **multiseq, "nvidia_smi": smi,
        "kernels": {k: v for k, v in multiseq["kernels"].items() if k not in ("kernel_rows", "update_rows")}}}))
    print(json.dumps({"datasets": {
        "cli": datasets["cli"], "infer_card_vs_cpu": datasets["infer_card_vs_cpu"],
        "flow_export": datasets["flow_export"], "seconds_by_part": datasets["seconds_by_part"],
        "nvidia_smi": smi}}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
