#!/usr/bin/env python3
"""How far float32 rounding moves the frame loop's poses, card against CPU.

    python3 scripts/f32_loop_conditioning.py [--frames 4]

Needs one NVIDIA GPU. Writes chip_smoke.py's synthetic run sequence under
build/f32_loop_conditioning/, then runs ``DFVO.main`` in float32 (drawer
off) on the card and on the CPU for several seeded weight sets: the
configuration's seed, other generator seeds, and LiteFlowNet's
flow-delta heads scaled (larger flows) with or without its biases
redrawn. For each tracked frame it prints one JSON line: both modes, the
valid keypoints and inliers, whether the keypoint sets are equal, the
largest flow and the flows' card-vs-CPU difference, and the CPU's
relative pose (|t|, rotation) with the card's difference from it
(rotation in degrees, translation as a share of |t|). TF32 is off.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# (generator seed or None for the configuration's, head scale, biases redrawn)
VARIANTS = ((None, 1.0, False), (0, 1.0, False), (1, 1.0, False), (2, 1.0, False),
            (0, 10.0, False), (1, 10.0, False), (1, 20.0, False), (0, 3.0, True),
            (0, 10.0, True))


def variables(fe, seed, head_scale, redraw_bias):
    v = fe.init_variables(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    for k in v["flow"]:
        if k.endswith("moduleMain.6.weight") and "Regularization" not in k:
            v["flow"][k] = v["flow"][k] * head_scale
        if redraw_bias and k.endswith(".bias"):
            v["flow"][k] = 0.05 * torch.randn(v["flow"][k].shape, generator=g)
    return v


def run(data, out, device, variant, frames):
    from dfvo_torch.pipeline.dfvo import DFVO

    cfg = cs.load_cfg("float32")
    cfg.seq = cs.RUN_SEQ
    cfg.directory.img_seq_dir = f"{data}/odom_data"
    cfg.directory.gt_pose_dir = f"{data}/gt_poses"
    cfg.directory.result_dir = os.path.join(out, f"result_{device}")
    cfg.visualization.enable = False
    seed, head_scale, redraw_bias = variant
    vo = DFVO(cfg, device=device)
    vo.variables = variables(vo.frontend, int(cfg.seed) if seed is None else seed,
                             head_scale, redraw_bias)
    vo.infer_variables = vo.frontend.prepare_variables(vo.variables)
    steps, run_frame = [], vo.run_frame

    def record(img_id, img=None):
        mode = run_frame(img_id, img=img)
        if vo.tracking_stage > 1:
            steps.append({k: v.detach().cpu() for k, v in vo.cur_data["vo_out"].items()})
        return mode

    vo.run_frame = record
    vo.main(num_frames=frames)
    return vo, steps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=cs.PARITY_FRAMES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("f32_loop_conditioning: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = os.path.join(ROOT, "build", "f32_loop_conditioning")
    data = os.path.join(out, "data")
    cs.write_run_sequence(data, cs.SEED)
    print(cs.nvidia_smi_line())
    for variant in VARIANTS:
        (gvo, gsteps), (cvo, csteps) = (run(data, out, d, variant, args.frames)
                                        for d in ("cuda", "cpu"))
        for i, (a, b) in enumerate(zip(gsteps, csteps), 1):
            (Ra, ta), (Rb, tb) = (cs.relative_pose(v.global_poses, i) for v in (gvo, cvo))
            tn = float(np.linalg.norm(tb))
            print(json.dumps({
                "seed": variant[0], "head_scale": variant[1], "biases_redrawn": variant[2],
                "frame": i, "modes": [int(a["mode"]), int(b["mode"])],
                "valid": [int(a["kp_valid"].sum()), int(b["kp_valid"].sum())],
                "inliers": [int(a["inliers"].sum()), int(b["inliers"].sum())],
                "kp_equal": bool(torch.equal(a["kp_ref"], b["kp_ref"])),
                "flow_max_px": float(b["flow_fwd"].abs().max()),
                "flow_diff_px": float((a["flow_fwd"] - b["flow_fwd"]).abs().max()),
                "t_norm_m": tn, "rot_deg": cs.rot_deg(Rb, np.eye(3)),
                "d_rot_deg": cs.rot_deg(Ra, Rb),
                "d_t_of_t": float(np.linalg.norm(ta - tb)) / tn if tn > 0 else None,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
