"""The port's tools and CLIs on the CPU.

Against the JAX package's tools, which run no JAX program:
``generate_kitti_raw_pose`` on synthetic OXTS files, ``undistort_robotcar``
on a synthetic look-up table and Bayer frames, and ``tum_eval``'s printed
lines. Their files are compared byte for byte.

Port-only, since a JAX loop or LiteFlowNet at these sizes would compile
programs that no other test compiles: ``generate_flow_prediction`` at
64x96 against the port's own ``infer`` flow, and the CLI over the three
shipped configurations that the KITTI tests do not reach
(``tum_rgbd_slam.yml`` in both executions, ``adelaide_driving.yml``,
``oxford_robotcar.yml``) at 64x96, float32, 32 hypotheses, over the
synthetic layouts of ``dfvo_torch.synth.layouts``; the TUM result is
scored by ``python -m dfvo_torch.apis.tum_eval``.
"""

import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from dfvo_torch.synth import layouts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options", "examples", "default_configuration.yml")
# KITTI's 16-bit flow PNG holds u * 64 + 2^15, truncated: one step is 1/64 px
PNG_STEP = 1.0 / 64.0
# the CPU recipe of the shipped configurations (.claude/skills/verify/SKILL.md)
CPU_RECIPE = {"image": {"height": 64, "width": 96},
              "tpu": {"ransac_hypotheses": 32, "dtype": "float32"},
              "pnp_tracker": {"ransac": {"iter": 20}}}


def _jax_tool(rel, argv, monkeypatch):
    """Run the JAX package's tool ``tools/<rel>``'s main with ``argv``."""
    path = os.path.join(REPO, "tools", rel)
    spec = importlib.util.spec_from_file_location("jax_tool_" + rel.replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    return mod.main()


def test_generate_kitti_raw_pose_matches_jax(tmp_path, monkeypatch):
    from dfvo_torch.tools import generate_kitti_raw_pose

    seqs = ["2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync"]
    for k, seq in enumerate(seqs):
        oxts = tmp_path / "raw" / seq[:10] / seq / "oxts" / "data"
        oxts.mkdir(parents=True)
        for i in range(5 + k):
            vals = [49.0 + 1e-5 * i, 8.4 + 2e-5 * i * (k + 1), 110.0 + 0.01 * i, 0.01 * i,
                    -0.02 * i, 0.5 + 0.03 * i] + [0.0] * 24
            (oxts / f"{i:010d}.txt").write_text(" ".join(str(v) for v in vals) + "\n")
    args = ["--data_dir", str(tmp_path / "raw"), "--seqs", *seqs]
    generate_kitti_raw_pose.main(args + ["--result_dir", str(tmp_path / "t")])
    _jax_tool("generate_kitti_raw_pose.py", args + ["--result_dir", str(tmp_path / "j")],
              monkeypatch)
    for seq in seqs:
        got = (tmp_path / "t" / f"{seq}.txt").read_bytes()
        assert got == (tmp_path / "j" / f"{seq}.txt").read_bytes()
        assert len(got.splitlines()) == 5 + seqs.index(seq)


def test_undistort_robotcar_matches_jax(tmp_path, monkeypatch):
    from dfvo_torch.tools import undistort_robotcar

    seq = "2014-05-06-12-54-54"
    h, w = 40, 56
    models = tmp_path / "robotcar-dataset-sdk" / "models"
    models.mkdir(parents=True)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    np.stack([(xs + 1.5 + 0.02 * ys).ravel(), (ys - 0.75 + 0.01 * xs).ravel()]).tofile(
        str(models / "stereo_narrow_left_distortion_lut.bin"))
    (models / "stereo_narrow_left.txt").write_text(
        "983.04 983.04 643.64 493.37\n0 0 1 0\n1 0 0 0\n0 1 0 0\n0 0 0 1\n")
    raw = tmp_path / seq / "stereo" / "centre"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for ts in (1000, 1062, 1125):
        cv2.imwrite(str(raw / f"{ts}.png"), (rng.rand(h, w) * 255).astype(np.uint8))
    out = tmp_path / seq / "undistorted_stereo" / "centre"
    argv = ["--data_dir", str(tmp_path), "--seq", seq]
    undistort_robotcar.main(argv)
    got = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
    for p in got:
        (out / p).unlink()
    _jax_tool("undistort_robotcar.py", argv, monkeypatch)
    assert sorted(got) == ["1000.png", "1062.png", "1125.png"]
    assert got == {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}


def _tum_files(tmp_path, rng, n=30, drop=()):
    lines_gt, lines_res = [], []
    for i in range(n):
        t = 1305031102.0 + i / 30.0
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        lines_gt.append(f"{t + 0.002:.6f} {0.1 * i:.4f} {0.01 * i:.4f} 0.0 {q[1]:.6f} "
                        f"{q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
        if i not in drop:
            lines_res.append(f"{t} {0.09 * i + 0.01 * rng.randn()} {0.02 * rng.randn()} 0.5 "
                             f"{q[1]} {q[2]} {q[3]} {q[0]}")
    (tmp_path / "gt.txt").write_text("\n".join(lines_gt) + "\n")
    (tmp_path / "res.txt").write_text("\n".join(lines_res) + "\n")


@pytest.mark.parametrize("max_difference", [None, "0.001"])
def test_tum_eval_matches_jax(tmp_path, monkeypatch, capsys, max_difference):
    from dfvo_torch.apis import tum_eval

    _tum_files(tmp_path, np.random.RandomState(1), drop=(3, 7))
    argv = ["--result", str(tmp_path / "res.txt"), "--gt", str(tmp_path / "gt.txt")]
    if max_difference:
        argv += ["--max_difference", max_difference]
    if max_difference == "0.001":
        # 2 ms apart everywhere: no pair within 1 ms, and both refuse
        for run in (lambda: tum_eval.main(argv),
                    lambda: _jax_tool("evaluation/tum_eval.py", argv, monkeypatch)):
            with pytest.raises(SystemExit, match="not enough matched"):
                run()
        return
    tum_eval.main(argv)
    got = capsys.readouterr().out
    _jax_tool("evaluation/tum_eval.py", argv, monkeypatch)
    want = capsys.readouterr().out
    assert got == want and got.startswith("compared_pose_pairs 28 pairs\n")


# -- port only -----------------------------------------------------------------

@pytest.mark.parametrize("thre", [None, 2.0])
def test_generate_flow_prediction_matches_infer(tmp_path, thre):
    """Two KITTI-flow pairs at 64x96 (already multiples of 32) through a
    ``--model`` checkpoint: the default configuration's seeded flow weights
    with the flow heads scaled by 100, so that the flows span pixels (up
    to about 7 px; the seeded heads give hundredths of a pixel). The PNGs
    hold the port's own ``infer`` forward flow (float32) on the same
    weights within one PNG step (both in the default configuration's
    bfloat16), and with ``--flow_mask_thre`` flow 0 and
    invalid where the inconsistency of ``infer``'s two flows at the image
    size is not below it (as the JAX tool measures it; ``infer``'s own map
    is measured at the network's half resolution)."""
    from dfvo_torch.flowlib import read_kitti_png_flow
    from dfvo_torch.pipeline.frontend import DeepFrontend, forward_backward_consistency
    from dfvo_torch.tools import generate_flow_prediction as gfp
    from dfvo_torch.utils import ConfigLoader

    cfg = ConfigLoader().merge_cfg([DEFAULT_CFG])
    cfg.image.height, cfg.image.width = 64, 96
    fe = DeepFrontend(cfg, "cpu")
    assert fe.dtype == torch.bfloat16
    variables = fe.load_variables(torch.Generator().manual_seed(cfg.seed))
    variables["flow"] = {k: v * 100.0 if ".moduleMain.6." in k else v
                         for k, v in variables["flow"].items()}
    model = tmp_path / "network-scaled.pytorch"
    torch.save(variables["flow"], str(model))
    variables = fe.prepare_variables(variables)

    data = tmp_path / "data"
    data.mkdir()
    frames = layouts.panning_frames(3, 4, 64, 96)
    for k in range(2):
        for j, suffix in enumerate(("_10", "_11")):
            cv2.imwrite(str(data / f"{k:06d}{suffix}.png"),
                        cv2.cvtColor(frames[2 * k + j], cv2.COLOR_RGB2BGR))
    argv = ["--data_dir", str(data), "--result", str(tmp_path / "out"), "--model", str(model),
            "--device", "cpu"]
    if thre is not None:
        argv += ["--flow_mask_thre", str(thre)]
    assert not gfp.main(argv).seeded

    for k in range(2):
        flow, valid = read_kitti_png_flow(str(tmp_path / "out" / f"{k:06d}_10.png"))
        unit = torch.from_numpy(frames[2 * k : 2 * k + 2]).float() / 255.0
        out = fe.infer(variables, unit[1], unit[0])
        want = out["flow_fwd"].numpy().astype(np.float64)
        assert np.abs(want).max() > 1.0
        if thre is None:
            assert valid.all()
        else:
            diff = forward_backward_consistency(out["flow_fwd"][None], out["flow_bwd"][None])
            diff = diff[0].numpy()
            clear = np.abs(diff - thre) > 1e-4
            assert 0.1 < valid.mean() < 0.9
            np.testing.assert_array_equal(valid[clear], (diff < thre)[clear])
            want = want * valid[..., None]
        err = flow - want
        # the writer truncates to the step below; its float32 sum rounds
        # by 2^-9 of a step at most
        assert err.max() <= 1e-4 and err.min() >= -PNG_STEP - 1e-4, (err.min(), err.max())


def _custom(tmp_path, shipped, data, result, **extra):
    """The shipped YAML with the CPU recipe, its directories and ``extra``
    merged in: one custom file, since ``-c`` takes one."""
    with open(os.path.join(REPO, "options", "examples", shipped)) as f:
        cfg = yaml.safe_load(f)
    for part in (CPU_RECIPE, extra):
        for key, val in part.items():
            cfg[key] = {**cfg.get(key, {}), **val} if isinstance(val, dict) else val
    cfg["directory"] = {**cfg["directory"], "img_seq_dir": str(data), "result_dir": str(result)}
    path = tmp_path / f"custom_{shipped}"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(custom):
    from dfvo_torch.apis import run

    return run.main(["-d", DEFAULT_CFG, "-c", custom, "--no_confirm", "--device", "cpu"])


@pytest.mark.parametrize("execution,frames", [("frame", 11), ("scan", 21)])
def test_cli_tum_rgbd_slam(tmp_path, capsys, execution, frames):
    """tum_rgbd_slam.yml (frame_step 5): the TUM file holds the tracked
    frames 0, 5, 10, ... each with its own synchronised timestamp; scan
    execution in chunks of 3 (a full chunk and a padded one); scored by
    tum_eval against the sequence's groundtruth.txt."""
    from dfvo_torch.apis import tum_eval

    data, result = tmp_path / "tum", tmp_path / "result"
    seq = "rgbd_dataset_freiburg3_long_office_household"
    stamps = layouts.write_tum(str(data), seq, frames, h=48, w=64)
    extra = {"tpu": {"execution": "scan", "scan_chunk": 3}} if execution == "scan" else {}
    vo = _run(_custom(tmp_path, "tum_rgbd_slam.yml", data, result, **extra))
    assert vo.cfg.frame_step == 5 and vo.device.type == "cpu"
    assert type(vo.dataset).__name__ == "TUM" and vo.loader == "dataset"
    ids = list(range(0, frames, 5))
    assert sorted(vo.global_poses) == ids
    traj = np.loadtxt(result / f"{seq}.txt")
    assert traj.shape == (len(ids), 8) and np.isfinite(traj).all()
    np.testing.assert_array_equal(traj[:, 0], [float(stamps[i]) for i in ids])
    capsys.readouterr()
    pairs, rmse = tum_eval.main(["--result", str(result / f"{seq}.txt"),
                                 "--gt", str(data / seq / "groundtruth.txt")])
    assert pairs == len(ids) and np.isfinite(rmse)
    assert capsys.readouterr().out.startswith(f"compared_pose_pairs {len(ids)} pairs\n")


@pytest.mark.parametrize("shipped", ["adelaide_driving.yml", "oxford_robotcar.yml"])
def test_cli_adelaide_and_robotcar(tmp_path, shipped):
    """adelaide_driving.yml (no ground truth) and oxford_robotcar.yml (GT
    from the VO file, the bottom 20 % cropped) through the CLI: one finite
    KITTI-format pose per frame."""
    from dfvo_torch.utils.io import load_poses_from_txt

    frames = 4
    data, result = tmp_path / "data", tmp_path / "result"
    if shipped == "adelaide_driving.yml":
        seq, kind = "seq1", "Adelaide"
        layouts.write_adelaide(str(data), seq, frames, h=64, w=208)
        extra = {}
    else:
        seq, kind = "2014-05-06-12-54-54", "OxfordRobotCar"
        layouts.write_robotcar(str(data), seq, frames, h=120, w=160)
        extra = {"directory": {"gt_pose_dir": str(data)}}
    vo = _run(_custom(tmp_path, shipped, data, result, **extra))
    assert type(vo.dataset).__name__ == kind
    poses = load_poses_from_txt(str(result / f"{seq}.txt"))
    assert sorted(poses) == list(range(frames))
    assert all(np.isfinite(p).all() for p in poses.values())
