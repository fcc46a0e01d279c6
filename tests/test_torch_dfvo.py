"""The port's frame loop as a whole against the JAX package, on the CPU.

``DFVO(cfg).main()`` of both packages on one KITTI-odometry-layout sequence
(the layout and frame-mode configuration of
tests/test_scan_runner.py::test_cli_scan_execution_matches_frame_execution:
64x96, 32 hypotheses, float32, visualization off, so the JAX step program
is one the JAX suite already compiles) with the same seeded weights:
the JAX run's variables are the port's seeded initialisation converted by
the JAX package's converters, with the flow net's biases redrawn and its
flow-delta heads scaled x10, and the port gets them back through the
parameter bridge. Then the port's CLI, ``python -m dfvo_torch.apis.run``,
and its scoring CLI, through their ``main(argv)``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dfvo_torch.models import convert as bridge
from dfvo_torch.pipeline.dfvo import DFVO as TDFVO
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils.io import load_poses_from_txt
from dfvo_tpu.pipeline import DFVO as JDFVO
from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend
from dfvo_tpu.utils import ConfigLoader
from tests.test_torch_models import _perturb, seeded_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options/examples/default_configuration.yml")
N_FRAMES = 8


@pytest.fixture(scope="module")
def tiny_kitti(tmp_path_factory):
    """tests/test_scan_runner.py's ``tiny_kitti``: 8 blurred-noise frames
    panning 8 px per frame, calib.txt and GT poses of sequence 07."""
    import cv2

    root = tmp_path_factory.mktemp("kitti_torch")
    img_dir = root / "odom_data" / "07" / "image_2"
    img_dir.mkdir(parents=True)
    gt_dir = root / "gt_poses"
    gt_dir.mkdir()
    rng = np.random.RandomState(3)
    big = (rng.rand(200, 600, 3) * 255).astype(np.uint8)
    big = cv2.GaussianBlur(big, (0, 0), 2)
    lines = []
    for i in range(N_FRAMES):
        cv2.imwrite(str(img_dir / f"{i:06d}.jpg"), big[20:140, 8 * i : 8 * i + 400])
        P = np.eye(4)
        P[0, 3] = 0.1 * i
        lines.append(" ".join(str(v) for v in P.flatten()[:12]))
    (gt_dir / "07.txt").write_text("\n".join(lines) + "\n")
    (root / "odom_data" / "07" / "calib.txt").write_text(
        "\n".join(f"P{j}: 230.0 0.0 200.0 0.0 0.0 230.0 60.0 0.0 0.0 0.0 1.0 0.0"
                  for j in range(4)) + "\n"
    )
    return root


def _frame_cfg(loader, root, result_dir):
    """The frame-mode configuration of test_cli_scan_execution_matches_frame_execution."""
    cfg = loader().merge_cfg([DEFAULT_CFG])
    cfg.seq = "07"
    cfg.image.height = 64
    cfg.image.width = 96
    cfg.directory.img_seq_dir = str(root / "odom_data")
    cfg.directory.gt_pose_dir = str(root / "gt_poses")
    cfg.directory.result_dir = str(result_dir)
    cfg.visualization.enable = False
    cfg.visualization.save_img = False
    cfg.tpu.ransac_hypotheses = 32
    cfg.tpu.scan_chunk = 3
    cfg.tpu.dtype = "float32"
    cfg.tpu.execution = "frame"
    return cfg


_JAX_INFER = {}


def jax_infer(frontend):
    """``jax.jit(frontend.infer)``, one per frontend configuration
    (``static_key``) in a process, so the tests that one pytest worker runs
    trace it once (the JAX ``DFVO`` shares its step functions the same
    way)."""
    key = frontend.static_key()
    if key not in _JAX_INFER:
        _JAX_INFER[key] = jax.jit(frontend.infer)
    return _JAX_INFER[key]


def split_jax_step(jvo):
    """Run the JAX loop's fused frame step (``DFVO._full_step``: ``infer``,
    then ``tracking_step``, as one jitted program) as its two jitted
    halves, each a program that the JAX suite compiles too (the persistent
    compilation cache then holds it): ``jax.jit(frontend.infer)`` is
    tests/test_infer_chunk.py's, and ``tracking_step`` with the rigid-flow
    map on (the drawer's map, an extra output that changes nothing else) is
    tests/test_scan_runner.py's at 64x96. The same computation, without
    XLA's fusion across the boundary."""
    import dataclasses

    from dfvo_tpu.pipeline.tracking import tracking_step

    assert jvo.tracking_method != "deep_pose" and not jvo.use_gt_depth
    infer = jax_infer(jvo.frontend)
    tcfg = dataclasses.replace(jvo.tcfg, want_rigid_flow_diff=True)

    def full_step(variables, img_cur_u8, img_ref_u8, depth_ref_raw, prev_motion, rng, K,
                  K_inv, prev_scale, gt_depth_cur=None):
        fo = infer(variables, jnp.asarray(img_cur_u8).astype(jnp.float32) / 255.0,
                   jnp.asarray(img_ref_u8).astype(jnp.float32) / 255.0)
        tr = tracking_step(rng, fo["flow_fwd"], fo["flow_diff"], fo["depth_cur"],
                           depth_ref_raw, prev_motion, K, K_inv, tcfg, prev_scale=prev_scale)
        return {**{k: tr[k] for k in ("pose", "mode", "scale", "kp_ref", "kp_cur", "kp_valid",
                                      "inliers", "rigid_flow_diff", "depth_cur")},
                "depth_cur_raw": fo["depth_cur"], "flow_fwd": fo["flow_fwd"],
                "flow_bwd": fo["flow_bwd"], "flow_diff": fo["flow_diff"]}

    jvo._full_step = full_step
    return jvo


def _record_frames(vo):
    """Wrap ``vo.run_frame`` to collect each tracked frame's mode, scale,
    valid keypoints and inliers (host reads the loops themselves skip with
    the drawer off)."""
    frames, run = [], vo.run_frame

    def run_frame(img_id, img=None):
        out = run(img_id, img=img)
        if vo.tracking_stage > 1:
            o = vo.cur_data["vo_out"]
            frames.append((int(np.asarray(o["mode"])), float(np.asarray(o["scale"])),
                           int(np.asarray(o["kp_valid"]).sum()),
                           int(np.asarray(o["inliers"]).sum())))
        return out

    vo.run_frame = run_frame
    return frames


def test_dfvo_main_matches_jax(tiny_kitti, tmp_path, monkeypatch):
    jvars = seeded_flax_variables(0)
    # flows of ~0.4 px that pass the forward-backward check (x40 flows of
    # several px fail it everywhere and leave no keypoints), so PnP moves
    # the camera by millimetres per frame
    jvars["flow"] = _perturb(jvars["flow"], np.random.RandomState(0), head_scale=10.0)
    # the JAX loop initialises its networks eagerly (op by op, about a
    # minute on the CPU); hand it the converted variables instead
    monkeypatch.setattr(JDeepFrontend, "init_variables",
                        lambda self, rng: jax.tree.map(jnp.asarray, jvars))
    jvo = split_jax_step(JDFVO(_frame_cfg(ConfigLoader, tiny_kitti, tmp_path / "jax")))
    j_frames = _record_frames(jvo)
    jvo.main()

    tvo = TDFVO(_frame_cfg(TConfigLoader, tiny_kitti, tmp_path / "torch"), device="cpu")
    tvo.variables = {"depth": bridge.monodepth2_depth_from_flax(jvars["depth"]),
                     "flow": bridge.liteflownet_from_flax(jvars["flow"])}
    tvo.infer_variables = tvo.frontend.prepare_variables(tvo.variables)
    t_frames = _record_frames(tvo)
    tvo.main()

    want = load_poses_from_txt(str(tmp_path / "jax" / "07.txt"))
    got = load_poses_from_txt(str(tmp_path / "torch" / "07.txt"))
    assert sorted(got) == sorted(want) == list(range(N_FRAMES))
    # the compared motion lies far above the tolerance: an identity or a
    # halved trajectory fails
    assert max(np.linalg.norm(p[:3, 3]) for p in want.values()) >= 100 * 1e-5
    assert max(np.abs(p[:3, :3] - np.eye(3)).max() for p in want.values()) >= 100 * 1e-5
    # float32 steps (pose within 1e-5 each, tests/test_torch_frontend.py)
    # chained in float64 over 7 frames: 1e-5
    for i in want:
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, err_msg=f"frame {i}")
    assert len(t_frames) == len(j_frames) == N_FRAMES - 1
    for i, (t, j) in enumerate(zip(t_frames, j_frames), 1):
        # mode, valid keypoints and inliers equal; the scale as in
        # test_frame_steps_match_jax
        assert (t[0], t[2], t[3]) == (j[0], j[2], j[3]), f"frame {i}"
        np.testing.assert_allclose(t[1], j[1], rtol=1e-3, err_msg=f"frame {i}")


def test_cli_writes_trajectory_config_and_scores(tiny_kitti, tmp_path):
    """``python -m dfvo_torch.apis.run --device cpu`` with a custom YAML
    (drawer on), then ``python -m dfvo_torch.apis.eval_odom`` on its
    result."""
    from dfvo_torch.apis import eval_odom, run

    result = tmp_path / "result"
    custom = tmp_path / "custom.yml"
    custom.write_text(
        'seq: "07"\n'
        "image: {height: 64, width: 96}\n"
        f"directory: {{img_seq_dir: {tiny_kitti / 'odom_data'}, "
        f"gt_pose_dir: {tiny_kitti / 'gt_poses'}, result_dir: {result}}}\n"
        "visualization: {enable: True, save_img: True}\n"
        "tpu: {ransac_hypotheses: 32, dtype: float32}\n"
    )
    vo = run.main(["-d", DEFAULT_CFG, "-c", str(custom), "--no_confirm", "--device", "cpu"])
    assert vo.device.type == "cpu" and vo.loader in ("native", "cv2-thread")

    poses = load_poses_from_txt(str(result / "07.txt"))
    assert sorted(poses) == list(range(N_FRAMES))
    assert all(np.isfinite(p).all() for p in poses.values())
    saved = (result / "configuration.yml").read_text()
    assert "height: 64  # |CHANGED| default: 192" in saved
    assert "ransac_hypotheses: 32  # |CHANGED| default: 256" in saved
    assert (result / "map.png").is_file()
    assert sorted(os.listdir(result / "img")) == [f"{i:06d}.jpg" for i in range(1, N_FRAMES)]

    summary = eval_odom.main(["--result", str(result), "--gt", str(tiny_kitti / "gt_poses"),
                              "--align", "6dof", "--seqs", "07"])
    assert np.isfinite(summary["07"]["ate"]) and np.isfinite(summary["07"]["rpe_m"])
    assert (result / "result.txt").is_file()
