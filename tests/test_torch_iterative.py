"""Iterative scale recovery through the port's two executions, on the CPU
in float32, and the shipped configurations that the tracking options
unblock, through the port's CLI.

* ``ablation_scale_iterative.yml`` (rigid-flow keypoints, iterative scale)
  through both packages' ``DFVO.main`` at 64x96 on tests/test_torch_dfvo.py's
  sequence and weights, in frame execution: every pose within 1e-5.
* The port's iterative chunk step (a network stub of zeros, an oracle
  chunk at 64x96 of coherent E frames, a frame whose scale jumps x30 and
  one whose depth lies past max_depth) against its own frame steps; the
  JAX package's chunk step is held against the port's in
  tests/test_torch_tracking_options.py.
* ``kitti_{stereo,mono_sc}_train_extend``, ``ablation_scale_iterative`` and
  the ``best_n`` / ``uniform`` correspondence ablations through
  ``python -m dfvo_torch.apis.run`` in both executions.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.models import convert as bridge
from dfvo_torch.pipeline import scan_runner as T_scan
from dfvo_torch.pipeline import tracking as T_tr
from dfvo_torch.pipeline.dfvo import DFVO as TDFVO
from dfvo_torch.synth.oracle import make_oracle_sequence
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils import prng
from dfvo_torch.utils.io import load_poses_from_txt
from dfvo_tpu.pipeline import DFVO as JDFVO
from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend
from dfvo_tpu.utils import ConfigLoader
from tests.test_torch_dfvo import (DEFAULT_CFG, N_FRAMES, REPO, _frame_cfg,  # noqa: F401
                                   split_jax_step, tiny_kitti)
from tests.test_torch_models import _perturb, seeded_flax_variables

H, W = 64, 96
K = np.array([[55.0, 0, 48.0], [0, 55.0, 32.0], [0, 0, 1.0]], np.float32)
K_inv = np.linalg.inv(K).astype(np.float32)
ITERATIVE_CFG = os.path.join(REPO, "options/examples/ablation_scale_iterative.yml")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _iterative_cfg(loader, root, result_dir, execution="frame"):
    cfg = loader().merge_cfg([DEFAULT_CFG, ITERATIVE_CFG])
    base = _frame_cfg(loader, root, result_dir)
    for key in ("seq", "image", "directory", "visualization", "tpu"):
        cfg[key] = base[key]
    cfg.tpu.execution = execution
    return cfg


def test_dfvo_main_iterative_matches_jax(tiny_kitti, tmp_path, monkeypatch):  # noqa: F811
    """ablation_scale_iterative.yml through both packages' DFVO.main in
    frame execution, on the weights of test_dfvo_main_matches_jax: every
    pose within 1e-5 (float32 steps chained over 7 frames). The JAX loop's
    frame step runs as its two jitted halves (tests/test_torch_dfvo.py
    ``split_jax_step``)."""
    jvars = seeded_flax_variables(0)
    jvars["flow"] = _perturb(jvars["flow"], np.random.RandomState(0), head_scale=10.0)
    monkeypatch.setattr(JDeepFrontend, "init_variables",
                        lambda self, rng: jax.tree.map(jnp.asarray, jvars))
    jcfg = _iterative_cfg(ConfigLoader, tiny_kitti, tmp_path / "jax")
    assert jcfg.scale_recovery.method == "iterative"
    split_jax_step(JDFVO(jcfg)).main()

    tvo = TDFVO(_iterative_cfg(TConfigLoader, tiny_kitti, tmp_path / "torch"), device="cpu")
    assert tvo.tcfg.scale_method == "iterative"
    tvo.variables = {"depth": bridge.monodepth2_depth_from_flax(jvars["depth"]),
                     "flow": bridge.liteflownet_from_flax(jvars["flow"])}
    tvo.infer_variables = tvo.frontend.prepare_variables(tvo.variables)
    tvo.main()

    want = load_poses_from_txt(str(tmp_path / "jax" / "07.txt"))
    got = load_poses_from_txt(str(tmp_path / "torch" / "07.txt"))
    assert sorted(got) == sorted(want) == list(range(N_FRAMES))
    assert max(np.linalg.norm(p[:3, 3]) for p in want.values()) >= 100 * 1e-5
    for i in want:
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, err_msg=f"frame {i}")


class _TorchZeros:
    """A frontend stub: zero network outputs, so a chunk step with an
    oracle tracks the oracle."""

    def infer_chunk(self, variables, all_imgs):
        m, h, w = all_imgs.shape[:3]
        z = torch.zeros((m - 1, h, w))
        return {"depths": z, "flow_fwd": torch.zeros((m - 1, h, w, 2)), "flow_diff": z}


def _oracle_chunk():
    """Five oracle pairs at 64x96: coherent E frames, pair 2's current
    depth divided by 30 (its scale jumps x30: the guard sends it to PnP),
    and pair 4's multiplied by 30 (past max_depth: its scale fails)."""
    depths, flows, _ = make_oracle_sequence(H, W, K, 6, seed=0, speed=3.0)
    depths = [np.asarray(d) for d in depths]
    depths[3] = depths[3] / 30.0
    depths[5] = depths[5] * 30.0
    oracle = {"depths": np.stack(depths[1:]), "flow_fwd": np.stack(flows),
              "flow_diff": np.full((5, H, W), 0.01, np.float32)}
    return depths[0], oracle


TCFG = T_tr.TrackingConfig(height=H, width=W, num_hypotheses=32, scale_method="iterative",
                           scale_max_trials=256)


def _port_chunk(depth0, oracle, prev_scale=1.0):
    chunk_step, _ = T_scan.make_chunk_step(_TorchZeros(), TCFG)
    info = {}
    poses, modes, carry = chunk_step(
        None, torch.zeros((5, H, W, 3), dtype=torch.uint8),
        (torch.zeros(H, W, 3, dtype=torch.uint8), _t(depth0), torch.eye(4), prev_scale),
        _t(prng.step_keys(0, range(1, 6)).astype(np.int64)), _t(K), _t(K_inv),
        oracle={k: _t(v) for k, v in oracle.items()}, info=info)
    return poses.numpy(), modes, carry, info


def test_iterative_chunk_equals_frame_steps():
    """The port's iterative chunk (batched keypoints, E and PnP; the scale
    stage frame by frame) against its frame steps in order, each with the
    previous frame's pose and scale, seeded with a running scale of 2.0:
    modes and scales equal, poses within 1e-5."""
    depth0, oracle = _oracle_chunk()
    tposes, tmodes, tcarry, info = _port_chunk(depth0, oracle, prev_scale=2.0)
    depth_refs = [depth0] + list(oracle["depths"][:-1])
    motion, scale = torch.eye(4), torch.tensor(2.0)
    for i in range(5):
        out = T_tr.tracking_step(
            prng.fold_in(prng.PRNGKey(0), i + 1), _t(oracle["flow_fwd"][i]),
            _t(oracle["flow_diff"][i]), _t(oracle["depths"][i]), _t(depth_refs[i]), motion,
            _t(K), _t(K_inv), TCFG, prev_scale=scale)
        assert int(out["mode"]) == int(tmodes[i]), f"frame {i}"
        np.testing.assert_allclose(float(out["scale"]), info["scale"][i], rtol=1e-6)
        np.testing.assert_allclose(tposes[i], out["pose"].numpy(), atol=1e-5)
        motion, scale = out["pose"], torch.where(out["scale"] > 0, out["scale"], scale)
    np.testing.assert_allclose(float(tcarry[3]), float(scale), rtol=1e-6)


@pytest.fixture(scope="module")
def short_kitti(tmp_path_factory):
    """tiny_kitti's first three frames."""
    import cv2

    root = tmp_path_factory.mktemp("kitti_short")
    img_dir = root / "odom_data" / "07" / "image_2"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(3)
    big = cv2.GaussianBlur((rng.rand(200, 600, 3) * 255).astype(np.uint8), (0, 0), 2)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"{i:06d}.jpg"), big[20:140, 8 * i : 8 * i + 400])
    (root / "odom_data" / "07" / "calib.txt").write_text(
        "".join(f"P{j}: 230.0 0.0 200.0 0.0 0.0 230.0 60.0 0.0 0.0 0.0 1.0 0.0\n"
                for j in range(4)))
    return root


@pytest.mark.parametrize("execution", ["frame", "scan"])
@pytest.mark.parametrize("name", [
    "kitti_stereo_train_extend", "kitti_mono_sc_train_extend", "ablation_scale_iterative",
    "ablation_correspondences_best_n", "ablation_correspondences_uniform",
])
def test_shipped_tracking_configurations_run(short_kitti, tmp_path, name, execution):
    """Each shipped configuration that needs a ported tracking option,
    merged on the default, through ``python -m dfvo_torch.apis.run
    --device cpu`` at 64x96 (32 hypotheses, float32, chunks of 2): one
    finite pose per frame, the options in the annotated configuration."""
    import yaml

    from dfvo_torch.apis import run

    result = tmp_path / "result"
    with open(os.path.join(REPO, "options/examples", f"{name}.yml")) as f:
        custom = yaml.safe_load(f)
    overrides = {
        "seq": "07", "image": {"height": 64, "width": 96},
        "directory": {"img_seq_dir": str(short_kitti / "odom_data"), "gt_pose_dir": None,
                      "result_dir": str(result)},
        "visualization": {"enable": False},
        "tpu": {"ransac_hypotheses": 32, "dtype": "float32", "execution": execution,
                "scan_chunk": 2},
    }
    for key, value in overrides.items():
        custom[key] = {**custom.get(key, {}), **value} if isinstance(value, dict) else value
    (tmp_path / "custom.yml").write_text(yaml.safe_dump(custom))
    vo = run.main(["-d", DEFAULT_CFG, "-c", str(tmp_path / "custom.yml"), "--no_confirm",
                   "--device", "cpu"])
    poses = load_poses_from_txt(str(result / "07.txt"))
    assert sorted(poses) == [0, 1, 2]
    assert all(np.isfinite(p).all() for p in poses.values())
    want = {"kitti_stereo_train_extend": ("local_bestN", "iterative"),
            "kitti_mono_sc_train_extend": ("local_bestN", "iterative"),
            "ablation_scale_iterative": ("local_bestN", "iterative"),
            "ablation_correspondences_best_n": ("bestN", "simple"),
            "ablation_correspondences_uniform": ("sampled", "simple")}[name]
    assert (vo.tcfg.kp_method, vo.tcfg.scale_method) == want
    assert (vo.finetuner is not None) == ("extend" in name)
