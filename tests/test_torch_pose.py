"""The port's pose CNN and what uses it, on the CPU in float32, against the
JAX package where it runs the same function.

* ``transformation_from_parameters`` and ``Monodepth2Pose`` (64x96, the
  port's seeded weights carried to Flax by the JAX package's
  ``convert_monodepth2_pose`` and back by the bridge, biases and batch-norm
  statistics redrawn): within 1e-5.
* ``DeepFrontend``: the zoo's ``pose_encoder.pth`` / ``pose.pth`` read into
  the module's names, ``infer``'s ``deep_pose`` of the pair (ref, cur).
* the finetuning depth loss's pose sources, against the JAX package's
  ``_depth_pose`` on the same pose CNN output.
* ``tracking_method: deep_pose`` and depth consistency through the port's
  frame loop.
* the depth network at a height and width that are not multiples of 32
  (where the JAX package's depth network fails), fed at 64x96 and resized
  back: against the same composition of the JAX package's resize, depth
  network and disparity conversion, within relative 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.geometry import lie as T_lie
from dfvo_torch.models import Monodepth2Depth as TMonodepth2Depth
from dfvo_torch.models import Monodepth2Pose as TMonodepth2Pose
from dfvo_torch.models import convert as bridge
from dfvo_torch.pipeline.dfvo import DFVO as TDFVO
from dfvo_torch.pipeline.finetune import OnlineFinetuner as TFinetuner
from dfvo_torch.pipeline.frontend import DeepFrontend as TDeepFrontend
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils.io import load_poses_from_txt
from dfvo_tpu.geometry import lie as J_lie
from dfvo_tpu.models import Monodepth2Depth, Monodepth2Pose
from dfvo_tpu.models import convert as to_flax
from dfvo_tpu.models.layers import resize_bilinear as J_resize_bilinear
from dfvo_tpu.models.monodepth2 import disp_to_depth as J_disp_to_depth
from dfvo_tpu.pipeline.finetune import OnlineFinetuner as JFinetuner
from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend
from dfvo_tpu.utils import ConfigLoader
from tests.test_torch_dfvo import DEFAULT_CFG, N_FRAMES, _frame_cfg, tiny_kitti  # noqa: F401
from tests.test_torch_models import _numpy_state, _perturb, depth_flax_from_port

H, W = 64, 96


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def pose_variables(seed):
    """Seeded pose-CNN weights for both packages: the port's
    ``init_state_dict`` split into the zoo's encoder and decoder dicts,
    converted to Flax, biases and statistics redrawn, and carried back."""
    sd = bridge.init_state_dict(TMonodepth2Pose(device=torch.device("meta")),
                                torch.Generator().manual_seed(seed))
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    jvars = to_flax.convert_monodepth2_pose(_numpy_state(enc), _numpy_state(dec))
    jvars = _perturb(jvars, np.random.RandomState(seed))
    return jvars, bridge.monodepth2_pose_from_flax(jvars)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters_matches_jax(invert):
    rng = np.random.RandomState(int(invert))
    aa = (rng.randn(5, 3) * 0.3).astype(np.float32)
    aa[0] = 0.0  # the series branch at zero angle
    t = rng.randn(5, 3).astype(np.float32)
    want = J_lie.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t), invert=invert)
    got = T_lie.transformation_from_parameters(_t(aa), _t(t), invert=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_monodepth2_pose_matches_jax():
    """Monodepth2Pose on two stacked frames with carried weights: poses
    within 1e-5 of the JAX module's (translation x5.4); the bridge's state
    dict has exactly the module's keys and shapes."""
    jvars, tvars = pose_variables(0)
    template = bridge.init_state_dict(TMonodepth2Pose(device=torch.device("meta")),
                                      torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in tvars.items()} == {k: v.shape for k, v in template.items()}
    pair = np.random.RandomState(1).rand(2, H, W, 6).astype(np.float32)
    want = np.asarray(jax.jit(Monodepth2Pose(baseline_multiplier=5.4).apply)(
        jax.tree.map(jnp.asarray, jvars), jnp.asarray(pair)))
    net = TMonodepth2Pose(baseline_multiplier=5.4)
    net.load_state_dict(tvars)
    with torch.no_grad():
        got = net(_t(pair)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want[:, :3, 3]).max() > 100 * 1e-5  # the compared motion is not zero
    np.testing.assert_allclose(got[:, 3], np.tile([0, 0, 0, 1], (2, 1)), atol=0)


def _pose_cfg(**deep_pose):
    cfg = TConfigLoader().merge_cfg([DEFAULT_CFG])
    cfg.image.height, cfg.image.width = H, W
    cfg.tpu.dtype = "float32"
    cfg.deep_pose.enable = True
    for k, v in deep_pose.items():
        cfg.deep_pose[k] = v
    return cfg


def test_load_variables_reads_pose_checkpoints(tmp_path):
    """The zoo's pose_encoder.pth (torchvision names under ``encoder.``)
    and pose.pth (``net.0..3``) load into the pose CNN; without them the
    seeded init is drawn after the depth and flow networks', which stay as
    they are without the pose CNN."""
    _, tvars = pose_variables(3)
    enc = {k[len("encoder."):]: v for k, v in tvars.items() if k.startswith("encoder.")}
    enc["fc.weight"] = torch.zeros(1000, 512)  # the classifier the port leaves out
    dec = {k[len("decoder."):]: v for k, v in tvars.items() if k.startswith("decoder.")}
    torch.save(enc, tmp_path / "pose_encoder.pth")
    torch.save({"module." + k: v for k, v in dec.items()}, tmp_path / "pose.pth")
    fe = TDeepFrontend(_pose_cfg(pretrained_model=str(tmp_path)), "cpu")
    got = fe.load_variables(torch.Generator().manual_seed(0))
    assert set(got["pose"]) == set(tvars)
    for k, v in tvars.items():
        assert torch.equal(got["pose"][k], v), k
    seeded = TDeepFrontend(_pose_cfg(), "cpu").load_variables(torch.Generator().manual_seed(0))
    cfg = _pose_cfg()
    cfg.deep_pose.enable = False
    plain = TDeepFrontend(cfg, "cpu").load_variables(torch.Generator().manual_seed(0))
    assert "pose" not in plain
    for net in ("depth", "flow"):
        assert all(torch.equal(seeded[net][k], plain[net][k]) for k in plain[net])


def test_infer_returns_the_pose_of_the_pair():
    """``infer``'s deep_pose is the pose CNN on (ref, cur) stacked on the
    channels, in that order; ``infer_chunk`` has none."""
    fe = TDeepFrontend(_pose_cfg(), "cpu")
    variables = fe.prepare_variables(fe.init_variables(torch.Generator().manual_seed(0)))
    _, variables["pose"] = pose_variables(1)
    rng = np.random.RandomState(2)
    cur, ref = (_t(rng.rand(H, W, 3).astype(np.float32)) for _ in range(2))
    out = fe.infer(variables, cur, ref)
    net = TMonodepth2Pose()
    net.load_state_dict(variables["pose"])
    with torch.no_grad():
        want = net(torch.cat([ref, cur], dim=-1)[None])[0]
        swapped = net(torch.cat([cur, ref], dim=-1)[None])[0]
    assert torch.equal(out["deep_pose"], want) and not torch.equal(want, swapped)
    assert "deep_pose" not in fe.infer_chunk(variables, torch.stack([ref, cur]))


@pytest.mark.parametrize("pose_src", ["DF-VO", "deep_pose", "DF-VO2"])
def test_depth_loss_pose_sources_match_jax(pose_src, monkeypatch):
    """The depth loss's pose of each source, both packages, from the same
    DF-VO poses and the same pose CNN output (the networks are held to
    each other above): within 1e-6."""
    rng = np.random.RandomState(4)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :3, 3] = rng.randn(2, 3)
    deep = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    deep[:, :3, 3] = rng.randn(2, 3) * 0.1
    imgs = rng.rand(2, 2, H, W, 3).astype(np.float32)

    jcfg = ConfigLoader().merge_cfg([DEFAULT_CFG])
    tcfg = _pose_cfg()
    for cfg in (jcfg, tcfg):
        cfg.image.height, cfg.image.width = H, W
        cfg.deep_pose.enable = True
        cfg.online_finetune.enable = True
        cfg.online_finetune.depth.enable = True
        cfg.online_finetune.depth.pose_src = pose_src
    jfe = JDeepFrontend(jcfg)
    monkeypatch.setattr(jfe.pose_net, "apply", lambda v, pair: jnp.asarray(deep),
                        raising=False)
    want = JFinetuner(jfe, jcfg)._depth_pose({"pose": None}, *map(jnp.asarray, imgs),
                                             jnp.asarray(poses))
    tfe = TDeepFrontend(tcfg, "cpu")
    seen = []

    def pose_apply(pose_vars, img_ref, img_cur):
        seen.append(torch.equal(img_ref, _t(imgs[0])) and torch.equal(img_cur, _t(imgs[1])))
        return _t(deep)

    tfe.pose_apply = pose_apply
    got = TFinetuner(tfe, tcfg)._depth_pose({"pose": None}, *map(_t, imgs), _t(poses))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert seen == ([] if pose_src == "DF-VO" else [True])


def _run_pose_loop(kitti, tmp_path, edit):
    cfg = _frame_cfg(TConfigLoader, kitti, tmp_path)
    cfg.deep_pose.enable = True
    edit(cfg)
    vo = TDFVO(cfg, device="cpu")
    _, vo.variables["pose"] = pose_variables(5)
    vo.infer_variables = vo.frontend.prepare_variables(vo.variables)
    return vo


def test_deep_pose_tracking_mode(tiny_kitti, tmp_path):  # noqa: F811
    """``tracking_method: deep_pose`` in frame execution: every relative
    pose is the pose CNN's on the frame pair (mode 3, DeepPose), chained
    from the identity."""
    vo = _run_pose_loop(tiny_kitti, tmp_path, lambda c: setattr(c, "tracking_method",
                                                                "deep_pose"))
    steps = []
    run = vo.run_frame

    def run_frame(img_id, img=None):
        out = run(img_id, img=img)
        if vo.tracking_stage > 1:
            o = vo.cur_data["vo_out"]
            steps.append((int(o["mode"]), o["pose"].numpy().astype(np.float64)))
        return out

    vo.run_frame = run_frame
    vo.main()
    got = load_poses_from_txt(str(tmp_path / "07.txt"))
    assert sorted(got) == list(range(N_FRAMES)) and len(steps) == N_FRAMES - 1
    assert {m for m, _ in steps} == {3}
    T = np.eye(4)
    for i, (_, rel) in enumerate(steps, 1):
        T = T @ rel
        np.testing.assert_allclose(got[i], T, atol=1e-9)
    assert np.linalg.norm(T[:3, 3]) > 1e-3


def test_depth_consistency_in_the_frame_loop(tiny_kitti, tmp_path, monkeypatch):  # noqa: F811
    """Depth consistency under hybrid tracking: every tracked frame's step
    gets the pose CNN's pose and passes a depth-consistency map to the
    keypoint selector; finite poses."""
    from dfvo_torch.pipeline import tracking as T_tr

    calls = []
    real = T_tr.compute_depth_consistency

    def spy(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(T_tr, "compute_depth_consistency", spy)
    vo = _run_pose_loop(tiny_kitti, tmp_path,
                        lambda c: c.kp_selection.depth_consistency.__setitem__("enable", True))
    assert vo.tcfg.depth_consistency
    vo.main(num_frames=4)
    assert len(calls) == 3 and all(c.shape == (4, 4) for c in calls)
    poses = load_poses_from_txt(str(tmp_path / "07.txt"))
    assert sorted(poses) == [0, 1, 2, 3]
    assert all(np.isfinite(p).all() for p in poses.values())


def test_depth_network_feed_size():
    """At 70x100 (not multiples of 32) the JAX package's depth network
    fails at its skip connections. The port's frontend runs it at the feed
    size flow_target_size(70, 100, 32) = 64x96 and brings the scale-0
    disparity back to 70x100. Held to the same composition of the JAX
    package's own functions with the same carried weights: its
    ``resize_bilinear`` of the images with align_corners=True (its flow
    network's image feed), ``Monodepth2Depth`` at the feed, its
    ``resize_bilinear`` of the disparity with align_corners=False and
    ``disp_to_depth``. Depth within relative 1e-4, disparities within 1e-5
    (tests/test_torch_models.py's bounds). At 64x96 the feed is the image."""
    x = jnp.zeros((1, 70, 100, 3))
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(Monodepth2Depth().init, jax.random.PRNGKey(0), x)
    cfg = _pose_cfg()
    cfg.deep_pose.enable = False
    cfg.image.height, cfg.image.width = 70, 100
    fe = TDeepFrontend(cfg, "cpu")
    assert fe.depth_feed == (64, 96)
    kw = fe.depth_kw
    sd = bridge.init_state_dict(TMonodepth2Depth(device=torch.device("meta")),
                                torch.Generator().manual_seed(0))
    jvars = _perturb(depth_flax_from_port(sd), np.random.RandomState(2))
    tvars = {k: v.float() for k, v in bridge.monodepth2_depth_from_flax(jvars).items()}
    img = np.random.RandomState(0).rand(2, 70, 100, 3).astype(np.float32)

    def jax_depth(variables, imgs):
        feed = J_resize_bilinear(imgs, 64, 96, align_corners=True)
        disps = Monodepth2Depth(**kw).apply(variables, feed)["disps"]
        disp0 = J_resize_bilinear(disps[0], 70, 100, align_corners=False)
        _, depth = J_disp_to_depth(disp0, kw["min_depth"], kw["max_depth"])
        return depth[..., 0] * kw["baseline_multiplier"], disps

    want, want_disps = jax.jit(jax_depth)(jvars, jnp.asarray(img))
    with torch.no_grad():
        got = fe._depth({"depth": tvars}, _t(img))
        out = fe.depth_apply(tvars, _t(img))
    assert got.shape == (2, 70, 100) and torch.equal(out["depth"], got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    for s in (0, 1, 2, 3):
        np.testing.assert_allclose(out["disps"][s].numpy(), np.asarray(want_disps[s]),
                                   atol=1e-5)
    assert out["disps"][0].shape == (2, 64, 96, 1)
    assert TDeepFrontend(_pose_cfg(), "cpu").depth_feed == (H, W)
