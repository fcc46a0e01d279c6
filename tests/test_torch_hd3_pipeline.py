"""HD3 through the port's frontend, online finetuning and frame loop against
the JAX package, on the CPU in float32 at 64x96 (HD3's feed 64x128): the
configuration of tests/test_scan_runner.py::test_cli_hd3_tracking_scan_matches_frame.

* ``DeepFrontend.infer`` and ``infer_chunk`` with ``deep_flow.network:
  hd3`` against the JAX package's jitted ones.
* The HD3 flow loss and its gradient against the JAX package's
  ``flow_loss`` under ``jax.value_and_grad`` (its ``update``).
* ``DFVO.main`` with HD3 in frame execution against the JAX package's
  (tests/test_torch_dfvo.py's layout), and the port's scan execution
  against its frame execution; both executions with HD3 flow finetuning.

The weights are the port's seeded initialisation converted by the JAX
package's converters (tests/test_torch_hd3.py), with each level's
classifier scaled down and its centre class raised, so that HD3's flows
are a pixel or two (the frontend tests) or about 0.01 px (the frame loop,
where every pixel passes the forward-backward check; at about 0.06 px
the check's 0.1 px threshold falls among the pixels, and a pixel on it
flips between the packages under rounding).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.models import convert as bridge
from dfvo_torch.models import Monodepth2Depth as TMonodepth2Depth
from dfvo_torch.pipeline.dfvo import DFVO as TDFVO
from dfvo_torch.pipeline.finetune import OnlineFinetuner as TFinetuner
from dfvo_torch.pipeline.frontend import DeepFrontend as TDeepFrontend
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils.io import load_poses_from_txt
from dfvo_tpu.pipeline import DFVO as JDFVO
from dfvo_tpu.pipeline.finetune import OnlineFinetuner as JFinetuner
from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend
from dfvo_tpu.utils import ConfigLoader
from tests.test_torch_dfvo import (N_FRAMES, _frame_cfg, _record_frames,  # noqa: F401
                                   jax_infer, split_jax_step, tiny_kitti)
from tests.test_torch_hd3 import seeded_hd3_variables
from tests.test_torch_models import DEFAULT_CFG, depth_flax_from_port

LR = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def hd3_variables(kernel_scale, centre_logit):
    """Both packages' variables (depth seed 0, HD3 seed 0): each level's
    classifier kernel scaled by ``kernel_scale``, its bias ``centre_logit``
    on the zero-motion class and 0 elsewhere. Built once per process
    (about 54 M parameters); callers copy what they change."""
    depth = bridge.init_state_dict(TMonodepth2Depth(device=torch.device("meta")),
                                   torch.Generator().manual_seed(0))
    flow = seeded_hd3_variables(0)
    for l in range(5):
        cls = flow["params"][f"Decoder_{l}"]["cls_2"]
        cls["kernel"] = cls["kernel"] * np.float32(kernel_scale)
        cls["bias"] = np.zeros(81, np.float32)
        cls["bias"][40] = centre_logit
    jvars = {"depth": depth_flax_from_port(depth), "flow": flow}
    tvars = {"depth": depth, "flow": bridge.hd3_from_flax(flow)}
    return jvars, tvars


def _hd3_cfg(loader):
    cfg = loader().merge_cfg([DEFAULT_CFG])
    cfg.image.height, cfg.image.width = 64, 96
    cfg.deep_flow.network = "hd3"
    cfg.tpu.dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def hd3_frontends():
    """Both frontends with HD3 flows of a pixel or two, and 4 frames."""
    jvars, tvars = hd3_variables(0.3, 4.0)
    jfe = JDeepFrontend(_hd3_cfg(ConfigLoader))
    tfe = TDeepFrontend(_hd3_cfg(TConfigLoader), "cpu")
    imgs = np.random.RandomState(0).rand(4, 64, 96, 3).astype(np.float32)
    return jfe, jax.tree.map(jnp.asarray, jvars), tfe, tfe.prepare_variables(tvars), imgs


def _assert_close(got, want, keys):
    # depth: float32 through the ResNet-18 encoder and decoder, relative
    # 1e-4; flows (about 2 px) and flow_diff: float32 through the DLA-34
    # trunk and five HD3 levels, 1e-4 px
    for key in keys:
        assert tuple(got[key].shape) == want[key].shape, key
        if key.startswith("depth"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4)
        else:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                       err_msg=key)


def test_hd3_infer_matches_jax(hd3_frontends):
    jfe, jvars, tfe, tvars, imgs = hd3_frontends
    assert tfe.flow_feed == jfe.flow_feed == (64, 128)
    want = jax_infer(jfe)(jvars, jnp.asarray(imgs[1]), jnp.asarray(imgs[0]))
    got = tfe.infer(tvars, _t(imgs[1]), _t(imgs[0]))
    assert 0.5 < float(got["flow_fwd"].abs().max()) < 10.0
    _assert_close(got, want, ("depth_cur", "flow_fwd", "flow_bwd", "flow_diff"))


def test_hd3_infer_chunk_matches_jax(hd3_frontends):
    jfe, jvars, tfe, tvars, imgs = hd3_frontends
    want = jax.jit(jfe.infer_chunk)(jvars, jnp.asarray(imgs))
    got = tfe.infer_chunk(tvars, _t(imgs))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "depths": (3, 64, 96), "flow_fwd": (3, 64, 96, 2), "flow_diff": (3, 64, 96)}
    _assert_close(got, want, ("depths", "flow_fwd", "flow_diff"))
    # pair i of the chunk is infer's (frame i -> frame i + 1)
    one = tfe.infer(tvars, _t(imgs[2]), _t(imgs[1]))
    np.testing.assert_allclose(got["flow_fwd"][1].numpy(), one["flow_fwd"].numpy(), atol=1e-5)


def test_hd3_flow_loss_and_gradient_match_jax():
    """The flow finetuning loss and its gradient, from one update of both
    packages on the same weights and images, in the configuration of
    tests/test_finetune.py::test_online_finetune_hd3_flow (flow scale 1,
    depth off; that test's JAX program). The JAX ``update`` is
    ``jax.value_and_grad`` of ``flow_loss``, then Adam, whose first step's
    first moment is (1 - b1) times the gradient."""
    jvars, tvars = hd3_variables(0.3, 4.0)
    cfgs = {}
    for name, loader in (("jax", ConfigLoader), ("torch", TConfigLoader)):
        cfg = loader().merge_cfg([DEFAULT_CFG])
        cfg.image.height, cfg.image.width = 64, 96
        cfg.deep_flow.network = "hd3"
        cfg.online_finetune.enable = True
        cfg.online_finetune.flow.enable = True
        cfg.online_finetune.flow.scales = [1]
        cfg.online_finetune.depth.enable = False
        cfgs[name] = cfg
    K = np.array([[50.0, 0, 48], [0, 50.0, 32], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(8)
    img_ref, img_cur = (rng.rand(64, 96, 3).astype(np.float32) for _ in range(2))

    jft = JFinetuner(JDeepFrontend(cfgs["jax"]), cfgs["jax"])
    variables = jax.tree.map(jnp.asarray, jvars)
    state = jft.init_state(variables, K, np.linalg.inv(K))
    _, state, j_loss = jft.update(variables, state, jnp.asarray(img_ref), jnp.asarray(img_cur),
                                  jnp.eye(4, dtype=jnp.float32))
    j_grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(1 - 0.9), state[0].mu["flow"])

    tfe = TDeepFrontend(cfgs["torch"], "cpu")
    tft = TFinetuner(tfe, cfgs["torch"])
    tft.init_state(tvars, K, np.linalg.inv(K))
    loss, grads = tft.value_and_grad(tvars, _t(img_ref)[None], _t(img_cur)[None],
                                     torch.eye(4)[None])

    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    want = bridge.hd3_from_flax({"params": j_grads, "batch_stats": jvars["flow"]["batch_stats"]})
    keys = tfe.trainable_keys("flow")
    assert set(grads["flow"]) == set(keys)
    # tensors that reach no level (the encoder's finest aggregation node;
    # the projections of the two-level trees, whose subtrees project their
    # own residual) get zero gradients in both packages
    unused = [k for k in keys if not want[k].any()]
    assert any(".ida_4." in k for k in unused) and any(".project." in k for k in unused)
    assert not any(grads["flow"][k].any() for k in unused)
    got = np.concatenate([grads["flow"][k].numpy().ravel() for k in keys])
    ref = np.concatenate([want[k].numpy().ravel() for k in keys])
    assert np.count_nonzero(ref) > 0.25 * ref.size
    # float32 backpropagation through the trunk, the warps and five levels
    # in another summation order: the whole gradient within 1e-4 of its norm
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4


def _loop_cfg(loader, root, result_dir, execution="frame"):
    cfg = _frame_cfg(loader, root, result_dir)
    cfg.deep_flow.network = "hd3"
    cfg.tpu.execution = execution
    return cfg


def _port_main(cfg, tvars, num_frames=None):
    vo = TDFVO(cfg, device="cpu")
    vo.variables = tvars
    vo.infer_variables = vo.frontend.prepare_variables(tvars)
    frames = _record_frames(vo)
    vo.main(num_frames=num_frames)
    return vo, frames, load_poses_from_txt(os.path.join(cfg.directory.result_dir, "07.txt"))


def test_dfvo_main_hd3_matches_jax(tiny_kitti, tmp_path, monkeypatch):
    """DFVO(cfg).main() with HD3 in frame execution in both packages on the
    same weights (flows of about 0.01 px, every pixel passing the
    forward-backward check, PnP on every frame): every pose within 1e-5,
    modes, valid keypoints and inliers equal; then the port's
    scan execution (chunks of 3, the last padded) against its frame
    execution. The JAX loop's frame step runs as its two jitted halves
    (tests/test_torch_dfvo.py ``split_jax_step``)."""
    jvars, tvars = hd3_variables(0.1, 10.0)
    monkeypatch.setattr(JDeepFrontend, "init_variables",
                        lambda self, rng: jax.tree.map(jnp.asarray, jvars))
    jvo = split_jax_step(JDFVO(_loop_cfg(ConfigLoader, tiny_kitti, tmp_path / "jax")))
    j_frames = _record_frames(jvo)
    jvo.main()

    _, t_frames, got = _port_main(_loop_cfg(TConfigLoader, tiny_kitti, tmp_path / "torch"),
                                  tvars)
    want = load_poses_from_txt(str(tmp_path / "jax" / "07.txt"))
    assert sorted(got) == sorted(want) == list(range(N_FRAMES))
    # the compared motion lies far above the tolerance
    assert max(np.linalg.norm(p[:3, 3]) for p in want.values()) >= 100 * 1e-5
    for i in want:
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, err_msg=f"frame {i}")
    assert len(t_frames) == len(j_frames) == N_FRAMES - 1
    assert all(j[2] > 0 for j in j_frames)
    for i, (t, j) in enumerate(zip(t_frames, j_frames), 1):
        assert (t[0], t[2], t[3]) == (j[0], j[2], j[3]), f"frame {i}"

    # the scan execution pairs the frames in other batches: within 1e-4
    _, _, scan = _port_main(_loop_cfg(TConfigLoader, tiny_kitti, tmp_path / "scan", "scan"),
                            tvars)
    assert sorted(scan) == list(range(N_FRAMES))
    for i in got:
        np.testing.assert_allclose(scan[i], got[i], atol=1e-4, err_msg=f"scan frame {i}")


@pytest.mark.parametrize("execution", ["frame", "scan"])
def test_hd3_flow_finetuning_runs_in_both_executions(tiny_kitti, tmp_path, execution):
    """Online flow finetuning of HD3 (scales 1-5) through ``DFVO.main`` over
    3 frames: one Adam step per tracked pair moves the HD3 weights
    (the batch-norm statistics stay), the poses are finite, and the
    finetuned model is saved."""
    _, tvars = hd3_variables(0.1, 10.0)
    cfg = _loop_cfg(TConfigLoader, tiny_kitti, tmp_path, execution)
    cfg.online_finetune.enable = True
    cfg.online_finetune.save_model = True
    cfg.online_finetune.num_frames = 2
    cfg.online_finetune.flow.enable = True
    cfg.online_finetune.flow.scales = [1, 2, 3, 4, 5]
    cfg.online_finetune.depth.enable = False
    vo, _, poses = _port_main(cfg, {net: {k: v.clone() for k, v in sd.items()}
                                    for net, sd in tvars.items()}, num_frames=3)
    assert vo.finetuner.train_flow and not vo.finetuner.train_depth
    assert vo.finetune_cnt == 2 and vo.opt_state["count"] == 2
    assert sorted(poses) == [0, 1, 2]
    assert all(np.isfinite(p).all() for p in poses.values())
    keys = vo.frontend.trainable_keys("flow")
    moved = max(float((vo.variables["flow"][k] - tvars["flow"][k]).abs().max()) for k in keys)
    assert moved > 1.5 * LR  # two Adam steps of about lr each
    assert all(torch.equal(vo.variables["flow"][k], tvars["flow"][k])
               for k in vo.variables["flow"] if k.endswith(("running_mean", "running_var")))
    assert (tmp_path / "finetuned_model").is_dir()
