"""Parity of the PyTorch port's frontend slice with the JAX package, on the
CPU in float32: ``DeepFrontend.infer`` and ``infer_chunk`` on 4 frames at
64x96 from the JAX initialisation (the configuration of
tests/test_infer_chunk.py, so the JAX programs are the same ones), and
``local_bestN`` on identical flow inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.matching import kp_selection as T_kp
from dfvo_torch.models import convert as bridge
from dfvo_torch.pipeline.frontend import DeepFrontend as TDeepFrontend
from dfvo_torch.pipeline.frontend import flow_target_size as t_flow_target_size
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_tpu.matching import kp_selection as J_kp
from dfvo_tpu.pipeline.frontend import DeepFrontend, flow_target_size
from dfvo_tpu.utils import ConfigLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options/examples/default_configuration.yml")


def _cfg(loader):
    cfg = loader().merge_cfg([DEFAULT_CFG])
    cfg.image.height = 64
    cfg.image.width = 96
    cfg.tpu.dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def slice_pair():
    """Both frontends with the same (JAX-initialised) weights, and 4 frames."""
    jfe = DeepFrontend(_cfg(ConfigLoader))
    jvars = jax.device_get(jax.jit(jfe.init_variables)(jax.random.PRNGKey(0)))
    tfe = TDeepFrontend(_cfg(TConfigLoader), "cpu")
    tvars = tfe.prepare_variables({
        "depth": bridge.monodepth2_depth_from_flax(jvars["depth"]),
        "flow": bridge.liteflownet_from_flax(jvars["flow"]),
    })
    imgs = np.random.RandomState(0).rand(4, 64, 96, 3).astype(np.float32)
    return jfe, jvars, tfe, tvars, imgs


def _assert_outputs_close(got, want, depth_key):
    # depth: float32 through the ResNet-18 encoder and decoder, relative
    # 1e-4; flows and flow_diff: float32 through five LiteFlowNet levels and
    # the consistency warp, 1e-3 px
    np.testing.assert_allclose(got[depth_key].numpy(), np.asarray(want[depth_key]),
                               rtol=1e-4)
    for key in ("flow_fwd", "flow_diff"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-3, err_msg=key)


def test_infer_matches_jax(slice_pair):
    jfe, jvars, tfe, tvars, imgs = slice_pair
    want = jax.jit(jfe.infer)(jvars, jnp.asarray(imgs[1]), jnp.asarray(imgs[0]))
    got = tfe.infer(tvars, torch.from_numpy(imgs[1]), torch.from_numpy(imgs[0]))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "depth_cur": (64, 96), "flow_fwd": (64, 96, 2),
        "flow_bwd": (64, 96, 2), "flow_diff": (64, 96),
    }
    _assert_outputs_close(got, want, "depth_cur")
    np.testing.assert_allclose(got["flow_bwd"].numpy(),
                               np.asarray(want["flow_bwd"]), atol=1e-3)


def test_infer_with_external_depth_skips_the_depth_net(slice_pair):
    _, _, tfe, tvars, imgs = slice_pair
    depth = torch.full((64, 96), 7.0, dtype=torch.float64)
    got = tfe.infer(tvars, torch.from_numpy(imgs[1]), torch.from_numpy(imgs[0]),
                    depth_cur=depth)
    assert got["depth_cur"].dtype == torch.float32
    assert torch.equal(got["depth_cur"], depth.float())


def test_infer_chunk_matches_jax(slice_pair):
    jfe, jvars, tfe, tvars, imgs = slice_pair
    want = jax.jit(jfe.infer_chunk)(jvars, jnp.asarray(imgs))
    got = tfe.infer_chunk(tvars, torch.from_numpy(imgs))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "depths": (3, 64, 96), "flow_fwd": (3, 64, 96, 2),
        "flow_diff": (3, 64, 96),
    }
    _assert_outputs_close(got, want, "depths")


def test_frontend_refuses_unported_options():
    cfg = _cfg(TConfigLoader)
    cfg.deep_flow.network = "hd3"
    with pytest.raises(NotImplementedError, match="HD3"):
        TDeepFrontend(cfg, "cpu")
    cfg = _cfg(TConfigLoader)
    cfg.deep_pose.enable = True
    with pytest.raises(NotImplementedError, match="Deep pose"):
        TDeepFrontend(cfg, "cpu")


def test_prepare_variables_follows_config_dtype():
    cfg = _cfg(TConfigLoader)
    cfg.tpu.dtype = "bfloat16"
    tfe = TDeepFrontend(cfg, "cpu")
    tvars = tfe.prepare_variables(tfe.init_variables(torch.Generator().manual_seed(0)))
    assert {v.dtype for sd in tvars.values() for v in sd.values()} == {torch.bfloat16}


def test_forward_backward_consistency_matches_jax():
    from dfvo_torch.pipeline.frontend import forward_backward_consistency as t_fbc
    from dfvo_torch.pipeline.frontend import resize_dense_flow as t_resize
    from dfvo_tpu.pipeline.frontend import forward_backward_consistency as j_fbc
    from dfvo_tpu.pipeline.frontend import resize_dense_flow as j_resize

    rng = np.random.RandomState(5)
    fwd = (rng.randn(2, 12, 20, 2) * 3).astype(np.float32)
    bwd = (rng.randn(2, 12, 20, 2) * 3).astype(np.float32)
    # a float32 warp and norm of pixel-sized values
    np.testing.assert_allclose(
        t_fbc(torch.from_numpy(fwd), torch.from_numpy(bwd)).numpy(),
        np.asarray(j_fbc(jnp.asarray(fwd), jnp.asarray(bwd))), atol=1e-5,
    )
    np.testing.assert_allclose(
        t_resize(torch.from_numpy(fwd), 48, 80).numpy(),
        np.asarray(j_resize(jnp.asarray(fwd), 48, 80)), atol=1e-5,
    )


@pytest.mark.parametrize("hw", [(64, 96), (192, 640), (370, 1226)])
def test_flow_target_size_matches_jax(hw):
    assert t_flow_target_size(*hw, 32) == flow_target_size(*hw, 32)


def _kp_inputs(seed, h, w, frac_consistent):
    rng = np.random.RandomState(seed)
    flow = (rng.randn(h, w, 2) * 4).astype(np.float32)
    flow_diff = rng.rand(h, w).astype(np.float32) * 0.2
    flow_diff[rng.rand(h, w) > frac_consistent] += 1.0
    if frac_consistent >= 0.5:
        # exact ties inside cells: lowest index must win on both sides
        flow_diff[::7, ::5] = 0.05
    return flow, flow_diff


@pytest.mark.parametrize(
    "h,w,score_method,frac,with_depth",
    [
        (64, 96, "flow", 0.8, False),
        (64, 96, "flow_ratio", 0.8, False),
        (192, 640, "flow", 0.5, False),
        (64, 96, "flow", 0.02, False),  # too few consistent pixels: not good
        (64, 96, "flow", 0.8, True),  # depth-consistency filter on top
    ],
)
def test_local_bestN_matches_jax(h, w, score_method, frac, with_depth):
    flow, flow_diff = _kp_inputs(h + w, h, w, frac)
    depth_diff = None
    if with_depth:
        depth_diff = np.random.RandomState(7).rand(h, w).astype(np.float32) * 0.1
    jspec = J_kp.KPSelectionSpec(h, w, 10, 10, 2000)
    tspec = T_kp.KPSelectionSpec(h, w, 10, 10, 2000)
    want = J_kp.local_bestN(
        jspec, jnp.asarray(flow), jnp.asarray(flow_diff), thre=0.1,
        score_method=score_method,
        depth_diff=None if depth_diff is None else jnp.asarray(depth_diff))
    got = T_kp.local_bestN(
        tspec, torch.from_numpy(flow), torch.from_numpy(flow_diff), thre=0.1,
        score_method=score_method,
        depth_diff=None if depth_diff is None else torch.from_numpy(depth_diff))
    np.testing.assert_array_equal(got["kp1"].numpy(), np.asarray(want["kp1"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert bool(got["good_kp_found"]) == bool(want["good_kp_found"])
    # kp2 = kp1 + flow at the selected pixel: one float32 add
    np.testing.assert_allclose(got["kp2"].numpy(), np.asarray(want["kp2"]),
                               atol=1e-6)
    np.testing.assert_allclose(got["fb_flow_mask"].numpy(),
                               np.asarray(want["fb_flow_mask"]), rtol=1e-6)
    if frac < 0.1:
        assert not bool(got["good_kp_found"])


def test_cell_table_matches_jax():
    np.testing.assert_array_equal(
        T_kp.cell_index_table(192, 640, 10, 10),
        J_kp.cell_index_table(192, 640, 10, 10),
    )
