"""Parity of the PyTorch port's networks with the JAX package, on the CPU in
float32 at 64x96: Monodepth2 depth and LiteFlowNet in all three pair modes.

The JAX variables are the port's seeded initialisation
(``dfvo_torch.models.convert.init_state_dict``, the JAX package's
initialisers) converted to Flax trees by the JAX package's own numpy
converters (``dfvo_tpu/models/convert.py``), so no JAX initialisation is
compiled; ``test_converted_trees_match_init_variables`` holds the trees to
the structure of ``DeepFrontend.init_variables``. They reach the port
through the parameter bridge (``dfvo_torch.models.convert``). Biases and
batch-norm statistics, which initialise to zero or the identity, are
redrawn from a numpy seed so the bridge's handling of them is exercised;
the flow-delta heads are scaled up so the flows are several pixels and
every warp samples off the grid.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.models import LiteFlowNet as TLiteFlowNet
from dfvo_torch.models import Monodepth2Depth as TMonodepth2Depth
from dfvo_torch.models import convert as bridge
from dfvo_tpu.models import LiteFlowNet, Monodepth2Depth
from dfvo_tpu.models import convert as to_flax

H, W = 64, 96
DEFAULT_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "options/examples/default_configuration.yml")


def _numpy_state(sd):
    return {k: v.numpy() for k, v in sd.items()}


def depth_flax_from_port(sd):
    """A port ``Monodepth2Depth`` state dict -> the JAX package's Flax
    variables, split into the encoder and decoder dicts of the model zoo's
    ``encoder.pth`` and ``depth.pth``."""
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    return to_flax.convert_monodepth2_depth(_numpy_state(enc), _numpy_state(dec))


def lfn_flax_from_port(sd):
    """A port ``LiteFlowNet`` state dict -> the JAX package's Flax variables."""
    return to_flax.convert_liteflownet(_numpy_state(sd))


def seeded_flax_variables(seed):
    """Seeded random weights for both packages without a JAX compile: the
    port's ``init_state_dict`` (depth net, then flow net, from one
    generator), converted to Flax trees."""
    meta = torch.device("meta")
    gen = torch.Generator().manual_seed(seed)
    depth = bridge.init_state_dict(TMonodepth2Depth(device=meta), gen)
    flow = bridge.init_state_dict(TLiteFlowNet(device=meta), gen)
    return {"depth": depth_flax_from_port(depth), "flow": lfn_flax_from_port(flow)}


def _perturb(tree, rng, head_scale=1.0):
    """Numpy copy of a variable tree with biases, batch-norm scale and
    statistics redrawn, and flow-delta head kernels scaled."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "bias":
            return (0.05 * rng.randn(*a.shape)).astype(np.float32)
        if leaf in ("scale", "mean"):
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if leaf == "var":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if leaf == "kernel" and "main_3" in path and not any(
            p.startswith("regularization") for p in path
        ):
            return a * np.float32(head_scale)
        return a

    return walk(tree, ())


def _torch_state(sd):
    return {k: v.float() for k, v in sd.items()}


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return rng.rand(3, H, W, 3).astype(np.float32)


@pytest.fixture(scope="module")
def lfn_variables():
    # generator seed 3: with the heads scaled x40 its flows reach ~5 px
    # (seeds 0 and 1 stay under 1 px)
    flow = bridge.init_state_dict(TLiteFlowNet(device=torch.device("meta")),
                                  torch.Generator().manual_seed(3))
    return _perturb(lfn_flax_from_port(flow), np.random.RandomState(1), head_scale=40.0)


def _tree_shapes(tree):
    return {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_converted_trees_match_init_variables():
    """The converted trees have the keys and shapes of the JAX package's
    ``DeepFrontend.init_variables`` (traced by ``jax.eval_shape``, which
    compiles nothing)."""
    from dfvo_tpu.pipeline.frontend import DeepFrontend
    from dfvo_tpu.utils import ConfigLoader

    cfg = ConfigLoader().merge_cfg([DEFAULT_CFG])
    cfg.image.height, cfg.image.width = H, W
    want = jax.eval_shape(DeepFrontend(cfg).init_variables, jax.random.PRNGKey(0))
    got = seeded_flax_variables(0)
    assert _tree_shapes(got) == _tree_shapes(want)
    assert all(leaf.dtype == np.float32 for leaf in jax.tree_util.tree_leaves(got))


def test_monodepth2_depth_matches_jax(images):
    net = Monodepth2Depth()
    x = jnp.asarray(images[:2])
    depth = bridge.init_state_dict(TMonodepth2Depth(device=torch.device("meta")),
                                   torch.Generator().manual_seed(0))
    variables = _perturb(depth_flax_from_port(depth), np.random.RandomState(2))
    want = jax.jit(net.apply)(variables, x)

    port = TMonodepth2Depth()
    port.load_state_dict(bridge.monodepth2_depth_from_flax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(images[:2]))

    # float32 through ~20 conv layers in another summation order: relative
    # 1e-4 on depth, 1e-5 on sigmoid disparities in (0, 1)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-4)
    for s in (0, 1, 2, 3):
        np.testing.assert_allclose(got["disps"][s].numpy(),
                                   np.asarray(want["disps"][s]), atol=1e-5)


@pytest.mark.parametrize("pair_mode", ["two", "shared", "consecutive"])
def test_liteflownet_matches_jax(pair_mode, images, lfn_variables):
    net = LiteFlowNet()
    if pair_mode == "consecutive":
        img1 = img2 = images  # M = 3 unique frames -> 4 pairs
    elif pair_mode == "shared":
        img1, img2 = images[:2], images[1::-1]
    else:
        img1, img2 = images[:2], images[1:3]
    want = jax.jit(net.apply, static_argnames="pair_mode")(
        lfn_variables, jnp.asarray(img1), jnp.asarray(img2), pair_mode=pair_mode
    )

    port = TLiteFlowNet()
    port.load_state_dict(_torch_state(bridge.liteflownet_from_flax(lfn_variables)),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(img1)),
                   torch.from_numpy(np.ascontiguousarray(img2)),
                   pair_mode=pair_mode)

    assert sorted(got) == [1, 2, 3, 4, 5]
    assert np.abs(np.asarray(want[1])).max() > 1.0  # flows of pixels
    for lvl in range(1, 6):
        assert tuple(got[lvl].shape) == want[lvl].shape
        # float32 through five refinement levels, each warping by the
        # previous flow: 1e-3 px on flows of a few pixels
        np.testing.assert_allclose(got[lvl].numpy(), np.asarray(want[lvl]),
                                   atol=1e-3, err_msg=f"level {lvl}")


def test_bridge_inverts_the_torch_to_flax_converter(lfn_variables):
    """The bridge is the inverse of dfvo_tpu.models.convert: a port state
    dict converted back to Flax gives the original variables."""
    sd = {k: v.numpy() for k, v in
          bridge.liteflownet_from_flax(lfn_variables).items()}
    back = to_flax.convert_liteflownet(sd)
    leaves_a = jax.tree_util.tree_leaves_with_path(back)
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(lfn_variables))
    assert len(leaves_a) == len(leaves_b)
    for path, a in leaves_a:
        np.testing.assert_array_equal(a, leaves_b[path])


def test_init_state_dict_is_seeded_and_complete():
    net = TLiteFlowNet(device=torch.device("meta"))
    a = bridge.init_state_dict(net, torch.Generator().manual_seed(0))
    b = bridge.init_state_dict(net, torch.Generator().manual_seed(0))
    c = bridge.init_state_dict(net, torch.Generator().manual_seed(1))
    assert set(a) == set(net.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["moduleFeatures.moduleOne.0.weight"],
                           c["moduleFeatures.moduleOne.0.weight"])
    assert sum(v.numel() for v in a.values()) == 5381969
