"""Parity of the PyTorch port's networks with the JAX package, on the CPU in
float32 at 64x96: Monodepth2 depth and LiteFlowNet in all three pair modes.

The JAX variables come from ``DeepFrontend.init_variables(PRNGKey(0))``'s
initialisers and reach the port through the parameter bridge
(``dfvo_torch.models.convert``). Biases and batch-norm statistics, which
initialise to zero or the identity, are redrawn from a numpy seed so the
bridge's handling of them is exercised; the flow-delta heads are scaled up
so the flows are several pixels and every warp samples off the grid.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.models import LiteFlowNet as TLiteFlowNet
from dfvo_torch.models import Monodepth2Depth as TMonodepth2Depth
from dfvo_torch.models import convert as bridge
from dfvo_tpu.models import LiteFlowNet, Monodepth2Depth

H, W = 64, 96


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
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(LiteFlowNet().init)(jax.random.PRNGKey(0), x, x)
    return _perturb(jax.device_get(v), np.random.RandomState(1), head_scale=40.0)


def test_monodepth2_depth_matches_jax(images):
    net = Monodepth2Depth()
    x = jnp.asarray(images[:2])
    variables = _perturb(
        jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), x)),
        np.random.RandomState(2),
    )
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
    from dfvo_tpu.models import convert as to_flax

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
