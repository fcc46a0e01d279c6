"""Parity of the PyTorch port's HD3 network with the JAX package, on the CPU
in float32: the distribution ops (``models/hd3_ops.py``), ``HD3Net`` in the
frontend's configuration (flow, DLA-34 encoder, HDA decoders) and in the
other options (stereo, VGG encoder, ResNet decoders, the context head) at
every level, the training losses (``models/hd3_losses.py``), the parameter
bridge and the model zoo's checkpoint layout.

The JAX variables are the port's seeded initialisation
(``init_state_dict``) converted by the JAX package's own HD3 converter
(``dfvo_tpu/models/convert.py`` ``convert_hd3``), so no JAX initialisation
is compiled; biases and batch-norm statistics are redrawn from a numpy seed
(tests/test_torch_models.py ``_perturb``). The images are 64x128, the
frontend's feed for the JAX suite's 64x96 frames.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.models import convert as bridge
from dfvo_torch.models import hd3_losses as T_loss
from dfvo_torch.models import hd3_ops as T_ops
from dfvo_torch.models.hd3 import HD3Net as THD3Net
from dfvo_tpu.models import convert as to_flax
from dfvo_tpu.models import hd3_losses as J_loss
from dfvo_tpu.models import hd3_ops as J_ops
from dfvo_tpu.models.hd3 import HD3Net
from tests.test_torch_models import _perturb

FEED = (64, 128)
FRONTEND = dict(task="flow", encoder="dlaup", decoder="hda", corr_range=(4, 4, 4, 4, 4),
                context=False)
OTHER = dict(task="stereo", encoder="vgg", decoder="resnet", corr_range=(4, 4, 4, 4, 4),
             context=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def hd3_flax_from_port(sd):
    """A port ``HD3Net`` state dict -> the JAX package's Flax variables
    (the reference torch names through ``convert_hd3``)."""
    return to_flax.convert_hd3({k: v.numpy() for k, v in sd.items()})


def seeded_hd3_variables(seed, config=FRONTEND, perturb_seed=None):
    """Seeded HD3 weights for both packages without a JAX compile: the
    port's ``init_state_dict`` converted to a Flax tree, biases and
    batch-norm statistics redrawn when ``perturb_seed`` is given."""
    sd = bridge.init_state_dict(THD3Net(**config, device=torch.device("meta")),
                                torch.Generator().manual_seed(seed))
    tree = hd3_flax_from_port(sd)
    if perturb_seed is not None:
        tree = _perturb(tree, np.random.RandomState(perturb_seed))
    return tree


@functools.lru_cache(maxsize=None)
def _jax_hd3(config_items):
    return jax.jit(HD3Net(**dict(config_items)).apply)


def jax_hd3(config, variables, img1, img2):
    return _jax_hd3(tuple(sorted(config.items())))(variables, jnp.asarray(img1),
                                                   jnp.asarray(img2))


def _pair(seed):
    rng = np.random.RandomState(seed)
    img1 = rng.rand(2, *FEED, 3).astype(np.float32)
    img2 = np.clip(img1 + 0.05 * rng.randn(2, *FEED, 3), 0, 1).astype(np.float32)
    return img1, img2


def _assert_levels_close(got, want):
    """ms_prob and ms_vect at every level. Float32 through the trunk, five
    cost volumes and decoders, each level warping by the one before:
    logits within 1e-4 (measured 1.4e-5 on logits up to 12), vectors in
    full-resolution units within 5e-4 (measured 6.1e-5 on vectors up to
    310)."""
    (t_prob, t_vect), (j_prob, j_vect) = got, want
    assert len(t_prob) == len(j_prob) == len(t_vect) == len(j_vect) == 5
    for lvl in range(5):
        assert tuple(t_prob[lvl].shape) == j_prob[lvl].shape
        assert tuple(t_vect[lvl].shape) == j_vect[lvl].shape
        np.testing.assert_allclose(t_prob[lvl].numpy(), np.asarray(j_prob[lvl]), atol=1e-4,
                                   err_msg=f"ms_prob level {lvl}")
        np.testing.assert_allclose(t_vect[lvl].numpy(), np.asarray(j_vect[lvl]), atol=5e-4,
                                   err_msg=f"ms_vect level {lvl}")


# -- the distribution ops -------------------------------------------------------------

def _logits_with_ties(rng, n, h, w, c):
    """Random logits with one pixel of equal logits (every 2x2 block ties:
    argmax takes the first) and one with two equal peaks."""
    x = (3 * rng.randn(n, h, w, c)).astype(np.float32)
    x[0, 0, 0] = 0.5
    x[0, 0, 1] = 0.0
    x[0, 0, 1, [0, c - 1]] = 4.0
    return x


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _op_cases(rng):
    flow = (2.5 * rng.randn(2, 5, 7, 2)).astype(np.float32)
    flow[0, 0, 0] = [9.0, -9.0]  # outside the support
    flow[0, 0, 1] = [1.0, -2.0]  # on the grid
    disp = (2.5 * rng.randn(2, 5, 7, 1)).astype(np.float32)
    x = rng.randn(2, 6, 8, 3).astype(np.float32)
    warp = (3 * rng.randn(2, 6, 8, 2)).astype(np.float32)
    logits81 = _logits_with_ties(rng, 2, 3, 4, 81)
    logits9 = _logits_with_ties(rng, 2, 3, 4, 9)
    vec = (4 * rng.randn(2, 3, 5, 2)).astype(np.float32)
    return {
        "flow_warp": ("flow_warp", (x, warp), {}),
        "flow_warp_mask": ("flow_warp", (x, warp), {"mul": False}),
        "disp2flow": ("disp2flow", (disp,), {}),
        "vector2density_dim2": ("vector2density", (flow, 4, 2), {}),
        "vector2density_dim1": ("vector2density", (disp, 4, 1), {}),
        "flow2distribution_c2": ("_flow2distribution", (flow, 2), {}),
        "prob2cornerflow": ("_prob2cornerflow", (logits81,), {}),
        "density2vector_dim2": ("density2vector", (logits81, 2), {}),
        "density2vector_dim2_probs": ("density2vector", (_softmax(logits81), 2),
                                      {"normalize": False}),
        "density2vector_dim1": ("density2vector", (logits9, 1), {}),
        "disp_prob2flow_prob": ("_disp_prob2flow_prob", (logits9,), {}),
        "prob_gather_dim2": ("prob_gather", (logits81,), {}),
        "prob_gather_dim1": ("prob_gather", (logits9,), {"dim": 1}),
        "resize_dense_vector_2": ("resize_dense_vector", (vec, 7, 12), {}),
        "resize_dense_vector_1": ("resize_dense_vector", (vec[..., :1], 7, 12), {}),
    }


OPS = sorted(_op_cases(np.random.RandomState(0)))


@pytest.mark.parametrize("case", OPS)
def test_hd3_ops_match_jax(case):
    name, args, kw = _op_cases(np.random.RandomState(OPS.index(case)))[case]
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    got = getattr(T_ops, name)(*targs, **kw)
    want = getattr(J_ops, name)(*jargs, **kw)
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        assert tuple(g.shape) == w.shape
        # the same float32 ops; the corner choice and the one-hot labels
        # exactly equal
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_density2vector_takes_the_first_block_among_ties():
    """Uniform logits tie every 2x2 block: the corner is the first block,
    as in the JAX package, so the vector is (-d/2 + 1/2) on both axes."""
    got = T_ops.density2vector(torch.zeros(1, 1, 1, 81), 2)
    np.testing.assert_allclose(got.numpy().ravel(), [-3.5, -3.5], atol=1e-6)


# -- HD3Net ---------------------------------------------------------------------------

def _zoo_checkpoint(path, sd):
    """``sd`` written in the model zoo's layout: the reference's HD3Model
    wrapper under data parallel (``module.hd3net.`` keys inside
    ``state_dict``), beside an entry of another type."""
    torch.save({"epoch": 3, "state_dict": {f"module.hd3net.{k}": v for k, v in sd.items()}},
               path)


def _frontend_cfg(weights):
    from dfvo_torch.utils import ConfigLoader as TConfigLoader
    from tests.test_torch_models import DEFAULT_CFG

    cfg = TConfigLoader().merge_cfg([DEFAULT_CFG])
    cfg.image.height, cfg.image.width = 64, 96
    cfg.deep_flow.network = "hd3"
    cfg.deep_flow.flow_net_weight = str(weights)
    return cfg


@pytest.mark.parametrize("config", [FRONTEND, OTHER], ids=["flow-dlaup-hda",
                                                         "stereo-vgg-resnet-context"])
def test_hd3net_matches_jax(config, tmp_path):
    """Both option sets at every level. The frontend's configuration comes
    through the model zoo's checkpoint layout: seeded weights written under
    the port's names, read by ``DeepFrontend.load_variables``, against the
    JAX package's HD3Net on ``convert_hd3`` of the same file (as its
    frontend loads it: ``module.`` dropped), which shows that the port's
    names are the reference torch network's. The other options reach the
    port through ``hd3_from_flax``."""
    from dfvo_torch.pipeline.frontend import DeepFrontend as TDeepFrontend

    variables = seeded_hd3_variables(0, config, perturb_seed=1)
    img1, img2 = _pair(2)
    port = THD3Net(**config)
    if config is FRONTEND:
        path = tmp_path / "hd3_flow.pth"
        _zoo_checkpoint(path, bridge.hd3_from_flax(variables))
        raw = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
        variables = to_flax.convert_hd3({k.removeprefix("module."): v.numpy()
                                         for k, v in raw.items()})
        fe = TDeepFrontend(_frontend_cfg(path), "cpu")
        port.load_state_dict(fe.load_variables(torch.Generator().manual_seed(0))["flow"],
                             strict=True)
    else:
        port.load_state_dict(bridge.hd3_from_flax(variables), strict=True)
    want = jax_hd3(config, variables, img1, img2)
    with torch.no_grad():
        got = port(_t(img1), _t(img2))
    assert [v.shape[-1] for v in got[1]] == [1 if config["task"] == "stereo" else 2] * 5
    assert max(float(v.abs().max()) for v in got[1][1:]) > 1.0  # warps off the grid
    _assert_levels_close(got, want)


def test_hd3_bridge_inverts_the_torch_to_flax_converter():
    """hd3_from_flax is the inverse of convert_hd3 for both option sets,
    and the port's module tree has exactly the keys and shapes of the JAX
    package's ``HD3Net`` (traced by ``jax.eval_shape``, which compiles
    nothing)."""
    for config in (FRONTEND, OTHER):
        sd = bridge.init_state_dict(THD3Net(**config, device=torch.device("meta")),
                                    torch.Generator().manual_seed(0))
        tree = hd3_flax_from_port(sd)
        back = bridge.hd3_from_flax(tree)
        assert set(back) == set(sd)
        assert all(torch.equal(back[k], sd[k]) for k in sd)
        x = jnp.zeros((1, *FEED, 3))
        want = jax.eval_shape(HD3Net(**config).init, jax.random.PRNGKey(0), x, x)
        shapes = {jax.tree_util.keystr(p): tuple(leaf.shape)
                  for p, leaf in jax.tree_util.tree_leaves_with_path(want)}
        assert shapes == {jax.tree_util.keystr(p): tuple(leaf.shape)
                          for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}
        if config is FRONTEND:
            assert sum(v.numel() for v in sd.values()) == 39599785


def test_load_variables_reads_the_hd3_zoo_checkpoint(tmp_path):
    """``DeepFrontend.load_variables`` on a checkpoint in the model zoo's
    layout (``module.hd3net.`` keys inside ``state_dict``, an entry of
    another type): every tensor of the file under the port's name, float32,
    equal to what the bridge makes of the JAX package's ``convert_hd3`` of
    the same file; the depth network keeps its seeded weights."""
    from dfvo_torch.pipeline.frontend import DeepFrontend as TDeepFrontend

    sd = bridge.init_state_dict(THD3Net(**FRONTEND, device=torch.device("meta")),
                                torch.Generator().manual_seed(4))
    path = tmp_path / "hd3_flow.pth"
    _zoo_checkpoint(path, {k: v.double() if k.endswith("running_var") else v
                           for k, v in sd.items()})
    fe = TDeepFrontend(_frontend_cfg(path), "cpu")
    assert fe.flow_feed == FEED
    loaded = fe.load_variables(torch.Generator().manual_seed(0))
    seeded = fe.init_variables(torch.Generator().manual_seed(0))
    flow = loaded["flow"]
    assert set(flow) == set(sd) and all(flow[k].dtype == torch.float32 for k in flow)
    assert all(torch.equal(flow[k], sd[k]) for k in sd)
    assert all(torch.equal(loaded["depth"][k], seeded["depth"][k]) for k in seeded["depth"])
    raw = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    via_jax = bridge.hd3_from_flax(to_flax.convert_hd3(
        {k.removeprefix("module."): v.float().numpy() for k, v in raw.items()}))
    assert set(via_jax) == set(flow) and all(torch.equal(via_jax[k], flow[k]) for k in flow)


# -- the losses -----------------------------------------------------------------------

def _loss_inputs(task, seed):
    rng = np.random.RandomState(seed)
    dim = 1 if task == "stereo" else 2
    classes = 9 if task == "stereo" else 81
    sizes = [(1 << l, 2 << l) for l in range(5)]
    ms_prob = [(2 * rng.randn(2, h, w, classes)).astype(np.float32) for h, w in sizes]
    ms_vect = [(2 ** (6 - l) * rng.randn(2, h, w, dim)).astype(np.float32)
               for l, (h, w) in enumerate(sizes)]
    gt = (20 * rng.randn(2, *FEED, 2)).astype(np.float32)
    return ms_prob, ms_vect, gt


@pytest.mark.parametrize("task", ["flow", "stereo"])
def test_hd3_loss_matches_jax(task):
    ms_prob, ms_vect, gt = _loss_inputs(task, 7)
    want = jax.jit(J_loss.hd3_loss, static_argnums=(3, 4))(
        [jnp.asarray(p) for p in ms_prob], [jnp.asarray(v) for v in ms_vect], jnp.asarray(gt),
        (4,) * 5, task)
    got = T_loss.hd3_loss([_t(p) for p in ms_prob], [_t(v) for v in ms_vect], _t(gt),
                          (4,) * 5, task)
    # a sum over every level's 81 (9) classes at every pixel
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    flo, valid = T_loss.downsample_flow(_t(gt), 1 / 4)
    j_flo, j_valid = J_loss.downsample_flow(jnp.asarray(gt), 1 / 4)
    np.testing.assert_allclose(flo.numpy(), np.asarray(j_flo), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))


@pytest.mark.parametrize("channels, masked", [(2, False), (2, True), (1, True)],
                         ids=["flow", "flow-masked", "stereo-masked"])
def test_end_point_error_matches_jax(channels, masked):
    rng = np.random.RandomState(channels + 2 * masked)
    out = (3 * rng.randn(2, 16, 32, channels)).astype(np.float32)
    gt = (12 * rng.randn(2, *FEED, 2)).astype(np.float32)
    mask = (rng.rand(2, *FEED) > 0.3) if masked else None
    want = jax.jit(J_loss.end_point_error)(jnp.asarray(out), jnp.asarray(gt),
                                           None if mask is None else jnp.asarray(mask))
    got = T_loss.end_point_error(_t(out), _t(gt), None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
