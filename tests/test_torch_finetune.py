"""Online finetuning of the PyTorch port against the JAX package, on the CPU
in float32.

* The losses (``ops/losses.py``) and their input gradients against
  ``dfvo_tpu/ops/losses.py`` under ``jax.vjp``.
* The kernels' autograd Functions (``ops/kernel_grad.py``): their input
  gradients against the JAX package's ``_corr_bwd``, the VJP of the
  confidence normalisation then ``reg_scale_filter`` (XLA form, whose
  backward is ``_rf_bwd``) and ``_hc_bwd``, and ``gradcheck`` in float64.
* ``grid_sample``'s gradients with respect to the source and the
  coordinates, in both padding modes, across the borders.
* One finetuning step at 64x96 (flow scales [1], depth scales [0]: the
  static program of tests/test_finetune.py) against the JAX package's
  jitted ``update``: the loss, the gradients of both networks, the weights
  and the Adam moments. The first Adam step's first moment is (1 - b1)
  times the gradient, so the JAX step's state carries JAX's gradient of
  ``loss_fn``; one compile serves all four checks, and the frame loop's
  finetuning (``DFVO.main`` below) runs the same JAX program.
* The trainable set, the chunk update, ``DFVO.main`` with finetuning in
  both executions, the finetuned model's round trip and the refusals.

No JAX initialisation is compiled: the weights are the port's seeded
initialisation converted by the JAX package's converters
(tests/test_torch_models.py).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.models import convert as bridge
from dfvo_torch.ops import correlation as T_corr
from dfvo_torch.ops import headconv as T_head
from dfvo_torch.ops import losses as T_loss
from dfvo_torch.ops import regfilter as T_reg
from dfvo_torch.ops import warp as T_warp
from dfvo_torch.pipeline.dfvo import DFVO as TDFVO
from dfvo_torch.pipeline.finetune import OnlineFinetuner as TFinetuner
from dfvo_torch.pipeline.frontend import DeepFrontend as TDeepFrontend
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils.checkpoint import restore_variables
from dfvo_torch.utils.io import load_poses_from_txt
from dfvo_tpu.ops import losses as J_loss
from dfvo_tpu.ops import warp as J_warp
from dfvo_tpu.ops.headconv import _hc_bwd
from dfvo_tpu.ops.pallas_corr import _corr_bwd
from dfvo_tpu.ops.regfilter import reg_scale_filter
from dfvo_tpu.pipeline import DFVO as JDFVO
from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend
from dfvo_tpu.utils import ConfigLoader
from tests.test_torch_dfvo import (N_FRAMES, _frame_cfg, split_jax_step,  # noqa: F401
                                   tiny_kitti)
from tests.test_torch_models import _perturb, seeded_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options/examples/default_configuration.yml")
B1 = 0.9
LR = 1e-5
# float32 sums over a few hundred taps or pixels in another order than XLA
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vjp_torch(fn, inputs, cot):
    """Value and input gradients of ``fn`` at numpy ``inputs`` for the
    cotangent ``cot``, through the port's autograd."""
    leaves = [_t(a).requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _vjp_jax(fn, inputs, cot):
    """Value and input gradients of ``fn`` under ``jax.vjp``, jitted as one
    program."""

    @jax.jit
    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)

    out, grads = run(tuple(map(jnp.asarray, inputs)), jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


# -- (a) the losses ------------------------------------------------------------

@pytest.mark.parametrize("name", ["ssim", "reprojection_loss", "smooth_loss"])
def test_losses_and_gradients_match_jax(name):
    rng = np.random.RandomState(len(name))
    x = rng.rand(2, 9, 11, 3).astype(np.float32)
    y = rng.rand(2, 9, 11, 3).astype(np.float32)
    if name == "smooth_loss":
        x = rng.rand(2, 9, 11, 1).astype(np.float32) * 3
    shape = jax.eval_shape(getattr(J_loss, name), x, y).shape
    cot = np.asarray(rng.randn(*shape), np.float32)
    want, want_grads = _vjp_jax(getattr(J_loss, name), (x, y), cot)
    got, grads = _vjp_torch(getattr(T_loss, name), (x, y), cot)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for g, w in zip(grads, want_grads):
        # the SSIM quotient amplifies rounding where its denominator is small
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


# -- (b) the kernels' backward passes --------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_correlation_backward_matches_corr_bwd(stride):
    rng = np.random.RandomState(stride)
    f1, f2 = (rng.randn(2, 10, 13, 16).astype(np.float32) for _ in range(2))
    ho, wo = -(-10 // stride), -(-13 // stride)
    cot = rng.randn(2, ho, wo, 49).astype(np.float32)
    out, grads = _vjp_torch(lambda a, b: T_corr.correlation(a, b, 3, stride), (f1, f2), cot)
    want = jax.jit(functools.partial(_corr_bwd, 3, stride))(
        (jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(cot))
    assert out.shape == cot.shape
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


def _jax_normalise(raw):
    d = -(raw**2)
    return jnp.exp(d - jnp.max(d, axis=-1, keepdims=True))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_reg_dist_filter_backward_matches_rf_bwd(k):
    """The gradients with respect to the raw logits (through the fused
    normalisation), the flow and the four parameters."""
    rng = np.random.RandomState(k)
    kk = k * k
    inputs = (rng.randn(2, 8, 12, kk).astype(np.float32),
              (rng.randn(2, 8, 12, 2) * 2).astype(np.float32),
              rng.randn(1, 1, kk, 1).astype(np.float32), rng.randn(1).astype(np.float32),
              rng.randn(1, 1, kk, 1).astype(np.float32), rng.randn(1).astype(np.float32))
    cot = rng.randn(2, 8, 12, 2).astype(np.float32)
    _, grads = _vjp_torch(lambda *a: T_reg.reg_dist_filter(*a, k), inputs, cot)

    def jax_fn(raw, flow, wx, bx, wy, by):
        return reg_scale_filter(_jax_normalise(raw), flow, wx, bx, wy, by, k, use_pallas=False)

    _, want = _vjp_jax(jax_fn, inputs, cot)
    for name, g, w in zip(("raw", "flow", "wx", "bx", "wy", "by"), grads, want):
        # the parameter gradients sum over all 192 pixels
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("prepadded", [False, True], ids=["same", "prepadded"])
def test_head_conv_backward_matches_hc_bwd(prepadded):
    rng = np.random.RandomState(int(prepadded))
    k = 5 if not prepadded else 3
    x = rng.randn(2, 9, 12, 8).astype(np.float32)
    kernel = (rng.randn(k, k, 8, 2) / k).astype(np.float32)
    bias = rng.randn(2).astype(np.float32)
    shrink = k - 1 if prepadded else 0
    cot = rng.randn(2, 9 - shrink, 12 - shrink, 2).astype(np.float32)
    _, grads = _vjp_torch(lambda a, b, c: T_head.head_conv(a, b, c, prepadded),
                          (x, kernel, bias), cot)
    want = jax.jit(functools.partial(_hc_bwd, prepadded))(
        (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)), jnp.asarray(cot))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["correlation", "reg_dist_filter", "head_conv"])
def test_kernel_functions_pass_gradcheck(name):
    """Each Function's backward against finite differences in float64."""
    rng = np.random.RandomState(5)

    def t(*shape):
        return _t(rng.randn(*shape)).requires_grad_(True)

    cases = {
        "correlation": [(T_corr.CorrelationFunction, (t(1, 4, 5, 2), t(1, 4, 5, 2), 3, s))
                        for s in (1, 2)],
        "reg_dist_filter": [(T_reg.RegDistFilterFunction,
                             (t(1, 4, 5, 9), t(1, 4, 5, 2), t(9), t(1), t(9), t(1), 3))],
        "head_conv": [(T_head.HeadConvFunction, (t(1, 5, 6, 3), t(3, 3, 3, 2), t(2), pre))
                      for pre in (False, True)],
    }
    for fn, args in cases[name]:
        assert torch.autograd.gradcheck(fn.apply, args, eps=1e-6, atol=1e-5, fast_mode=True)


@pytest.mark.parametrize("name", ["correlation", "reg_dist_filter", "head_conv"])
def test_dispatchers_record_through_their_function(name):
    """With an input that requires grad the dispatcher's output carries the
    Function's ``grad_fn``; under ``no_grad`` it carries none."""
    x = torch.rand(1, 6, 7, 8)
    calls = {
        "correlation": (lambda g: T_corr.correlation(g(x), x), "CorrelationFunction"),
        "reg_dist_filter": (lambda g: T_reg.reg_dist_filter(
            torch.rand(1, 6, 7, 9), g(torch.rand(1, 6, 7, 2)), torch.rand(9), torch.rand(1),
            torch.rand(9), torch.rand(1), 3), "RegDistFilterFunction"),
        "head_conv": (lambda g: T_head.head_conv(x, g(torch.rand(3, 3, 8, 2))),
                      "HeadConvFunction"),
    }
    call, fn_name = calls[name]
    out = call(lambda t: t.clone().requires_grad_(True))
    assert out.requires_grad and type(out.grad_fn).__name__.startswith(fn_name)
    with torch.no_grad():
        assert call(lambda t: t.clone().requires_grad_(True)).grad_fn is None


# -- (c) the warps ---------------------------------------------------------------

@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_gradients_match_jax(padding_mode):
    """Gradients with respect to the source and the coordinates, with
    coordinates past every border (the clamps of 'border', the corner masks
    of 'zeros'; the JAX package's 'zeros' mode is its packed-patch gather)."""
    rng = np.random.RandomState(7)
    src = rng.randn(2, 9, 11, 3).astype(np.float32)
    coords = np.stack([rng.uniform(-2.5, 12.5, (2, 7, 8)), rng.uniform(-2.5, 10.5, (2, 7, 8))],
                      axis=-1).astype(np.float32)
    cot = rng.randn(2, 7, 8, 3).astype(np.float32)
    got, grads = _vjp_torch(lambda s, c: T_warp.grid_sample(s, c, padding_mode),
                            (src, coords), cot)
    want, want_grads = _vjp_jax(lambda s, c: J_warp.grid_sample(s, c, padding_mode),
                                (src, coords), cot)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
    assert np.abs(grads[1]).max() > 0.1  # the coordinates do get gradients


PIECES = ["resize", "resize_ac", "resize_dense_flow", "consistency", "frozen_bn",
          "reflect_pad", "reproject"]


@pytest.mark.parametrize("name", PIECES)
def test_differentiable_pieces_match_jax(name):
    """The gradients of the finetuning path's other pieces against
    ``jax.vjp`` of the JAX package's: the bilinear resize (both corner
    conventions), the flow resize, forward-backward consistency, the frozen
    batch norm (its scale, bias and input; the statistics fixed), the
    reflect pad of the disparity heads, and the reprojection of a depth
    from a disparity."""
    from dfvo_torch.geometry.ops import reproject as t_reproject
    from dfvo_torch.models import layers as T_layers
    from dfvo_torch.models.monodepth2 import disp_to_depth as t_disp_to_depth
    from dfvo_torch.pipeline import frontend as T_fe
    from dfvo_tpu.geometry.ops import reproject as j_reproject
    from dfvo_tpu.models import layers as J_layers
    from dfvo_tpu.models.monodepth2 import disp_to_depth as j_disp_to_depth
    from dfvo_tpu.pipeline import frontend as J_fe

    rng = np.random.RandomState(11)
    x = rng.randn(2, 6, 10, 3).astype(np.float32)
    flows = (rng.randn(2, 6, 10, 2) * 2).astype(np.float32)
    stats = (rng.randn(3).astype(np.float32), rng.uniform(0.5, 1.5, 3).astype(np.float32))
    K = np.array([[8.0, 0, 5.0], [0, 8.0, 3.0], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, -0.02, 0.1]

    def t_bn(x, scale, bias):
        bn = T_layers.FrozenBatchNorm(3)
        sd = {"weight": scale, "bias": bias, "running_mean": _t(stats[0]),
              "running_var": _t(stats[1])}
        return torch.func.functional_call(bn, sd, (x,))

    def j_bn(x, scale, bias):
        return J_layers.FrozenBatchNorm(3).apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": stats[0], "var": stats[1]}}, x)

    def t_rep(disp):
        depth = t_disp_to_depth(disp, 0.1, 100.0)[1]
        return t_reproject(depth, _t(T[None]), _t(K), _t(np.linalg.inv(K)))

    def j_rep(disp):
        depth = j_disp_to_depth(disp, 0.1, 100.0)[1]
        return j_reproject(depth, T[None], K, np.linalg.inv(K))

    cases = {
        "resize": (lambda a: T_layers.resize_bilinear(a, 9, 13),
                   lambda a: J_layers.resize_bilinear(a, 9, 13), (x,)),
        "resize_ac": (lambda a: T_layers.resize_bilinear(a, 11, 7, align_corners=True),
                      lambda a: J_layers.resize_bilinear(a, 11, 7, align_corners=True), (x,)),
        "resize_dense_flow": (lambda f: T_fe.resize_dense_flow(f, 12, 20),
                              lambda f: J_fe.resize_dense_flow(f, 12, 20), (flows,)),
        "consistency": (T_fe.forward_backward_consistency, J_fe.forward_backward_consistency,
                        (flows[:1], flows[1:])),
        "frozen_bn": (t_bn, j_bn, (x, *(rng.randn(2, 3).astype(np.float32)))),
        "reflect_pad": (T_layers.reflect_pad1_nhwc,
                        lambda a: jnp.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect"),
                        (x,)),
        "reproject": (t_rep, j_rep, (rng.uniform(0.05, 0.95, (1, 6, 10)).astype(np.float32),)),
    }
    assert sorted(cases) == sorted(PIECES)
    t_fn, j_fn, inputs = cases[name]
    shape = jax.eval_shape(j_fn, *inputs).shape
    cot = rng.randn(*shape).astype(np.float32)
    want, want_grads = _vjp_jax(j_fn, inputs, cot)
    got, grads = _vjp_torch(t_fn, inputs, cot)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


# -- (d) one update against the JAX package ------------------------------------------

def _ft_cfg(cfg, num_frames=2):
    cfg.online_finetune.enable = True
    cfg.online_finetune.save_model = True
    cfg.online_finetune.num_frames = num_frames
    cfg.online_finetune.flow.enable = True
    cfg.online_finetune.flow.scales = [1]
    cfg.online_finetune.depth.enable = True
    cfg.online_finetune.depth.scales = [0]
    return cfg


def _jax_variables():
    """tests/test_torch_dfvo.py's weights: seed 0, flow biases redrawn and
    its heads scaled x10."""
    jvars = seeded_flax_variables(0)
    jvars["flow"] = _perturb(jvars["flow"], np.random.RandomState(0), head_scale=10.0)
    return jvars


def _port_variables(jvars):
    return {"depth": bridge.monodepth2_depth_from_flax(jvars["depth"]),
            "flow": bridge.liteflownet_from_flax(jvars["flow"])}


def _port_tree(net, params, jvars):
    """A Flax ``params``-shaped tree (gradients, moments) in the port's key
    names: its trainable entries."""
    conv = {"depth": bridge.monodepth2_depth_from_flax,
            "flow": bridge.liteflownet_from_flax}[net]
    sd = conv({**jvars[net], "params": jax.tree.map(np.asarray, params)})
    return {k: v.numpy() for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_trainable_set_is_the_flax_params_tree():
    """The port trains exactly the tensors that the bridge fills from the
    Flax ``params`` collection, key for key and element for element; the
    batch-norm running statistics stay out."""
    cfg = _ft_cfg(TConfigLoader().merge_cfg([DEFAULT_CFG]))
    cfg.image.height, cfg.image.width = 64, 96
    fe = TDeepFrontend(cfg, "cpu")
    jvars = seeded_flax_variables(0)
    # mark each converted entry by the collection it came from
    marked = {net: {"params": jax.tree.map(lambda a: np.full_like(a, 1.0), v["params"]),
                    **({"batch_stats": jax.tree.map(lambda a: np.full_like(a, 2.0),
                                                    v["batch_stats"])}
                       if "batch_stats" in v else {})}
              for net, v in jvars.items()}
    for net, sd in _port_variables(marked).items():
        from_params = {k for k, v in sd.items() if torch.all(v == 1.0)}
        assert from_params | {k for k, v in sd.items() if torch.all(v == 2.0)} == set(sd)
        assert set(fe.trainable_keys(net)) == from_params, net
        n_params = sum(np.asarray(a).size for a in jax.tree.leaves(jvars[net]["params"]))
        assert sum(sd[k].numel() for k in fe.trainable_keys(net)) == n_params, net
    assert any(k.endswith("running_var") for k in _port_variables(marked)["depth"])


def _check_update(jvars, tvo, call, result):
    """The port's loss, its gradients of both networks and one Adam step
    (the weights and the moments) from ``jvars`` against the JAX package's
    ``update`` ``call`` (img_ref, img_cur, pose) and its ``result``
    (variables, Adam state, loss)."""
    img_ref, img_cur, pose = call
    j_new, j_state, j_loss = result
    adam = j_state[0]
    assert int(adam.count) == 1
    ft = tvo.finetuner
    variables = _port_variables(jvars)
    state = ft.init_state(variables, tvo.dataset.cam_intrinsics.mat,
                          tvo.dataset.cam_intrinsics.inv_mat)
    before = _clone(variables)
    loss, grads = ft.value_and_grad(variables, _t(img_ref)[None], _t(img_cur)[None],
                                    _t(pose)[None])
    _, state, loss_u = ft.update(variables, state, _t(img_ref), _t(img_cur), _t(pose))

    # the loss: float32 through both networks in another summation order
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert float(loss_u) == float(loss)
    assert state["count"] == 1
    for net in ("flow", "depth"):
        j_grad = _port_tree(net, jax.tree.map(lambda m: np.asarray(m) / np.float32(1 - B1),
                                              adam.mu[net]), jvars)
        j_mu = _port_tree(net, adam.mu[net], jvars)
        j_nu = _port_tree(net, adam.nu[net], jvars)
        j_w = _port_tree(net, j_new[net]["params"], jvars)
        assert set(j_grad) == set(grads[net]) == set(state["mu"][net])
        pairs, steps = [], []
        for k, jg in j_grad.items():
            g = grads[net][k].numpy()
            # a zero gradient (the disparity heads of unused scales) stays
            # exactly zero
            if not np.any(jg):
                assert not np.any(g), k
                continue
            pairs.append((g, jg))
            # each tensor's gradient, and the moments mu = (1 - b1) g and
            # nu = (1 - b2) g², within 1e-2 of their norm: float32
            # backpropagation through ~40 layers, in another summation order;
            # the largest errors (2e-3, 3.5e-3 for nu) are in the coarse
            # levels' tensors, whose gradients are 1e-8 to 1e-11
            for got, want in ((g, jg), (state["mu"][net][k].numpy(), j_mu[k]),
                              (state["nu"][net][k].numpy(), j_nu[k])):
                assert _rel_err(got, want) < 1e-2, k
            steps.append((variables[net][k].numpy() - before[net][k].numpy(),
                          j_w[k] - before[net][k].numpy()))
        # the whole network's gradient by norm: flow within 1e-4 (measured
        # 5e-7); depth within 1e-3: its loss's per-pixel minimum and the
        # border sampler's cells switch under rounding, and the summation
        # order follows torch's thread count (measured 6e-6 under a 2 degree
        # turn, 1e-4 to 2.3e-4 under the tracked pose's millimetres)
        flat = [np.concatenate([p[i].ravel() for p in pairs]) for i in (0, 1)]
        assert _rel_err(*flat) < (1e-4 if net == "flow" else 1e-3), net
        # the weights moved by the same Adam step, lr·g/(|g| + eps): about
        # lr·sign(g), so a gradient of the other sign is 2 lr off, and one
        # within a few orders of eps (the depth net's, under the tracked
        # pose's millimetre motion) turns on its rounding. Measured: flow all
        # within lr/50; depth, with one torch thread (with eight), 99.80 %
        # (99.95 %) within lr/100, 888 (89) of 14.3 M elements beyond lr/10,
        # the worst 1.3 lr (0.7 lr)
        step_t, step_j = (np.concatenate([st[i].ravel() for st in steps]) for i in (0, 1))
        diff = np.abs(step_t - step_j)
        assert diff.max() <= 2 * LR, net
        close, near = (1 - 1e-4, 1 - 1e-4) if net == "flow" else (0.995, 1 - 5e-4)
        assert np.mean(diff <= 1e-2 * LR) >= close, net
        assert np.mean(diff <= 0.1 * LR) >= near, net
        assert np.abs(step_j).max() > 0.5 * LR


# -- (e) the chunk update ---------------------------------------------------------------

def _port_finetuner(seed=0):
    cfg = _ft_cfg(TConfigLoader().merge_cfg([DEFAULT_CFG]))
    cfg.image.height, cfg.image.width = 64, 96
    cfg.tpu.dtype = "float32"
    fe = TDeepFrontend(cfg, "cpu")
    ft = TFinetuner(fe, cfg)
    variables = fe.init_variables(torch.Generator().manual_seed(seed))
    K = np.array([[50.0, 0, 48], [0, 50.0, 32], [0, 0, 1]], np.float32)
    return ft, variables, ft.init_state(variables, K, np.linalg.inv(K))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def test_chunk_update_matches_sequential_updates():
    """The chunk update over 3 pairs with ``n_active = 2`` is two frame
    updates in a row, and skips the third pair (loss 0); the port's
    counterpart of tests/test_finetune.py's chunk test."""
    ft, variables, state = _port_finetuner()
    rng = np.random.RandomState(1)
    imgs_u8 = _t((rng.rand(4, 64, 96, 3) * 255).astype(np.uint8))
    poses = torch.eye(4).expand(3, 4, 4)

    seq_vars, seq_state = _clone(variables), _clone(state)
    seq_losses = []
    for i in range(2):
        seq_vars, seq_state, loss = ft.update(seq_vars, seq_state, imgs_u8[i].float() / 255.0,
                                              imgs_u8[i + 1].float() / 255.0, poses[i])
        seq_losses.append(float(loss))

    ck_vars, ck_state, ck_losses = ft.make_chunk_update_fn()(
        _clone(variables), _clone(state), imgs_u8, poses, 2)
    assert ck_losses.shape == (3,) and float(ck_losses[2]) == 0.0
    # the same float32 ops in the same order
    np.testing.assert_allclose(ck_losses[:2].numpy(), seq_losses, rtol=1e-6)
    assert ck_state["count"] == seq_state["count"] == 2
    for net in ("flow", "depth"):
        for k in ft.frontend.trainable_keys(net):
            np.testing.assert_allclose(ck_vars[net][k].numpy(), seq_vars[net][k].numpy(),
                                       rtol=0, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(ck_state["nu"][net][k].numpy(),
                                       seq_state["nu"][net][k].numpy(), rtol=1e-6, atol=0)
    moved = max(float((ck_vars["flow"][k] - variables["flow"][k]).abs().max())
                for k in ft.frontend.trainable_keys("flow"))
    assert moved > 1.5 * LR  # two steps of about lr each


# -- (f) DFVO.main with finetuning ----------------------------------------------------

def _trainable_delta(vo, before):
    keys = {net: vo.frontend.trainable_keys(net) for net in ("flow", "depth")}
    return {net: max(float((vo.variables[net][k] - before[net][k]).abs().max()) for k in ks)
            for net, ks in keys.items()}


def test_update_and_frame_loop_match_jax(tiny_kitti, tmp_path, monkeypatch):
    """Frame execution with flow and depth finetuning on the first two
    pairs, in both packages' ``DFVO.main``: the first update (its loss,
    gradients, weights and moments; ``_check_update``), the trajectory, the
    finetuned weights, and the finetuned model on disk. One JAX program
    (the jitted ``update``) serves every comparison; the JAX loop's frame
    step runs as its two jitted halves (tests/test_torch_dfvo.py
    ``split_jax_step``)."""
    jvars = _jax_variables()
    monkeypatch.setattr(JDeepFrontend, "init_variables",
                        lambda self, rng: jax.tree.map(jnp.asarray, jvars))
    jvo = split_jax_step(JDFVO(_ft_cfg(_frame_cfg(ConfigLoader, tiny_kitti, tmp_path / "jax"))))
    calls, j_update = [], jvo.finetuner.update

    def update(variables, opt_state, img_ref, img_cur, pose):
        out = j_update(variables, opt_state, img_ref, img_cur, pose)
        calls.append(([np.asarray(a) for a in (img_ref, img_cur, pose)], out))
        return out

    jvo.finetuner.update = update
    jvo.main()
    assert jvo.finetune_cnt == 2 and len(calls) == 2

    tvo = TDFVO(_ft_cfg(_frame_cfg(TConfigLoader, tiny_kitti, tmp_path / "torch")),
                device="cpu")
    np.testing.assert_array_equal(tvo.finetuner._K.numpy(), np.asarray(jvo.K))
    # the tracked pose of the first pair moves pixels by more than rounding
    assert np.abs(calls[0][0][2] - np.eye(4)).max() > 1e-4
    _check_update(jvars, tvo, *calls[0])
    tvo.variables = _port_variables(jvars)
    tvo.infer_variables = tvo.frontend.prepare_variables(tvo.variables)
    before = _clone(tvo.variables)
    tvo.main()
    assert tvo.finetune_cnt == 2 and tvo.opt_state["count"] == 2
    assert set(tvo.timers.timers) >= {"finetune", "vo_step", "DF-VO"}

    want = load_poses_from_txt(str(tmp_path / "jax" / "07.txt"))
    got = load_poses_from_txt(str(tmp_path / "torch" / "07.txt"))
    assert sorted(got) == sorted(want) == list(range(N_FRAMES))
    assert max(np.linalg.norm(p[:3, 3]) for p in want.values()) >= 100 * 1e-5
    for i in want:
        # as tests/test_torch_dfvo.py without finetuning (1e-5): frames 3 on
        # run on weights two Adam steps apart by at most lr/2 per element
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, err_msg=f"frame {i}")
    for net in ("flow", "depth"):
        j_w = _port_tree(net, jvo.variables[net]["params"], jvars)
        step_t = np.concatenate([(tvo.variables[net][k] - before[net][k]).numpy().ravel()
                                 for k in j_w])
        step_j = np.concatenate([(j_w[k] - before[net][k].numpy()).ravel() for k in j_w])
        # two steps of about lr each. The depth loss reads each package's own
        # tracked pose (equal within the trajectory's 1e-6), and where the
        # second gradient nearly cancels the first moment Adam's second step
        # turns on that difference: measured, every element within 1.5 lr of
        # JAX's, and all but 5e-5 of them (depth; none for flow) within lr/10
        diff = np.abs(step_t - step_j)
        assert np.abs(step_j).max() > 1.5 * LR
        assert diff.max() <= 2 * LR, net
        assert np.mean(diff <= 0.1 * LR) >= 1 - 1e-3, net
    saved = restore_variables(str(tmp_path / "torch" / "finetuned_model"))
    assert all(torch.equal(saved["variables"][net][k], tvo.variables[net][k])
               for net in ("flow", "depth") for k in tvo.variables[net])


def test_scan_execution_finetunes_and_saves_the_model(tiny_kitti, tmp_path):
    """``python -m dfvo_torch.apis.run --device cpu`` in scan execution with
    chunks of 3 and a budget of 4 pairs, which ends inside the second
    chunk; the finetuned model round-trips through ``restore_variables``."""
    from dfvo_torch.apis import run

    result = tmp_path / "result"
    custom = tmp_path / "custom.yml"
    custom.write_text(
        'seq: "07"\n'
        "image: {height: 64, width: 96}\n"
        f"directory: {{img_seq_dir: {tiny_kitti / 'odom_data'}, "
        f"gt_pose_dir: {tiny_kitti / 'gt_poses'}, result_dir: {result}}}\n"
        "visualization: {enable: False, save_img: False}\n"
        "tpu: {ransac_hypotheses: 32, dtype: float32, execution: scan, scan_chunk: 3}\n"
        "online_finetune: {enable: True, save_model: True, num_frames: 4, "
        "flow: {enable: True, scales: [1]}, depth: {enable: True, scales: [0]}}\n")
    vo = run.main(["-d", DEFAULT_CFG, "-c", str(custom), "--no_confirm", "--device", "cpu"])
    assert vo.finetune_cnt == 4 and vo.opt_state["count"] == 4
    poses = load_poses_from_txt(str(result / "07.txt"))
    assert sorted(poses) == list(range(N_FRAMES))
    assert all(np.isfinite(p).all() for p in poses.values())
    init = vo.frontend.load_variables(torch.Generator().manual_seed(int(vo.cfg.seed)))
    delta = _trainable_delta(vo, init)
    assert delta["flow"] > 3.5 * LR and delta["depth"] > 3.5 * LR  # four steps
    saved = restore_variables(str(result / "finetuned_model"))
    assert saved["opt_state"]["count"] == 4
    for net in ("flow", "depth"):
        assert saved["variables"][net].keys() == vo.variables[net].keys()
        assert all(torch.equal(saved["variables"][net][k], vo.variables[net][k])
                   for k in vo.variables[net])
        assert all(torch.equal(saved["opt_state"]["mu"][net][k], vo.opt_state["mu"][net][k])
                   for k in vo.opt_state["mu"][net])


def test_scan_inference_runs_on_the_previous_chunks_weights(tiny_kitti, tmp_path):
    """A chunk's inference runs on the weights as of the end of the chunk
    before: with one chunk for the whole run (4 frames, chunks of 4), the
    trajectory is that of a run without finetuning, though the weights
    moved."""
    runs = {}
    for finetune in (False, True):
        cfg = _frame_cfg(TConfigLoader, tiny_kitti, tmp_path / str(finetune))
        cfg.tpu.execution, cfg.tpu.scan_chunk = "scan", 4
        if finetune:
            _ft_cfg(cfg)
        runs[finetune] = TDFVO(cfg, device="cpu")
        runs[finetune].main(num_frames=4)
    off, on = runs[False], runs[True]
    assert off.finetuner is None and on.finetune_cnt == 2
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "True" / "07.txt"),
                                  np.loadtxt(tmp_path / "False" / "07.txt"))
    assert _trainable_delta(on, off.variables)["flow"] > 1.5 * LR


# -- (g) the refusals and the shipped configurations ------------------------------------

@pytest.mark.parametrize("pose_src, error, match", [
    ("bogus", ValueError, "pose_src: 'bogus' not in"),
    ("deep_pose", ValueError, "needs the pose CNN"),
    ("DF-VO2", ValueError, "needs the pose CNN"),
], ids=["bogus", "deep_pose", "DF-VO2"])
def test_finetuner_refuses_pose_sources_it_cannot_serve(pose_src, error, match):
    cfg = _ft_cfg(TConfigLoader().merge_cfg([DEFAULT_CFG]))
    cfg.image.height, cfg.image.width = 64, 96
    cfg.online_finetune.depth.pose_src = pose_src
    with pytest.raises(error, match=match):
        TFinetuner(TDeepFrontend(cfg, "cpu"), cfg)


def test_hd3_finetuning_and_the_multi_sequence_step_name_their_items(tiny_kitti, tmp_path):
    """HD3 flow finetuning builds (tests/test_torch_hd3_pipeline.py runs it);
    the multi-sequence step still names its ROADMAP item."""
    cfg = _ft_cfg(_frame_cfg(TConfigLoader, tiny_kitti, tmp_path))
    cfg.deep_flow.network = "hd3"
    ft = TFinetuner(TDeepFrontend(cfg, "cpu"), cfg)
    assert ft.frontend.flow_kind == "hd3" and ft.train_flow
    with pytest.raises(NotImplementedError, match="item 11"):
        ft.make_update_fn(axis_name="seq")


@pytest.mark.parametrize("name", [
    "ablation_self_flow_online", "kitti_stereo_train_extend", "kitti_mono_sc_train_extend",
])
def test_shipped_finetuning_configurations(tiny_kitti, tmp_path, name):
    """The three shipped configurations that enable online finetuning,
    merged on the default at 64x96 with the tiny sequence: the flow
    ablation runs with its unbounded budget; the extended-paper ones
    (rigid-flow keypoints, iterative scale recovery) finetune the flow at
    scales 1-5 with the default's budget of 200 frames. Each run finishes
    with one update per tracked frame and finite poses."""
    custom = tmp_path / "custom.yml"
    custom.write_text(
        'seq: "07"\n'
        "image: {height: 64, width: 96}\n"
        f"directory: {{img_seq_dir: {tiny_kitti / 'odom_data'}, "
        f"gt_pose_dir: {tiny_kitti / 'gt_poses'}, result_dir: {tmp_path / 'result'}}}\n"
        "visualization: {enable: False}\n"
        "tpu: {ransac_hypotheses: 32, dtype: float32}\n")
    cfg = TConfigLoader().merge_cfg(
        [DEFAULT_CFG, os.path.join(REPO, "options/examples", f"{name}.yml"), str(custom)])
    vo = TDFVO(cfg, device="cpu")
    assert vo.finetuner is not None and vo.finetuner.train_flow
    assert not vo.finetuner.train_depth
    assert list(vo.cfg.online_finetune.flow.scales) == [1, 2, 3, 4, 5]
    if name == "ablation_self_flow_online":
        assert vo.finetuner.num_frames is None
    else:
        assert vo.finetuner.num_frames == 200
        assert vo.tcfg.scale_method == "iterative"
    vo.main(num_frames=3)
    assert vo.finetune_cnt == 2
    poses = load_poses_from_txt(str(tmp_path / "result" / "07.txt"))
    assert sorted(poses) == [0, 1, 2] and all(np.isfinite(p).all() for p in poses.values())
