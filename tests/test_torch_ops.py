"""Parity of the PyTorch port's ops (dfvo_torch.ops, models.layers) with the
JAX package on the CPU, in float32, on inputs made from numpy seeds.

The JAX side runs its plain XLA forms and, for the two Pallas kernels that
have an interpret mode, the kernels themselves under
``pltpu.force_tpu_interpret_mode()``. The port's ops run their plain
versions here: on a CPU tensor the dispatchers take the plain path, and the
CUDA wrappers refuse a CPU tensor.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dfvo_torch.models import layers as T_layers
from dfvo_torch.ops import correlation as T_corr
from dfvo_torch.ops import headconv as T_head
from dfvo_torch.ops import pallas_corr as T_pcorr
from dfvo_torch.ops import regfilter as T_reg
from dfvo_torch.ops import warp as T_warp
from dfvo_tpu.models import layers as J_layers
from dfvo_tpu.ops import correlation as J_corr
from dfvo_tpu.ops import headconv as J_head
from dfvo_tpu.ops import pallas_corr as J_pcorr
from dfvo_tpu.ops import regfilter as J_reg
from dfvo_tpu.ops import warp as J_warp

# float32 sums over <= 192 channels or <= 49 taps in another order than XLA:
# a few ulp of values of order 1
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("max_disp", [3, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_correlation_plain_matches_xla(max_disp, stride):
    rng = np.random.RandomState(10 * max_disp + stride)
    f1 = rng.randn(2, 11, 13, 32).astype(np.float32)
    f2 = rng.randn(2, 11, 13, 32).astype(np.float32)
    got = T_corr.correlation(_t(f1), _t(f2), max_disp, stride)
    want = J_corr.correlation_xla(jnp.asarray(f1), jnp.asarray(f2),
                                  max_disp=max_disp, stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("max_disp", [3, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_correlation_plain_matches_pallas_interpret(max_disp, stride):
    rng = np.random.RandomState(20 * max_disp + stride)
    f1 = rng.randn(1, 8, 16, 32).astype(np.float32)
    f2 = rng.randn(1, 8, 16, 32).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = J_pcorr.correlation_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                          max_disp, stride)
    got = T_corr.correlation_plain(_t(f1), _t(f2), max_disp, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _regfilter_inputs(seed, n, h, w, k):
    rng = np.random.RandomState(seed)
    kk = k * k
    return (
        rng.rand(n, h, w, kk).astype(np.float32) + 0.1,
        (rng.rand(n, h, w, 2) - 0.5).astype(np.float32) * 3,
        (rng.rand(1, 1, kk, 1) - 0.5).astype(np.float32),
        rng.rand(1).astype(np.float32),
        (rng.rand(1, 1, kk, 1) - 0.5).astype(np.float32),
        rng.rand(1).astype(np.float32),
    )


@pytest.mark.parametrize("k", [3, 5, 7])
def test_reg_scale_filter_plain_matches_xla(k):
    args = _regfilter_inputs(k, 2, 12, 40, k)
    got = T_reg.reg_scale_filter_plain(*map(_t, args), k)
    want = J_reg._unfold_mul_xla(*map(jnp.asarray, args), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_reg_scale_filter_plain_matches_pallas_interpret(k):
    # 20 rows: a tail band of the TPU kernel's 16-row bands; 84 columns: not
    # a multiple of 8, so the TPU kernel pads dist with 1.0 — the valid
    # region must still equal the unpadded op
    args = _regfilter_inputs(100 + k, 1, 20, 84, k)
    with pltpu.force_tpu_interpret_mode():
        want = J_reg._regfilter_pallas(*map(jnp.asarray, args), k)
    got = T_reg.reg_scale_filter_plain(*map(_t, args), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "n,h,w,cin,cout,k,prepadded",
    [
        (2, 12, 40, 32, 2, 7, False),  # LiteFlowNet level-2 flow head
        (2, 6, 20, 32, 2, 5, False),
        (1, 6, 10, 32, 2, 3, False),
        (1, 10, 18, 16, 1, 3, True),   # Monodepth2 reflect-padded disp head
        (1, 8, 8, 128, 1, 3, True),
        (2, 5, 7, 8, 4, 1, False),
    ],
)
def test_head_conv_plain_matches_jax(n, h, w, cin, cout, k, prepadded):
    rng = np.random.RandomState(k + cin)
    x = rng.rand(n, h, w, cin).astype(np.float32)
    kern = rng.rand(k, k, cin, cout).astype(np.float32) - 0.5
    b = rng.rand(cout).astype(np.float32)
    got = T_head.head_conv(_t(x), _t(kern), _t(b), prepadded=prepadded)
    want = J_head.head_conv(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(b),
                            prepadded=prepadded)
    assert got.shape == want.shape
    # float32 conv over up to 7*7*32 products: 1e-5 of sums of order 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes quietly."""
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        T_pcorr.correlation_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        T_reg.reg_dist_filter_cuda(
            torch.zeros(1, 4, 4, 9), torch.zeros(1, 4, 4, 2),
            torch.zeros(9), torch.zeros(1), torch.zeros(9), torch.zeros(1), 3,
        )
    with pytest.raises(ValueError, match="CUDA"):
        T_head.head_conv_cuda(x, torch.zeros(3, 3, 8, 2))
    assert T_pcorr.correlation_cuda.launches == 0
    assert T_reg.reg_dist_filter_cuda.launches == 0
    assert T_head.head_conv_cuda.launches == 0


def _grad_cases():
    x = torch.zeros(1, 4, 4, 8)
    return {
        "correlation": (T_pcorr.correlation_cuda, lambda g: (g(x), x)),
        "reg_dist_filter": (T_reg.reg_dist_filter_cuda, lambda g: (
            g(torch.zeros(1, 4, 4, 9)), torch.zeros(1, 4, 4, 2), torch.zeros(9),
            torch.zeros(1), torch.zeros(9), torch.zeros(1), 3)),
        "head_conv": (T_head.head_conv_cuda, lambda g: (x, g(torch.zeros(3, 3, 8, 2)))),
    }


@pytest.mark.parametrize("name", ["correlation", "reg_dist_filter", "head_conv"])
def test_cuda_wrappers_refuse_inputs_that_require_grad(name):
    """The kernels have no backward: with autograd recording, an input that
    requires grad is refused before the device is looked at (a CPU tensor
    gets this error, not the CUDA one); under no_grad the device check
    comes first as before, and the plain version keeps its autograd."""
    fn, args = _grad_cases()[name]
    needs_grad = args(lambda t: t.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="no backward pass"):
        fn(*needs_grad)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*needs_grad)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args(lambda t: t))
    assert fn.launches == 0
    plain = {"correlation": T_corr.correlation, "reg_dist_filter": T_reg.reg_dist_filter,
             "head_conv": T_head.head_conv}[name]
    assert plain(*needs_grad).requires_grad


def _sample_inputs(seed, n_src=2, b=2):
    rng = np.random.RandomState(seed)
    src = rng.randn(n_src, 9, 11, 5).astype(np.float32)
    # coordinates spanning the image and past every border
    coords = np.stack(
        [rng.uniform(-2.5, 12.5, (b, 7, 8)), rng.uniform(-2.5, 10.5, (b, 7, 8))],
        axis=-1,
    ).astype(np.float32)
    return src, coords


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax(padding_mode):
    src, coords = _sample_inputs(1)
    got = T_warp.grid_sample(_t(src), _t(coords), padding_mode)
    want = J_warp.grid_sample(jnp.asarray(src), jnp.asarray(coords),
                              padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_grid_sample_frame_ids_matches_jax():
    src, coords = _sample_inputs(2, n_src=3, b=4)
    ids = np.array([1, 2, 0, 1], np.int32)
    got = T_warp.grid_sample(_t(src), _t(coords), frame_ids=_t(ids))
    want = J_warp.grid_sample(jnp.asarray(src), jnp.asarray(coords),
                              frame_ids=jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # and equal to sampling explicitly duplicated frames
    dup = T_warp.grid_sample(_t(src[ids]), _t(coords))
    np.testing.assert_allclose(got.numpy(), dup.numpy(), atol=0)


def test_warp_image_by_flow_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.rand(2, 8, 12, 3).astype(np.float32)
    flow = (rng.randn(2, 8, 12, 2) * 3).astype(np.float32)
    got = T_warp.warp_image_by_flow(_t(img), _t(flow))
    want = J_warp.warp_image_by_flow(jnp.asarray(img), jnp.asarray(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "in_hw,out_hw,align_corners",
    [
        ((12, 20), (6, 10), False),   # exact 2x: the mean-pool shortcut
        ((12, 20), (7, 9), False),
        ((6, 10), (13, 21), False),
        ((12, 20), (7, 9), True),
        ((6, 10), (24, 40), True),
        ((1, 10), (3, 4), True),      # one source row
    ],
)
def test_resize_bilinear_matches_jax(in_hw, out_hw, align_corners):
    rng = np.random.RandomState(sum(in_hw) + sum(out_hw))
    x = rng.randn(2, *in_hw, 3).astype(np.float32)
    got = T_layers.resize_bilinear(_t(x), *out_hw, align_corners=align_corners)
    want = J_layers.resize_bilinear(jnp.asarray(x), *out_hw,
                                    align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if not align_corners and min(in_hw) > 1:
        # torch's own bilinear resize (no antialiasing) agrees too
        ref = torch.nn.functional.interpolate(
            _t(x).permute(0, 3, 1, 2), size=out_hw, mode="bilinear",
            align_corners=False,
        ).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_upsample2x_nearest_matches_jax():
    x = np.random.RandomState(4).randn(2, 3, 5, 4).astype(np.float32)
    got = T_layers.upsample2x_nearest(_t(x))
    want = J_layers.upsample2x_nearest(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
