"""The closed-form backward passes of the cost volume and the head conv, on
the CPU: the plain versions that the autograd Functions run on a CPU tensor
and that ``chip_smoke.py`` holds the backward kernels
(``csrc/correlation_bwd.cu``, ``csrc/headconv_bwd.cu``) to on the card.

* ``correlation_backward_plain`` and ``head_conv_backward_plain`` against
  autograd of the plain forward in float64, over the options the kernels
  take (D = 3 and 4, stride 1 and 2 on odd sizes, a strided f1 view, every
  subset of requested gradients; k = 1..7, 'same' and pre-padded, bias or
  none, Cout 1..4, Cin not a multiple of 16).
* The same against the JAX package's ``_corr_bwd`` (D = 4) and ``_hc_bwd``
  (k = 1, Cout = 4) as tiny jitted VJPs, on inputs made with numpy.
* The Functions reach the closed forms on the CPU, and the backward
  kernels' wrappers refuse CPU tensors.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.ops import correlation as T_corr
from dfvo_torch.ops import headconv as T_head
from dfvo_torch.ops import pallas_corr as T_pcorr
from dfvo_tpu.ops.headconv import _hc_bwd
from dfvo_tpu.ops.pallas_corr import _corr_bwd

# float64 sums of at most a few hundred products in another order than
# autograd's: rounding near 1e-15 of values of order 10
ATOL64 = 1e-12
# float32 against XLA: sums of up to 81 taps or 150 pixels of order-1 terms
ATOL32 = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _autograd(fn, inputs, needs, cot):
    """The gradients of ``fn`` that ``needs`` asks for, None for the others
    (all are computed: CPU autograd of a float64 conv refuses to give the
    weight gradient alone of a permuted weight)."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = iter(torch.autograd.grad(out, [t for t in leaves if t is not None], cot))
    all_grads = [None if t is None else next(grads) for t in leaves]
    return [g if need else None for g, need in zip(all_grads, needs)]


def _assert_grads(got, want, needs, atol):
    assert len(got) == len(want)
    for i, (g, w, need) in enumerate(zip(got, want, needs)):
        if not need:
            assert g is None, i
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, err_msg=f"gradient {i}")


@pytest.mark.parametrize("view", [False, True], ids=["dense", "f1_view"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("max_disp", [3, 4])
def test_correlation_backward_plain_matches_autograd(max_disp, stride, view):
    """Odd H and W, so that the stride-2 views are ragged; ``view`` passes
    f1 as the [::2, ::2] view of a larger map, as LiteFlowNet's levels 3
    and 2 do."""
    rng = np.random.RandomState(10 * max_disp + stride)
    f1 = _t(rng.randn(2, 18, 22, 6))[:, ::2, ::2] if view else _t(rng.randn(2, 9, 11, 6))
    assert f1.is_contiguous() != view
    f2 = _t(rng.randn(2, 9, 11, 6))
    ho, wo = -(-9 // stride), -(-11 // stride)
    cot = _t(rng.randn(2, ho, wo, (2 * max_disp + 1) ** 2))
    for needs in ((True, True), (True, False), (False, True)):
        want = _autograd(lambda a, b: T_corr.correlation_plain(a, b, max_disp, stride),
                         (f1, f2), needs, cot)
        got = T_corr.correlation_backward_plain(cot, f1, f2, max_disp, stride, needs=needs)
        _assert_grads(got, want, needs, ATOL64)


@pytest.mark.parametrize("prepadded", [False, True], ids=["same", "prepadded"])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_head_conv_backward_plain_matches_autograd(k, prepadded):
    """Cout 1 to 4 with and without a bias, Cin = 5 (not a multiple of 16),
    and each gradient asked for alone. The kernel is the permuted OIHW
    weight, as HeadConv passes it (CPU autograd of a float64 conv refuses a
    weight gradient for any other layout)."""
    rng = np.random.RandomState(k + 10 * prepadded)
    grow = k - 1 if prepadded else 0
    x = _t(rng.randn(2, 7 + grow, 9 + grow, 5))

    def fn(a, w_oihw, c):
        return T_head.head_conv_plain(a, w_oihw.permute(2, 3, 1, 0), c, prepadded)

    for cout, with_bias in itertools.product((1, 2, 3, 4), (True, False)):
        w_oihw = _t(rng.randn(cout, 5, k, k))
        bias = _t(rng.randn(cout)) if with_bias else None
        cot = _t(rng.randn(2, 7, 9, cout))
        for needs in ((True, True, with_bias), (True, False, False), (False, True, False),
                      (False, False, with_bias)):
            if not any(needs):
                continue
            want = _autograd(fn, (x, w_oihw, bias), needs, cot)
            if needs[1]:
                want[1] = want[1].permute(2, 3, 1, 0)
            got = T_head.head_conv_backward_plain(cot, x, w_oihw.permute(2, 3, 1, 0), bias,
                                                  prepadded, needs=needs)
            _assert_grads(got, want, needs, ATOL64)


@pytest.mark.parametrize("stride", [1, 2])
def test_correlation_backward_plain_matches_corr_bwd_d4(stride):
    rng = np.random.RandomState(40 + stride)
    f1, f2 = (rng.randn(2, 7, 9, 8).astype(np.float32) for _ in range(2))
    ho, wo = -(-7 // stride), -(-9 // stride)
    cot = rng.randn(2, ho, wo, 81).astype(np.float32)
    want = jax.jit(functools.partial(_corr_bwd, 4, stride))(
        (jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(cot))
    got = T_corr.correlation_backward_plain(_t(cot), _t(f1), _t(f2), 4, stride)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL32)


@pytest.mark.parametrize("prepadded", [False, True], ids=["same", "prepadded"])
def test_head_conv_backward_plain_matches_hc_bwd_k1(prepadded):
    """k = 1, Cout = 4: the 1x1 heads, where 'same' and pre-padded agree."""
    rng = np.random.RandomState(50 + prepadded)
    x = rng.randn(2, 6, 10, 12).astype(np.float32)
    kernel = rng.randn(1, 1, 12, 4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    cot = rng.randn(2, 6, 10, 4).astype(np.float32)
    want = jax.jit(functools.partial(_hc_bwd, prepadded))(
        (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)), jnp.asarray(cot))
    got = T_head.head_conv_backward_plain(_t(cot), _t(x), _t(kernel), _t(bias), prepadded)
    for g, w in zip(got, want):
        # the weight and bias gradients sum over 120 pixels
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL32 * 10)


@pytest.mark.parametrize("name", ["correlation", "head_conv"])
def test_functions_run_the_closed_form_backward_on_the_cpu(name, monkeypatch):
    """On a CPU tensor the Function's backward runs once and gives the
    gradient of the plain forward without calling autograd (the plain VJP)
    or the backward kernel's wrapper (which refuses a CPU tensor)."""
    x = torch.rand(1, 6, 7, 8, requires_grad=True)
    if name == "correlation":
        fn_cls, plain, dispatch = (T_corr.CorrelationFunction, T_corr.correlation_plain,
                                   T_corr.correlation)
        args = (x, torch.rand(1, 6, 7, 8), 3, 1)
    else:
        fn_cls, plain, dispatch = (T_head.HeadConvFunction, T_head.head_conv_plain,
                                   T_head.head_conv)
        args = (x, torch.rand(3, 3, 8, 2), torch.rand(2), False)
    out = dispatch(*args)
    assert type(out.grad_fn).__name__.startswith(fn_cls.__name__)
    cot = torch.rand_like(out)
    want = torch.autograd.grad(plain(*args), x, cot)[0]
    monkeypatch.setattr(torch.autograd, "grad", lambda *a, **kw: pytest.fail("autograd.grad"))
    before = fn_cls.backward_calls
    out.backward(cot)
    assert fn_cls.backward_calls == before + 1
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), atol=ATOL32)


def test_backward_wrappers_refuse_cpu_tensors():
    """A backward kernel's wrapper launches its kernel or raises; it never
    computes on the CPU."""
    f = torch.zeros(1, 4, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        T_pcorr.correlation_backward_cuda(torch.zeros(1, 4, 5, 49), f, f)
    with pytest.raises(ValueError, match="CUDA"):
        T_head.head_conv_backward_cuda(torch.zeros(1, 4, 5, 2), f, torch.zeros(3, 3, 8, 2),
                                       torch.zeros(2))
    assert T_pcorr.correlation_backward_cuda.launches == 0
    assert T_head.head_conv_backward_cuda.launches == 0
