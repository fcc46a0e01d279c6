"""The closed-form backward pass of the regularization filter with its
confidence normalisation, on the CPU: the plain version that
``RegDistFilterFunction`` runs on a CPU tensor and that ``chip_smoke.py``
holds the backward kernel (``csrc/regfilter_bwd.cu``) to on the card.

* ``reg_dist_filter_backward_plain`` against autograd of
  ``reg_dist_filter_plain`` in float64: k = 3, 5 and 7, odd maps smaller
  and larger than the window, every subset of requested gradients, the
  conv's parameter shapes, ties at the minimal |raw| and taps whose
  weights underflow to 0.
* The same against the JAX package: ``jax.vjp`` of the normalisation of
  ``dfvo_tpu/models/liteflownet.py`` composed with ``reg_scale_filter``
  (whose backward is ``_rf_bwd``), in float32, on inputs made with numpy.
* The Function reaches the closed form on the CPU, and the backward
  kernel's wrapper refuses CPU tensors.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvo_torch.ops import regfilter as T_reg
from dfvo_tpu.ops.regfilter import reg_scale_filter

# float64 sums of at most 49 taps or 100 pixels of terms of order 10 in
# another order than autograd's: rounding near 1e-14
ATOL64 = 1e-12
# float32 against XLA, relative to max(1, |ref|): the same sums in float32
RTOL32 = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(rng, n, h, w, k, dtype=np.float64):
    """raw [N,H,W,k²] with, at every third pixel, a tie at the minimal |raw|
    (raw_i = -raw_j, and a three-way tie at every sixth), and at every fourth
    pixel taps of |raw| 30 or more whose weights exp(m - raw²) underflow to
    0; flow [N,H,W,2]; the scale convs' weights [1,k²,1,1] and biases [1]."""
    kk = k * k
    raw = rng.randn(n, h, w, kk) * 2.0
    flat = raw.reshape(-1, kk)
    for i in range(0, flat.shape[0], 3):
        a, b, c = rng.choice(kk, 3, replace=False)
        v = 0.1 * rng.rand() + 1e-3
        flat[i] = np.sign(flat[i]) * np.maximum(np.abs(flat[i]), 0.5)
        flat[i, a], flat[i, b] = v, -v
        if i % 6 == 0:
            flat[i, c] = v
    for i in range(1, flat.shape[0], 4):
        far = rng.choice(kk, kk // 2, replace=False)
        flat[i, far] = np.sign(rng.randn(len(far))) * (30.0 + rng.rand(len(far)))
    flow = rng.randn(n, h, w, 2) * 4.0
    wx, wy = (rng.randn(1, kk, 1, 1) for _ in range(2))
    bx, by = (rng.randn(1) for _ in range(2))
    return [x.astype(dtype) for x in (raw, flow, wx, bx, wy, by)]


def _autograd(inputs, k, cot):
    leaves = [_t(x).requires_grad_(True) for x in inputs]
    out = T_reg.reg_dist_filter_plain(*leaves, k)
    return torch.autograd.grad(out, leaves, _t(cot))


@pytest.mark.parametrize("hw", [(3, 5), (9, 11)], ids=["small", "large"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_reg_dist_filter_backward_plain_matches_autograd(k, hw):
    """Every subset of ``needs`` gives the requested gradients, in their
    inputs' shapes and dtype, and None for the others."""
    rng = np.random.RandomState(k + 10 * hw[0])
    inputs = _inputs(rng, 2, *hw, k)
    raw = inputs[0].reshape(-1, k * k)
    s = raw * raw
    assert ((s == s.min(axis=1, keepdims=True)).sum(axis=1) >= 2).any()
    assert (np.exp(s.min(axis=1, keepdims=True) - s) == 0).any()
    cot = rng.randn(2, *hw, 2)
    want = _autograd(inputs, k, cot)
    for needs in itertools.product((True, False), repeat=6):
        if not any(needs):
            continue
        got = T_reg.reg_dist_filter_backward_plain(_t(cot), *map(_t, inputs), k, needs=needs)
        assert len(got) == 6
        for i, (g, w, need) in enumerate(zip(got, want, needs)):
            if not need:
                assert g is None, (needs, i)
                continue
            assert g.shape == w.shape and g.dtype == w.dtype, (needs, i)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL64,
                                       err_msg=f"needs {needs}, gradient {i}")


def _jax_grads(inputs, k, cot):
    """jax.vjp of liteflownet.py's normalisation composed with
    reg_scale_filter (XLA form; its backward is _rf_bwd), jitted. The
    weights in the JAX package's [1,1,k²,1] shape."""

    def fn(raw, flow, wx, bx, wy, by):
        dist = -(raw**2)
        dist = jnp.exp(dist - jnp.max(dist, axis=-1, keepdims=True))
        return reg_scale_filter(dist, flow, wx, bx, wy, by, k, use_pallas=False)

    def vjp(cot, *args):
        return jax.vjp(fn, *args)[1](cot)

    kk = k * k
    args = [jnp.asarray(x) for x in inputs]
    args[2], args[4] = args[2].reshape(1, 1, kk, 1), args[4].reshape(1, 1, kk, 1)
    return jax.jit(vjp)(jnp.asarray(cot), *args)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_reg_dist_filter_backward_plain_matches_rf_bwd(k):
    rng = np.random.RandomState(60 + k)
    inputs = _inputs(rng, 2, 7, 9, k, np.float32)
    cot = rng.randn(2, 7, 9, 2).astype(np.float32)
    want = _jax_grads(inputs, k, cot)
    got = T_reg.reg_dist_filter_backward_plain(_t(cot), *map(_t, inputs), k)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).reshape(g.shape)
        assert g.dtype == torch.float32
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=RTOL32 * scale,
                                   err_msg=f"gradient {i}")


def test_function_runs_the_closed_form_backward_on_the_cpu(monkeypatch):
    """On a CPU tensor the Function's backward runs once and gives autograd's
    gradients of the plain forward, for a cotangent that is a
    non-contiguous view, without building an autograd graph (the plain
    version's VJP) or calling the backward kernel's wrapper."""
    rng = np.random.RandomState(70)
    inputs = _inputs(rng, 1, 6, 7, 5)
    leaves = [_t(x).requires_grad_(True) for x in inputs]
    out = T_reg.reg_dist_filter(*leaves, 5)
    assert type(out.grad_fn).__name__.startswith("RegDistFilterFunction")
    cot = _t(rng.randn(1, 2, 6, 7)).permute(0, 2, 3, 1)
    assert not cot.is_contiguous()
    want = _autograd(inputs, 5, cot.numpy())
    monkeypatch.setattr(torch.autograd, "grad", lambda *a, **kw: pytest.fail("autograd.grad"))
    monkeypatch.setattr(T_reg, "reg_dist_filter_backward_cuda",
                        lambda *a, **kw: pytest.fail("the backward kernel's wrapper"))
    before = T_reg.RegDistFilterFunction.backward_calls
    out.backward(cot)
    assert T_reg.RegDistFilterFunction.backward_calls == before + 1
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(leaf.grad.numpy(), w.numpy(), rtol=0, atol=ATOL64,
                                   err_msg=f"gradient {i}")


def test_reg_dist_filter_backward_cuda_refuses_cpu_tensors():
    """The backward kernel's wrapper launches its kernel or raises; it never
    computes on the CPU."""
    args = (torch.zeros(1, 4, 5, 2), torch.zeros(1, 4, 5, 9), torch.zeros(1, 4, 5, 2),
            torch.zeros(1, 9, 1, 1), torch.zeros(1), torch.zeros(1, 9, 1, 1), torch.zeros(1), 3)
    with pytest.raises(ValueError, match="CUDA"):
        T_reg.reg_dist_filter_backward_cuda(*args)
    assert T_reg.reg_dist_filter_backward_cuda.launches == 0
