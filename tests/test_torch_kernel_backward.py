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
* The head conv backward kernel's decomposition in plain torch: tiles of
  the input map, the channel chunks (16, or 32 for k <= 3), dx from a
  register window of the staged cotangent per ky, dw from one walk over
  each staged input row with the cotangent's last k columns in a window
  (row groups added in order), and the per-block partials summed in the
  second launch's order (each of 8 warps the partials w, w + 8, ..., then
  the warps in order); against the closed form and ``_hc_bwd``.
* The Functions reach the closed forms on the CPU, and the backward
  kernels' wrappers refuse CPU tensors.
"""

import functools
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


# csrc/headconv_bwd.cu: tile rows (halved down to 2 for small maps) and
# columns, pixels per dx thread, threads and most blocks of a launch, warps
# of the partials' sum; channels per chunk: 32 for k <= 3, else 16
HB_ROWS, HB_MIN_ROWS, HB_COLS, HB_SEG = 8, 2, 32, 8
HB_THREADS, HB_MAX_BLOCKS, HB_REDUCE_WARPS = 256, 264, 8


def _hb_tiles(n, in_h, in_w, rows):
    return n * -(-in_h // rows) * -(-in_w // HB_COLS)


def _hb_reduce(part):
    """headconv_bwd_reduce_kernel's sum over the partials (dim 0), in
    float32: warp w sums the partials w, w + 8, ... from zero, then the 8
    warps' sums are added in order from zero."""
    total = torch.zeros_like(part[0])
    for warp in range(HB_REDUCE_WARPS):
        s = torch.zeros_like(part[0])
        for p in range(warp, len(part), HB_REDUCE_WARPS):
            s = s + part[p]
        total = total + s
    return total


def _head_conv_bwd_tiled(grad, x, kernel, bias, prepadded, max_blocks=HB_MAX_BLOCKS):
    """The head conv backward kernel's arithmetic, in float32. Blocks stride
    over rows x 32 tiles of the input map; per tile the cotangent is staged
    with its k-1 halo (zero outside the output), per chunk of 16 channels
    (32 for k <= 3) the input with its halo (zero outside the image and
    past Cin). dx: per ky a
    window of 8 + k - 1 staged cotangent vectors of the row of a strip of 8
    pixels, tap kx reading window[r + k-1-kx]. dw: thread (group, ky, c)
    walks staged row py + ky column by column, the cotangent at columns
    i - kx in a window of k (zero outside 0..31); the row groups add into
    the block's running sums in order. The per-block partials are summed as
    the second launch sums them (:func:`_hb_reduce`).
    Returns (dx, dw, db) and the number of partials."""
    n, in_h, in_w, cin = x.shape
    k, cout = kernel.shape[0], kernel.shape[3]
    pad = 0 if prepadded else (k - 1) // 2
    out_h, out_w = grad.shape[1:3]
    rows = HB_ROWS
    while rows > HB_MIN_ROWS and _hb_tiles(n, in_h, in_w, rows) < max_blocks:
        rows //= 2
    ntiles = _hb_tiles(n, in_h, in_w, rows)
    blocks = min(ntiles, max_blocks)
    hh, hw, win = rows + k - 1, HB_COLS + k - 1, HB_SEG + k - 1
    chan = 32 if k <= 3 else 16
    nchunks = -(-cin // chan)
    # zero-filled sources of the staging, indexed from the staged origins
    gsrc = torch.zeros(n, in_h + rows + 2 * k, in_w + HB_COLS + 2 * k, cout)
    gsrc[:, k - 1 : k - 1 + out_h, k - 1 : k - 1 + out_w] = grad
    xsrc = torch.zeros(n, in_h + rows + k, in_w + HB_COLS + k, nchunks * chan)
    xsrc[:, pad : pad + in_h, pad : pad + in_w, :cin] = x
    w = torch.zeros(k, k, nchunks * chan, cout)
    w[:, :, :cin] = kernel
    dx = torch.zeros(n, in_h + rows, in_w + HB_COLS, nchunks * chan)
    part = torch.zeros(blocks, k, k, nchunks * chan, cout)
    part_db = torch.zeros(blocks, cout)
    tiles_x, tiles_y = -(-in_w // HB_COLS), -(-in_h // rows)
    seg = torch.arange(HB_COLS // HB_SEG)[:, None] * HB_SEG + torch.arange(win)
    for blk in range(blocks):
        for tile in range(blk, ntiles, blocks):
            b = tile // (tiles_x * tiles_y)
            y0, x0 = (tile // tiles_x) % tiles_y * rows, tile % tiles_x * HB_COLS
            # gh pixel (j, i) <-> output (y0 + pad - (k-1) + j, x0 + pad - (k-1) + i)
            gh = gsrc[b, y0 + pad : y0 + pad + hh, x0 + pad : x0 + pad + hw]
            gtile = torch.zeros(rows, hw, cout)  # the tile's outputs, zero past column 31
            gtile[:, :HB_COLS] = gh[k - 1 - pad : k - 1 - pad + rows,
                                    k - 1 - pad : k - 1 - pad + HB_COLS]
            part_db[blk] += gtile.sum(dim=(0, 1))
            for j in range(nchunks):
                ch = slice(j * chan, (j + 1) * chan)
                xs = xsrc[b, y0 : y0 + hh, x0 : x0 + hw, ch]
                tdx = torch.zeros(rows, HB_COLS // HB_SEG, HB_SEG, chan)
                for ky in range(k):
                    window = gh[k - 1 - ky : k - 1 - ky + rows][:, seg]  # [rows, 4, win, cout]
                    for kx in range(k):
                        tdx += window[:, :, k - 1 - kx : k - 1 - kx + HB_SEG] @ w[ky, kx, ch].T
                dx[b, y0 : y0 + rows, x0 : x0 + HB_COLS, ch] = tdx.reshape(rows, HB_COLS, -1)
                groups = 1
                while 2 * groups <= rows and 2 * groups * k * chan <= HB_THREADS:
                    groups *= 2
                for grp in range(groups):
                    sw = torch.zeros(k, k, chan, cout)
                    for py in range(grp, rows, groups):
                        for ky in range(k):
                            for kx in range(k):
                                # column i meets the cotangent at column i - kx
                                shifted = F.pad(gtile[py], (0, 0, kx, 0))[:hw]
                                sw[ky, kx] += xs[py + ky].T @ shifted
                    part[blk, :, :, ch] += sw
    return dx[:, :in_h, :in_w, :cin], _hb_reduce(part)[:, :, :cin], _hb_reduce(part_db), blocks


# (k, cout, prepadded, cin, n, h, w) of the input; the last field caps the
# blocks (the kernel's 264 unless smaller, so that blocks stride over tiles
# of 8 rows)
HC_BWD_TILED_CASES = [(7, 2, False, 32, 2, 20, 70, HB_MAX_BLOCKS),
                      (5, 2, False, 32, 1, 19, 40, 5),
                      (3, 1, True, 16, 1, 11, 36, HB_MAX_BLOCKS),
                      (3, 4, False, 20, 2, 7, 9, HB_MAX_BLOCKS),
                      (1, 4, False, 12, 2, 6, 10, HB_MAX_BLOCKS),
                      (7, 3, True, 8, 1, 13, 45, 3)]


@pytest.mark.parametrize("k,cout,prepadded,cin,n,h,w,max_blocks", HC_BWD_TILED_CASES)
def test_head_conv_backward_tiled_matches_plain_and_hc_bwd(k, cout, prepadded, cin, n, h, w,
                                                           max_blocks):
    """The ragged cases have H and W off the tile sizes and Cin off the
    chunk (20, 12, 8); (1, 4, ..., 12, 2, 6, 10) is the map smaller than a
    tile of ``test_head_conv_backward_plain_matches_hc_bwd_k1``; the first
    case's 60 blocks give each warp of the partials' sum 7 or 8 of them."""
    rng = np.random.RandomState(60 + 10 * k + cout)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    kernel = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    grow = k - 1 if prepadded else 0
    cot = rng.randn(n, h - grow, w - grow, cout).astype(np.float32)
    *got, blocks = _head_conv_bwd_tiled(_t(cot), _t(x), _t(kernel), _t(bias), prepadded,
                                        max_blocks)
    if (k, max_blocks) == (7, HB_MAX_BLOCKS):
        assert blocks >= 7 * HB_REDUCE_WARPS
    plain = T_head.head_conv_backward_plain(_t(cot), _t(x), _t(kernel), _t(bias), prepadded)
    want = jax.jit(functools.partial(_hc_bwd, prepadded))(
        (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)), jnp.asarray(cot))
    for g, p, wj in zip(got, plain, want):
        assert g.shape == p.shape == wj.shape
        # dw and db sum over up to 2 x 20 x 70 pixels
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=ATOL32 * 10)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), rtol=1e-5, atol=ATOL32 * 10)


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
