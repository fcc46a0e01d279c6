"""The layouts and decompositions that the port's tensor-core CUDA kernels
rely on, checked on the CPU in float32 against the port's plain versions
and the JAX package, on inputs made from numpy seeds.

* The strides the wrappers pass address the same elements as the tensors
  they stand for (HeadConv's permuted OIHW weight view, the [::2, ::2]
  view of f1), and a non-unit channel stride is refused.
* ``csrc/headconv.cu`` (tensor_core): per output row, one GEMM with
  (dx, co) in N over 64 staged input columns, then the shifted sum over dx.
* ``csrc/correlation.cu`` (tensor_core): per tile row, 16-pixel m-tile and
  dy, a 16 x 24 banded GEMM of which the 2D+1 diagonals are kept.

The decompositions are written here in plain torch with the kernels' tile
sizes, staging offsets and zero fill, so an index error in that arithmetic
shows on the CPU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dfvo_torch.models.layers import HeadConv
from dfvo_torch.ops import correlation as T_corr
from dfvo_torch.ops import headconv as T_head
from dfvo_torch.ops import pallas_corr as T_pcorr
from dfvo_tpu.ops import correlation as J_corr
from dfvo_tpu.ops import headconv as J_head

# float32 sums of at most 7*7*32 products of order-1 terms, in another order
# than the references: a few ulp of values of order 1
ATOL = 1e-5

HC_COLS = 64  # staged input columns per head-conv block (csrc/headconv.cu)
CORR_COLS, CORR_F2_COLS = 32, 40  # correlation tile (csrc/correlation.cu)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _addressed(flat, offset, strides, shape):
    """flat[offset + sum_i idx_i * strides_i] over every index of shape."""
    idx = np.full(shape, offset, dtype=np.int64)
    for axis, (size, stride) in enumerate(zip(shape, strides)):
        view = [1] * len(shape)
        view[axis] = size
        idx = idx + (np.arange(size) * stride).reshape(view)
    return flat[torch.from_numpy(idx)]


def test_head_conv_weight_strides_address_the_oihw_parameter():
    rng = np.random.RandomState(0)
    conv = HeadConv(32, 2, 7)
    with torch.no_grad():
        conv.weight.copy_(_t(rng.randn(*conv.weight.shape).astype(np.float32)))
    kernel = conv.weight.detach().permute(2, 3, 1, 0)  # as HeadConv.forward
    assert not kernel.is_contiguous()
    flat = conv.weight.detach().reshape(-1)
    got = _addressed(flat, kernel.storage_offset(), kernel.stride(), kernel.shape)
    assert torch.equal(got, kernel)
    assert torch.equal(
        torch.as_strided(conv.weight.detach(), kernel.shape, kernel.stride(),
                         kernel.storage_offset()),
        kernel.contiguous(),
    )
    # the bf16 main-path shapes take the tensor-core kernel, odd ones do not
    x = torch.zeros(2, 12, 40, 32, dtype=torch.bfloat16)
    assert T_head.head_conv_variant(x, kernel.bfloat16()) == "tensor_core"
    assert T_head.head_conv_variant(x.float(), kernel) == "cuda_core"
    x3 = torch.zeros(2, 12, 40, 3, dtype=torch.bfloat16)
    assert T_head.head_conv_variant(x3, torch.zeros(5, 5, 3, 2)) == "cuda_core"
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    assert T_head.head_conv_variant(buf[1:].view(x.shape), kernel) == "cuda_core"


def test_correlation_strides_address_the_subsampled_view():
    rng = np.random.RandomState(1)
    full = _t(rng.randn(2, 12, 20, 32).astype(np.float32))
    f1 = full[:, ::2, ::2]
    assert not f1.is_contiguous()
    sn, sh, sw = T_pcorr.pixel_strides(f1)
    got = _addressed(full.reshape(-1), f1.storage_offset(), (sn, sh, sw, 1),
                     f1.shape)
    assert torch.equal(got, f1)
    assert torch.equal(
        torch.as_strided(full, f1.shape, (sn, sh, sw, 1), f1.storage_offset()), f1)
    f2 = torch.zeros(f1.shape)
    bf = full.bfloat16()
    assert T_pcorr.correlation_variant(bf[:, ::2, ::2], f2.bfloat16()) == "tensor_core"
    assert T_pcorr.correlation_variant(f1, f2) == "cuda_core"  # float32
    assert T_pcorr.correlation_variant(bf[..., :24], bf[..., :24]) == "cuda_core"


def test_non_unit_channel_stride_is_refused():
    nchw = torch.zeros(1, 8, 4, 4)
    with pytest.raises(ValueError, match="channel stride"):
        T_pcorr.pixel_strides(nchw.permute(0, 2, 3, 1)[..., ::2])
    with pytest.raises(ValueError, match="channel stride"):
        T_pcorr.pixel_strides(torch.zeros(1, 4, 4, 8).transpose(2, 3))


def _head_conv_row_gemm(x, kernel, bias, prepadded):
    """The tensor-core head conv's arithmetic: 64-column input strips with
    zero fill, P = sum_dy X[y+dy-pad] @ B[dy] with B[dy][ci, dx*Cout+co]
    padded to 8-wide n-tiles, then out[x] = sum_dx P[x+dx, dx*Cout+co]."""
    n, in_h, in_w, cin = x.shape
    k, cout = kernel.shape[0], kernel.shape[3]
    pad = 0 if prepadded else (k - 1) // 2
    out_h, out_w = (in_h - 2 * (k // 2), in_w - 2 * (k // 2)) if prepadded else (in_h, in_w)
    nt = (k * cout + 7) // 8
    B = torch.zeros(k, cin, nt * 8)
    for dx in range(k):
        for co in range(cout):
            B[:, :, dx * cout + co] = kernel[:, dx, :, co]
    tw = HC_COLS - (k - 1)
    out = torch.zeros(n, out_h, out_w, cout)
    for x0 in range(0, out_w, tw):
        cols = torch.arange(HC_COLS) + x0 - pad
        col_ok = (cols >= 0) & (cols < in_w)
        for y in range(out_h):
            P = torch.zeros(n, HC_COLS, nt * 8)
            for dy in range(k):
                iy = y + dy - pad
                if not 0 <= iy < in_h:
                    continue  # a zero-filled staged row
                X = torch.zeros(n, HC_COLS, cin)
                X[:, col_ok] = x[:, iy, cols[col_ok]]
                P += X @ B[dy]
            for xo in range(min(tw, out_w - x0)):
                for co in range(cout):
                    v = sum(P[:, xo + dx, dx * cout + co] for dx in range(k))
                    out[:, y, x0 + xo, co] = v + bias[co]
    return out


@pytest.mark.parametrize("prepadded", [False, True])
@pytest.mark.parametrize("cout", [1, 2])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_head_conv_row_gemm_matches_plain_and_jax(k, cout, prepadded):
    rng = np.random.RandomState(100 + 10 * k + 2 * cout + prepadded)
    # 70 output columns: two strips, the second one ragged
    n, cin, h, w = 2, 16 if k == 3 else 32, 5, 70
    if prepadded:
        h, w = h + k - 1, w + k - 1
    x = rng.rand(n, h, w, cin).astype(np.float32)
    kern = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    got = _head_conv_row_gemm(_t(x), _t(kern), _t(b), prepadded)
    plain = T_head.head_conv_plain(_t(x), _t(kern), _t(b), prepadded)
    want = J_head.head_conv(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(b),
                            prepadded=prepadded)
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _correlation_banded(f1, f2, max_disp, stride, th=4):
    """The tensor-core cost volume's arithmetic on the stride-reduced maps:
    TH x 32 output tiles, f2 staged as (TH+2D) x 40 pixels from (-D, -D)
    with zero fill, per (row, 16-pixel m-tile, dy) a [16 x C] @ [C x 24]
    product of which the diagonals n - prow in [0, 2D] are kept."""
    f1, f2 = f1[:, ::stride, ::stride], f2[:, ::stride, ::stride]
    n, h, w, c = f1.shape
    d, kdim = max_disp, 2 * max_disp + 1
    out = torch.zeros(n, h, w, kdim * kdim)
    f2p = F.pad(f2, (0, 0, d, CORR_F2_COLS + d, d, th + d))  # the zero fill
    f1p = F.pad(f1, (0, 0, 0, CORR_COLS, 0, th))
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, CORR_COLS):
            t2 = f2p[:, ty0 : ty0 + th + 2 * d, tx0 : tx0 + CORR_F2_COLS]
            for row in range(th):
                for m in range(2):
                    A = f1p[:, ty0 + row, tx0 + 16 * m : tx0 + 16 * m + 16]
                    for dy in range(kdim):
                        Bt = t2[:, row + dy, 16 * m : 16 * m + 24]
                        P = A @ Bt.transpose(1, 2) / c  # [n, 16, 24]
                        for prow in range(16):
                            x = tx0 + 16 * m + prow
                            if ty0 + row >= h or x >= w:
                                continue
                            out[:, ty0 + row, x, dy * kdim : (dy + 1) * kdim] = (
                                P[:, prow, prow : prow + kdim])
    return out


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("max_disp", [3, 4])
def test_correlation_banded_matches_plain_and_xla(max_disp, stride):
    rng = np.random.RandomState(200 + 10 * max_disp + stride)
    # 10 x 36 at stride 1: a ragged row tile and a ragged column tile
    f1 = rng.randn(2, 10, 36, 32).astype(np.float32)
    f2 = rng.randn(2, 10, 36, 32).astype(np.float32)
    got = _correlation_banded(_t(f1), _t(f2), max_disp, stride)
    plain = T_corr.correlation_plain(_t(f1), _t(f2), max_disp, stride)
    want = J_corr.correlation_xla(jnp.asarray(f1), jnp.asarray(f2),
                                  max_disp=max_disp, stride=stride)
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
