"""The layouts and decompositions that the port's tensor-core CUDA kernels
rely on, checked on the CPU in float32 against the port's plain versions
and the JAX package, on inputs made from numpy seeds.

* The strides the wrappers pass address the same elements as the tensors
  they stand for (HeadConv's permuted OIHW weight view, the [::2, ::2]
  view of f1), and a non-unit channel stride is refused.
* ``csrc/headconv.cu`` (tensor_core): per output row, one GEMM with
  (dx, co) in N over 64 staged input columns, then the shifted sum over dx.
* ``csrc/headconv.cu`` (reg_tile, float32 and odd shapes): 8 x 32 output
  tiles, the input staged 16 channels at a time with the k-1 halo and zero
  fill, each of 4 warps a channel quad of every chunk, a thread's strip of
  8 pixels summed from a register window of 8 + k - 1 staged pixels per
  (dy, quad), and the warps' partial outputs summed in warp order.
* ``csrc/correlation.cu`` (tensor_core): per tile row, 16-pixel m-tile and
  dy, a 16 x 24 banded GEMM of which the 2D+1 diagonals are kept.
* ``csrc/correlation.cu`` (reg_tile, float32 and odd shapes): 8 x 16 output
  tiles, f1 and the f2 tile with its D halo staged 16 channels at a time
  with zero fill, a cluster of CS blocks splitting a tile's chunks (block r
  the chunks r, r + CS, ...), per warp one dy and per thread a strip of 4
  pixels summed from a register window of 4 + 2D staged f2 pixels, and the
  blocks' partial tiles summed in rank order before the 1/C scale.

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
# the reg_tile head conv (csrc/headconv.cu): tile rows and columns, pixels
# per strip, warps per block; each warp takes 2 channel quads of a chunk for
# k <= 3, else 1
RT_ROWS, RT_COLS, RT_SEG, RT_SPLIT = 8, 32, 8, 4
CORR_COLS, CORR_F2_COLS = 32, 40  # correlation tile (csrc/correlation.cu)
# the reg_tile cost volume (csrc/correlation.cu): tile rows and columns,
# pixels per strip, float32 channels per staged chunk, the largest cluster
# and the grid it aims to fill
CR_ROWS, CR_COLS, CR_SEG, CR_CHUNK, CR_MAX_CLUSTER, CR_TARGET = 8, 16, 4, 16, 8, 132


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
    assert T_head.head_conv_variant(x.float(), kernel) == "reg_tile"
    x3 = torch.zeros(2, 12, 40, 3, dtype=torch.bfloat16)
    assert T_head.head_conv_variant(x3, torch.zeros(5, 5, 3, 2)) == "reg_tile"
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    assert T_head.head_conv_variant(buf[1:].view(x.shape), kernel) == "reg_tile"


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
    assert T_pcorr.correlation_variant(f1, f2) == "reg_tile"  # float32
    assert T_pcorr.correlation_variant(bf[..., :24], bf[..., :24]) == "reg_tile"


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


def _head_conv_reg_tile(x, kernel, bias, prepadded):
    """The reg_tile head conv's arithmetic. Per 8 x 32 output tile and chunk
    of 16 channels (32 for k <= 3), the input with its k-1 halo is staged
    with zero fill (outside the image and past Cin); warp s takes the
    chunk's channel quads s (and s + 4), where any of its channels is below
    Cin, in that order; per (dy, quad) a thread's
    strip of 8 output pixels reads the window of 8 + k - 1 staged pixels of
    its row and sums window[p + dx] against the (dy, dx) weights of the
    quad (Cin zero-padded to a multiple of 4). The 4 warps' partial tiles
    are summed in warp order and the bias added last."""
    n, in_h, in_w, cin = x.shape
    k, cout = kernel.shape[0], kernel.shape[3]
    pad = 0 if prepadded else (k - 1) // 2
    out_h, out_w = in_h + 2 * pad - (k - 1), in_w + 2 * pad - (k - 1)
    qpw = 2 if k <= 3 else 1
    chan = 4 * RT_SPLIT * qpw
    nchunks = -(-cin // chan)
    w = torch.zeros(k, k, -(-cin // 4) * 4, cout)
    w[:, :, :cin] = kernel
    win = RT_SEG + k - 1
    sr, sc = RT_ROWS + k - 1, RT_COLS + k - 1
    xp = torch.zeros(n, out_h + RT_ROWS + k, out_w + RT_COLS + k, nchunks * chan)
    xp[:, pad : pad + in_h, pad : pad + in_w, :cin] = x  # the zero fill
    # a strip's window: staged column strip * 8 + i, i < 8 + k - 1
    cols = (torch.arange(RT_COLS // RT_SEG) * RT_SEG)[:, None] + torch.arange(win)
    out = torch.zeros(n, out_h, out_w, cout)
    for y0 in range(0, out_h, RT_ROWS):
        for x0 in range(0, out_w, RT_COLS):
            red = torch.zeros(RT_SPLIT, n, RT_ROWS, RT_COLS // RT_SEG, RT_SEG, cout)
            for j in range(nchunks):
                staged = xp[:, y0 : y0 + sr, x0 : x0 + sc, j * chan : (j + 1) * chan]
                for s in range(RT_SPLIT):
                    for qq in range(qpw):
                        ql = qq * RT_SPLIT + s  # the quad within the chunk
                        c = j * chan + 4 * ql
                        if c >= cin:
                            break
                        quad = staged[..., 4 * ql : 4 * ql + 4]
                        for dy in range(k):
                            window = quad[:, dy : dy + RT_ROWS][:, :, cols]
                            for dx in range(k):
                                red[s] += window[:, :, :, dx : dx + RT_SEG] @ w[dy, dx, c : c + 4]
            tile = sum(red[s] for s in range(RT_SPLIT)).reshape(n, RT_ROWS, RT_COLS, cout)
            tile = tile + bias
            th, tw = min(RT_ROWS, out_h - y0), min(RT_COLS, out_w - x0)
            out[:, y0 : y0 + th, x0 : x0 + tw] = tile[:, :th, :tw]
    return out


# (k, cout, prepadded, cin, n, h, w) of the output: k 1-7, Cout 1-4, ragged
# tiles (h, w not multiples of 8 and 32), Cin not a multiple of the chunk
# (3, 8, 20, 40), maps smaller than one tile
REG_TILE_CASES = [(7, 2, False, 32, 2, 11, 40), (5, 2, False, 32, 1, 8, 33),
                  (3, 1, True, 16, 1, 9, 70), (3, 4, False, 20, 2, 5, 12),
                  (1, 3, False, 3, 2, 5, 9), (7, 3, True, 8, 1, 6, 20),
                  (5, 1, True, 40, 1, 10, 34)]


@pytest.mark.parametrize("k,cout,prepadded,cin,n,h,w", REG_TILE_CASES)
def test_head_conv_reg_tile_matches_plain_and_jax(k, cout, prepadded, cin, n, h, w):
    rng = np.random.RandomState(300 + 10 * k + cout)
    if prepadded:
        h, w = h + k - 1, w + k - 1
    x = rng.rand(n, h, w, cin).astype(np.float32)
    kern = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    got = _head_conv_reg_tile(_t(x), _t(kern), _t(b), prepadded)
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


def _cluster_size(tiles, nchunks):
    """csrc/correlation.cu cr_cluster: the smallest of 1, 2, 4, 8 blocks per
    tile whose grid covers CR_TARGET, with a chunk for every block."""
    cs = 1
    while cs < CR_MAX_CLUSTER and 2 * cs <= nchunks and tiles * cs < CR_TARGET:
        cs *= 2
    return cs


def _correlation_reg_tile(f1, f2, max_disp, stride):
    """The reg_tile cost volume's arithmetic on the stride-reduced maps. Per
    8 x 16 output tile, block r of the tile's cluster stages the chunks r,
    r + CS, ... of 16 channels of f1 (8 x 16 pixels) and of f2 (8 + 2D rows
    by 16 + 2D columns from (-D, -D)), zero outside the image and past C; per
    dy (a warp) and strip of 4 pixels (a thread) it sums the strip's f1
    pixels against the window of 4 + 2D f2 pixels of row y + dy, window[p +
    dx] for output (p, dx). The blocks' partial tiles are summed in rank
    order and scaled by 1/C. Returns the volume and the cluster sizes used."""
    f1, f2 = f1[:, ::stride, ::stride], f2[:, ::stride, ::stride]
    n, h, w, c = f1.shape
    d, kdim = max_disp, 2 * max_disp + 1
    nchunks = -(-c // CR_CHUNK)
    cs = _cluster_size(n * -(-h // CR_ROWS) * -(-w // CR_COLS), nchunks)
    cpad = nchunks * CR_CHUNK
    # the zero fill: outside the image and past C
    f1p = torch.zeros(n, h + CR_ROWS, w + CR_COLS, cpad)
    f1p[:, :h, :w, :c] = f1
    f2p = torch.zeros(n, h + CR_ROWS + 2 * d, w + CR_COLS + 2 * d, cpad)
    f2p[:, d : d + h, d : d + w, :c] = f2
    out = torch.zeros(n, h, w, kdim * kdim)
    win = CR_SEG + 2 * d
    for y0 in range(0, h, CR_ROWS):
        for x0 in range(0, w, CR_COLS):
            part = torch.zeros(cs, n, CR_ROWS, CR_COLS, kdim * kdim)
            for rank in range(cs):
                for j in range(rank, nchunks, cs):
                    chans = slice(j * CR_CHUNK, (j + 1) * CR_CHUNK)
                    a = f1p[:, y0 : y0 + CR_ROWS, x0 : x0 + CR_COLS, chans]
                    b = f2p[:, y0 : y0 + CR_ROWS + 2 * d, x0 : x0 + CR_COLS + 2 * d, chans]
                    for dy in range(kdim):
                        for s0 in range(0, CR_COLS, CR_SEG):
                            strip = a[:, :, s0 : s0 + CR_SEG]
                            window = b[:, dy : dy + CR_ROWS, s0 : s0 + win]
                            for dx in range(kdim):
                                part[rank, :, :, s0 : s0 + CR_SEG, dy * kdim + dx] += (
                                    strip * window[:, :, dx : dx + CR_SEG]).sum(-1)
            tile = part[0]
            for rank in range(1, cs):
                tile = tile + part[rank]
            th, tw = min(CR_ROWS, h - y0), min(CR_COLS, w - x0)
            out[:, y0 : y0 + th, x0 : x0 + tw] = tile[:, :th, :tw] * (1.0 / c)
    return out, cs


# (max_disp, stride, n, h, w, c): D = 3 and 4, stride 1 and 2, ragged tiles
# (h, w not multiples of 8 and 16), maps smaller than one tile, C below and
# not a multiple of the 16-channel chunk (8, 40) and C over several chunks
# split over 2 to 8 blocks (32, 130). The first six are held to XLA at
# shapes that the JAX package's tests compile already
# (test_correlation_banded_matches_plain_and_xla, test_torch_ops.py,
# test_model_parity.py's row-banded cases), the others to the plain version.
REG_TILE_CORR_XLA = [(3, 1, 2, 10, 36, 32), (4, 2, 2, 10, 36, 32), (3, 2, 2, 11, 13, 32),
                     (4, 1, 2, 11, 13, 32), (3, 1, 1, 13, 24, 8), (4, 1, 1, 10, 24, 8)]
REG_TILE_CORR_PLAIN = [(4, 1, 1, 9, 20, 40), (3, 1, 1, 3, 5, 130), (4, 2, 1, 1, 1, 24)]


@pytest.mark.parametrize(
    "max_disp,stride,n,h,w,c,xla",
    [(*case, True) for case in REG_TILE_CORR_XLA]
    + [(*case, False) for case in REG_TILE_CORR_PLAIN])
def test_correlation_reg_tile_matches_plain_and_xla(max_disp, stride, n, h, w, c, xla):
    rng = np.random.RandomState(400 + 10 * max_disp + stride + c)
    f1 = rng.randn(n, h, w, c).astype(np.float32)
    f2 = rng.randn(n, h, w, c).astype(np.float32)
    got, cs = _correlation_reg_tile(_t(f1), _t(f2), max_disp, stride)
    assert cs > 1 or c <= 16  # C over several chunks splits a tile over a cluster
    plain = T_corr.correlation_plain(_t(f1), _t(f2), max_disp, stride)
    assert got.shape == plain.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    if xla:
        want = J_corr.correlation_xla(jnp.asarray(f1), jnp.asarray(f2),
                                      max_disp=max_disp, stride=stride)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
