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
* The cost volume backward kernel's decomposition in plain torch: 8 x 16
  tiles, df1 and df2 in blocks of their own (df2 from the cotangent with
  mirrored taps, gathered at the shifted pixels), the cotangent staged
  tap-major in quads of pixels and read back per strip of 8 pixels, the
  map staged per chunk of 32 channels with its +-D halo (zero outside the
  image and past C), the chunks split over blocks or walked by one block,
  each output summed over the taps in order; against the closed form and
  ``_corr_bwd``.
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


# csrc/correlation_bwd.cu: tile rows and columns, pixels of a strip,
# channels of a chunk, the SMs of the card and the shared memory of one
CB_ROWS, CB_COLS, CB_SEG, CB_CHAN, CB_SMS, CB_SMEM_PER_SM = 8, 16, 8, 32, 132, 233472


def _cb_split(tile_maps, chunks, max_disp, sms):
    """The kernel's split of the chunks over blocks (float32): one chunk a
    block where that fits one wave of blocks with one buffer each, else the
    fewest splits that give each of ``sms`` SMs a block, every block walking
    an equal number of chunks."""
    kk = (2 * max_disp + 1) ** 2
    smem = 4 * (CB_ROWS * CB_COLS * kk + (CB_ROWS + 2 * max_disp) * (CB_COLS + 2 * max_disp)
                * CB_CHAN)
    per_sm = max(1, min(4, CB_SMEM_PER_SM // (smem + 1024)))
    if tile_maps * chunks <= per_sm * sms:
        return chunks
    want = min(chunks, -(-sms // tile_maps))
    return -(-chunks // -(-chunks // want))


def _one_thread(fn):
    """Run ``fn`` on one torch thread: its ops are on tensors of a few
    thousand elements, where waking a pool of threads costs more than the
    work."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_num_threads(threads)
    return run


@_one_thread
def _correlation_bwd_tiled(grad, f1, f2, max_disp, stride=1, needs=(True, True),
                           sms=CB_SMS):
    """The cost volume backward kernel's arithmetic, in float32, on the
    stride-reduced maps. Block ((tile * nsplit + split) * maps + m) owns an
    8 x 16 tile, gradient m (0: df1 from g and f2; 1: df2 from f1 and the
    cotangent with mirrored taps, g[q + d(k), K-1-k]) and the chunks split,
    split + nsplit, ... of 32 channels. It stages the cotangent as gm[e],
    e = (q / 4 * K + k) * 4 + q % 4 (zero outside the image), and reads it
    back per strip s of 8 pixels (tile row s / 2, columns 8 (s % 2) ..) at
    2s K 4 + (p / 4) K 4 + 4k + p % 4; per chunk it stages the map with its
    +-D halo (zero outside the image and past C) and sums each output over
    the taps k = 0, 1, ... in order against the halo pixel (row + dy + D,
    column + dx + D). Returns (df1, df2) (None where not asked for) and the
    split."""
    f1v, f2v = f1[:, ::stride, ::stride], f2[:, ::stride, ::stride]
    n, h, w, c = f1v.shape
    d = max_disp
    k_dim = 2 * d + 1
    kk = k_dim * k_dim
    tiles_x, tiles_y = -(-w // CB_COLS), -(-h // CB_ROWS)
    maps = [m for m, need in enumerate(needs) if need]
    chunks = -(-c // CB_CHAN)
    nsplit = _cb_split(tiles_x * tiles_y * n * len(maps), chunks, d, sms)
    inv_c = torch.tensor(1.0 / c, dtype=torch.float32)
    g = grad.float()
    outs = [torch.zeros(n, h, w, c) if need else None for need in needs]
    # the staging order of the cotangent and each copy's source
    e = torch.arange(CB_ROWS * CB_COLS * kk)
    k = (e >> 2) % kk
    q = e // (4 * kk) * 4 + (e & 3)
    # the reads: strip s, pixel p of the strip, tap k
    s_, p_, k_ = (torch.arange(CB_ROWS * CB_COLS // CB_SEG)[:, None, None],
                  torch.arange(CB_SEG)[None, :, None], torch.arange(kk)[None, None, :])
    reads = 2 * s_ * kk * 4 + (p_ >> 2) * kk * 4 + k_ * 4 + (p_ & 3)
    for blk in range(tiles_x * tiles_y * n * len(maps) * nsplit):
        m = maps[blk % len(maps)]
        rest = blk // len(maps)
        split, tile = rest % nsplit, rest // nsplit
        x0, y0 = tile % tiles_x * CB_COLS, tile // tiles_x % tiles_y * CB_ROWS
        b = tile // (tiles_x * tiles_y)
        yy, xx, t = y0 + q // CB_COLS, x0 + q % CB_COLS, k
        if m == 1:
            yy, xx, t = yy + k // k_dim - d, xx + k % k_dim - d, kk - 1 - k
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        gm = torch.where(ok, g[b, yy.clamp(0, h - 1), xx.clamp(0, w - 1), t], 0.0)
        # [strip, pixel, tap] -> [tile row, column, tap]
        gt = gm[reads].reshape(CB_ROWS, CB_COLS, kk)
        src = f2v if m == 0 else f1v
        # the block's chunks side by side (each is summed on its own)
        mine = range(split, chunks, nsplit)
        halo = torch.zeros(CB_ROWS + 2 * d, CB_COLS + 2 * d, len(mine), CB_CHAN)
        ys, xs = max(0, y0 - d), max(0, x0 - d)
        ye, xe = min(h, y0 + CB_ROWS + d), min(w, x0 + CB_COLS + d)
        for i, j in enumerate(mine):
            c0, c1 = j * CB_CHAN, min(c, (j + 1) * CB_CHAN)
            halo[ys - y0 + d : ye - y0 + d, xs - x0 + d : xe - x0 + d, i, : c1 - c0] = (
                src[b, ys:ye, xs:xe, c0:c1].float())
        acc = torch.zeros(CB_ROWS, CB_COLS, len(mine), CB_CHAN)
        for tap in range(kk):
            dyi, dxi = divmod(tap, k_dim)
            acc = acc + gt[:, :, tap, None, None] * halo[dyi : dyi + CB_ROWS,
                                                         dxi : dxi + CB_COLS]
        th, tw = min(CB_ROWS, h - y0), min(CB_COLS, w - x0)
        for i, j in enumerate(mine):
            c0, c1 = j * CB_CHAN, min(c, (j + 1) * CB_CHAN)
            outs[m][b, y0 : y0 + th, x0 : x0 + tw, c0:c1] = (
                acc[:th, :tw, i, : c1 - c0] * inv_c)
    full = []
    for out, src in zip(outs, (f1, f2)):
        if out is not None and stride != 1:
            grad_full = torch.zeros(src.shape)
            grad_full[:, ::stride, ::stride] = out
            out = grad_full
        full.append(out)
    return tuple(full), nsplit


# (max_disp, stride, n, h, w, c, needs, sms): ragged tiles with C off the
# chunk (40, 100, 70, 33) and split over blocks; a map smaller than a tile;
# a 1x1 map; C = 130 over five split chunks; a card of 4 or 2 SMs, so that
# one block walks 4 or 3 chunks (two splits of 2 and 2 at 3 SMs); each
# gradient alone
CB_TILED_CASES = [(3, 1, 2, 13, 41, 40, (True, True), CB_SMS),
                  (4, 2, 2, 21, 27, 32, (True, True), CB_SMS),
                  (3, 1, 1, 3, 5, 64, (True, True), CB_SMS),
                  (4, 1, 2, 1, 1, 24, (True, True), CB_SMS),
                  (3, 1, 1, 6, 20, 130, (True, True), CB_SMS),
                  (3, 1, 2, 13, 41, 100, (True, True), 4),
                  (4, 2, 1, 19, 37, 70, (True, True), 2),
                  (3, 1, 1, 6, 20, 100, (True, True), 3),
                  (3, 2, 2, 17, 35, 48, (True, False), CB_SMS),
                  (4, 1, 1, 9, 20, 33, (False, True), CB_SMS)]


@pytest.mark.parametrize("max_disp,stride,n,h,w,c,needs,sms", CB_TILED_CASES)
def test_correlation_backward_tiled_matches_plain(max_disp, stride, n, h, w, c, needs, sms):
    rng = np.random.RandomState(70 + 10 * max_disp + stride + c)
    f1 = _t(rng.randn(n, h, w, c).astype(np.float32))
    f2 = _t(rng.randn(n, h, w, c).astype(np.float32))
    ho, wo = -(-h // stride), -(-w // stride)
    cot = _t(rng.randn(n, ho, wo, (2 * max_disp + 1) ** 2).astype(np.float32))
    got, nsplit = _correlation_bwd_tiled(cot, f1, f2, max_disp, stride, needs, sms)
    chunks = -(-c // CB_CHAN)
    if sms < CB_SMS:
        assert 1 <= nsplit < chunks  # a block walks several chunks
    elif chunks > 1:
        assert nsplit == chunks  # one chunk a block
    want = T_corr.correlation_backward_plain(cot, f1, f2, max_disp, stride, needs=needs)
    # float32 sums of 49 or 81 products in another order than the closed
    # form's (df2's taps mirrored)
    _assert_grads(got, want, needs, ATOL32)


@pytest.mark.parametrize("stride", [1, 2])
def test_correlation_backward_tiled_matches_corr_bwd_d4(stride):
    """The shapes of ``test_correlation_backward_plain_matches_corr_bwd_d4``,
    so that XLA compiles nothing new."""
    rng = np.random.RandomState(40 + stride)
    f1, f2 = (rng.randn(2, 7, 9, 8).astype(np.float32) for _ in range(2))
    ho, wo = -(-7 // stride), -(-9 // stride)
    cot = rng.randn(2, ho, wo, 81).astype(np.float32)
    want = jax.jit(functools.partial(_corr_bwd, 4, stride))(
        (jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(cot))
    got, _ = _correlation_bwd_tiled(_t(cot), _t(f1), _t(f2), 4, stride)
    for g, wj in zip(got, want):
        assert g.shape == wj.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=ATOL32)


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
