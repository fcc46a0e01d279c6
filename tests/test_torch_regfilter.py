"""The fused confidence normalisation and flow filter of the PyTorch port
(``dfvo_torch.ops.regfilter``), on the CPU in float32, against the JAX
package and against a plain-torch model of the CUDA kernel's tiling.

* ``reg_dist_filter_plain`` equals the JAX composition
  ``exp(-(raw²) - max)`` then ``dfvo_tpu.ops.regfilter.reg_scale_filter``
  (XLA form) and ``_regfilter_pallas`` (interpret mode), also where every
  tap but the minimum underflows.
* ``csrc/regfilter.cu``'s index arithmetic, written here in plain torch
  with the kernel's tile sizes: 8 x 32 pixel tiles, each tile row's raw taps
  copied as one byte span (a 16-byte-aligned body, an element-wise head and
  tail) into a shared row region that starts on the span's 16-byte block,
  a zero-filled flow halo, and bf16 taps read as 32-bit words aligned with
  a funnel shift. Ragged right and bottom tiles and unaligned base
  addresses are covered, so an index error shows on the CPU.
* The CUDA wrapper's refusals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dfvo_torch.ops import regfilter as T_reg
from dfvo_tpu.ops import regfilter as J_reg

# float32 sums over <= 49 taps in another order than XLA: a few ulp of
# values of order 1
ATOL = 1e-5

TILE_ROWS, TILE_COLS = 8, 32  # csrc/regfilter.cu kRfRows, kRfCols


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, n, h, w, k, raw_scale=1.0):
    rng = np.random.RandomState(seed)
    kk = k * k
    return (
        (rng.randn(n, h, w, kk) * raw_scale).astype(np.float32),
        (rng.rand(n, h, w, 2) - 0.5).astype(np.float32) * 3,
        (rng.rand(1, 1, kk, 1) - 0.5).astype(np.float32),
        rng.rand(1).astype(np.float32),
        (rng.rand(1, 1, kk, 1) - 0.5).astype(np.float32),
        rng.rand(1).astype(np.float32),
    )


def _jax_normalise(raw):
    d = -(jnp.asarray(raw) ** 2)
    return jnp.exp(d - jnp.max(d, axis=-1, keepdims=True))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_reg_dist_filter_plain_matches_jax_xla(k):
    raw, flow, wx, bx, wy, by = _inputs(k, 2, 12, 40, k)
    got = T_reg.reg_dist_filter(*map(_t, (raw, flow, wx, bx, wy, by)), k)
    want = J_reg.reg_scale_filter(_jax_normalise(raw),
                                  *map(jnp.asarray, (flow, wx, bx, wy, by)), k,
                                  use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_reg_dist_filter_plain_matches_pallas_interpret(k):
    raw, flow, wx, bx, wy, by = _inputs(200 + k, 1, 20, 84, k)
    with pltpu.force_tpu_interpret_mode():
        want = J_reg._regfilter_pallas(_jax_normalise(raw),
                                       *map(jnp.asarray, (flow, wx, bx, wy, by)), k)
    got = T_reg.reg_dist_filter_plain(*map(_t, (raw, flow, wx, bx, wy, by)), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_reg_dist_filter_plain_underflow_stays_finite():
    """Raw values of ±300: exp(min raw² - raw_j²) underflows to 0 for every
    tap but the minimum, which gives exp(0) = 1, so the divisor stays 1."""
    k = 7
    raw, flow, wx, bx, wy, by = _inputs(7, 2, 12, 40, k)
    rng = np.random.RandomState(70)
    raw = (np.sign(raw) * (300.0 + rng.rand(*raw.shape) * 5.0)).astype(np.float32)
    got = T_reg.reg_dist_filter_plain(*map(_t, (raw, flow, wx, bx, wy, by)), k)
    assert torch.isfinite(got).all()
    want = J_reg.reg_scale_filter(_jax_normalise(raw),
                                  *map(jnp.asarray, (flow, wx, bx, wy, by)), k,
                                  use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the same value through the kernel's model
    model = _kernel_model(_t(raw), _t(flow), *map(_t, (wx, bx, wy, by)), k, 4, 0)
    np.testing.assert_allclose(model.numpy(), got.numpy(), atol=ATOL)


def _stage_row(raw_flat, elem0, ncols, kk, sz, base_addr):
    """One warp's copy of a tile row: the shared row region (indexed in
    elements of ``sz`` bytes) and the span's offset into it, as
    ``rf_stage`` computes them from byte addresses. Returns the region, the
    byte shift of the span's start, and the byte size of the region the
    kernel reserves (``RfTile::ROW``)."""
    row_bytes = -(-(TILE_COLS * kk * sz + 16) // 16) * 16
    gs = base_addr + elem0 * sz
    ge = gs + ncols * kk * sz
    base = gs & ~15
    a0, a1 = (gs + 15) & ~15, ge & ~15
    head_end = min(a0, ge)
    tail_beg = max(a1, head_end)
    region = torch.full((row_bytes // sz,), float("nan"))
    filled = np.zeros(row_bytes // sz, bool)

    def put(addr):
        off = addr - base
        assert off % sz == 0 and 0 <= off < row_bytes
        region[off // sz] = raw_flat[(addr - base_addr) // sz]
        filled[off // sz] = True

    for a in range(head_end, tail_beg, 16):  # cp.async, 16 bytes each
        assert a % 16 == 0
        for e in range(16 // sz):
            put(a + e * sz)
    nhead = (head_end - gs) // sz
    ntail = (ge - tail_beg) // sz
    assert nhead + ntail <= 32  # one element per lane
    for lane in range(nhead + ntail):
        put(gs + lane * sz if lane < nhead else tail_beg + (lane - nhead) * sz)
    shift = gs & 15
    # every element of the span landed exactly where the compute reads it
    assert filled[shift // sz : shift // sz + ncols * kk].all()
    assert filled.sum() == ncols * kk
    return region, shift, row_bytes


def _bf16_tap_index(off, j, kk):
    """Shared halfword that ``Taps<bf16>`` returns as tap j for a thread
    whose taps start at byte offset ``off``: it loads (kk+1)/2 words from
    ``off & ~3`` and funnel-shifts them by 16 bits when ``off`` is odd in
    halfwords. Returns the halfword index and the highest byte read."""
    nw = (kk + 1) // 2
    first_word = (off & ~3) // 4
    par = (off & 2) // 2
    # aligned word i holds halfwords 2i+par (low) and 2i+1+par (high) of the
    # loaded words
    half = 2 * (j // 2) + (j & 1) + par
    return 2 * first_word + half, 4 * (first_word + nw)


def _kernel_model(raw, flow, wx, bx, wy, by, k, sz, base_off):
    """``reg_dist_filter`` computed tile by tile as the kernel does, with
    element size ``sz`` (2 or 4 bytes) and the raw tensor starting
    ``base_off`` bytes past a 16-byte boundary."""
    n, h, w, kk = raw.shape
    p = (k - 1) // 2
    raw_flat = raw.reshape(-1)
    base_addr = 4096 + base_off
    wxv, wyv = wx.reshape(kk), wy.reshape(kk)
    out = torch.full((n, h, w, 2), float("nan"))
    ntx, nty = -(-w // TILE_COLS), -(-h // TILE_ROWS)
    for t in range(n * nty * ntx):  # any block order gives the same tiles
        tx, rest = t % ntx, t // ntx
        y0, b, x0 = (rest % nty) * TILE_ROWS, rest // nty, tx * TILE_COLS
        ncols = min(TILE_COLS, w - x0)
        # flow halo, zero outside the image
        halo = torch.zeros(TILE_ROWS + 2 * p, TILE_COLS + 2 * p, 2)
        for hr in range(TILE_ROWS + 2 * p):
            for hc in range(TILE_COLS + 2 * p):
                yy, xx = y0 - p + hr, x0 - p + hc
                if 0 <= yy < h and 0 <= xx < w:
                    halo[hr, hc] = flow[b, yy, xx]
        for r in range(TILE_ROWS):
            y = y0 + r
            if y >= h:
                continue
            elem0 = ((b * h + y) * w + x0) * kk
            region, shift, row_bytes = _stage_row(raw_flat, elem0, ncols, kk, sz, base_addr)
            for c in range(ncols):
                off = shift + c * kk * sz
                if sz == 2:
                    idx = []
                    for j in range(kk):
                        hw, top = _bf16_tap_index(off, j, kk)
                        assert top <= row_bytes
                        idx.append(hw)
                else:
                    idx = [off // sz + j for j in range(kk)]
                    assert (off + kk * sz) <= row_bytes
                taps = region[idx]
                mm = taps.abs().min() ** 2
                e = torch.exp(mm - taps * taps)
                fl = torch.stack([halo[r + j // k, c + j % k] for j in range(kk)])
                den = e.sum()
                ax = (e * (wxv * fl[:, 0])).sum()
                ay = (e * (wyv * fl[:, 1])).sum()
                out[b, y, x0 + c, 0] = (ax + bx.reshape(())) / den
                out[b, y, x0 + c, 1] = (ay + by.reshape(())) / den
    return out


@pytest.mark.parametrize(
    "k,shape,sz,base_off",
    [
        (7, (1, 13, 41), 2, 0),   # ragged right and bottom tiles
        (7, (1, 9, 33), 2, 2),    # base one bf16 element past 16 bytes
        (5, (2, 10, 40), 2, 6),
        (3, (2, 6, 20), 2, 0),    # level 6: 360-byte rows, unaligned spans
        (3, (1, 11, 35), 4, 4),   # float32, base one element past 16 bytes
        (5, (1, 9, 34), 4, 12),
    ],
)
def test_kernel_tiling_model_matches_plain(k, shape, sz, base_off):
    n, h, w = shape
    raw, flow, wx, bx, wy, by = map(_t, _inputs(300 + k + w, n, h, w, k))
    got = _kernel_model(raw, flow, wx, bx, wy, by, k, sz, base_off)
    want = T_reg.reg_dist_filter_plain(raw, flow, wx, bx, wy, by, k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("kk", [9, 25, 49])
@pytest.mark.parametrize("par", [0, 1])
def test_bf16_tap_words_funnel_shift(kk, par):
    """``Taps<bf16>``'s bit arithmetic: little-endian halfwords packed into
    32-bit words, ``__funnelshift_r(w[i], w[i+1], 16 * par)``, then tap j as
    ``w << 16`` (even j) or ``w & 0xffff0000`` (odd j) read as float32."""
    rng = np.random.RandomState(kk + par)
    vals = torch.from_numpy(rng.randn(kk).astype(np.float32)).bfloat16()
    bits = vals.view(torch.int16).numpy().astype(np.uint16)
    nw = (kk + 1) // 2
    halves = np.zeros(2 * nw + 2, np.uint16)
    halves[par : par + kk] = bits
    halves[par + kk :] = 0xFFFF  # the neighbour's taps: never read as a tap
    if par:
        halves[0] = 0xFFFF
    words = halves[0::2].astype(np.uint64) | (halves[1::2].astype(np.uint64) << 16)
    words = words[:nw]
    shift = 16 * par
    aligned = []
    for i in range(nw):
        hi = int(words[i + 1]) if i + 1 < nw else 0
        aligned.append(((hi << 32 | int(words[i])) >> shift) & 0xFFFFFFFF)
    got = []
    for j in range(kk):
        u = aligned[j // 2]
        u = (u & 0xFFFF0000) if j & 1 else ((u << 16) & 0xFFFFFFFF)
        got.append(np.array([u], np.uint32).view(np.float32)[0])
    np.testing.assert_array_equal(np.array(got), vals.float().numpy())


def test_reg_dist_filter_cuda_refuses_bad_arguments():
    """Refused before anything is launched: k outside {3, 5, 7}, raw
    without k² taps, a mismatched flow, memory that is not NHWC-contiguous,
    and (here) a CPU tensor."""
    z = torch.zeros
    w9 = (z(9), z(1), z(9), z(1))
    with pytest.raises(ValueError, match="k must be 3, 5 or 7"):
        T_reg.reg_dist_filter_cuda(z(1, 4, 4, 16), z(1, 4, 4, 2), z(16), z(1), z(16), z(1), 4)
    with pytest.raises(ValueError, match="k² taps"):
        T_reg.reg_dist_filter_cuda(z(1, 4, 4, 8), z(1, 4, 4, 2), *w9, 3)
    with pytest.raises(ValueError, match="does not match"):
        T_reg.reg_dist_filter_cuda(z(1, 4, 4, 9), z(1, 4, 5, 2), *w9, 3)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        T_reg.reg_dist_filter_cuda(z(1, 9, 4, 4).permute(0, 2, 3, 1), z(1, 4, 4, 2), *w9, 3)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        T_reg.reg_dist_filter_cuda(z(1, 4, 4, 9), z(1, 2, 4, 4).permute(0, 2, 3, 1), *w9, 3)
    with pytest.raises(ValueError, match="biases 1"):
        T_reg.reg_dist_filter_cuda(z(1, 4, 4, 9), z(1, 4, 4, 2), z(8), z(1), z(9), z(1), 3)
    with pytest.raises(ValueError, match="CUDA"):
        T_reg.reg_dist_filter_cuda(z(1, 4, 4, 9), z(1, 4, 4, 2), *w9, 3)
    assert T_reg.reg_dist_filter_cuda.launches == 0
