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
* The backward kernel's decomposition (``csrc/regfilter_bwd.cu``), written
  in plain torch with its tiles (16 x 16 at k = 7, 8 x 16 at k = 3 and 5),
  the raw taps staged with a
  (k-1)/2 halo and the flow with twice that, zero outside the image, m, D
  and c recomputed for the halo, the flow gradient gathered inside the
  tile, the parameter sums over strided segments of a tile's pixels added
  in order and the tiles' partials added in order: against the JAX
  package's ``_rf_bwd`` form and against the closed form on maps of
  several tiles.
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
# the backward kernel's tile (csrc/regfilter_bwd.cu): rows by k, columns
RB_ROWS, RB_COLS = {3: 8, 5: 8, 7: 16}, 16


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


def _rf_bwd_tiled(grad, raw, flow, wx, bx, wy, by, k):
    """The backward kernel's arithmetic in float32. Per tile (RB_ROWS[k] x
    RB_COLS pixels, one thread each): the raw
    taps of the tile and its P = (k-1)/2 halo and the flow of that region
    with its own P halo are staged, zero outside the image; every staged
    pixel gets m, D and c = g / D (c = 0 outside the image); each tile pixel
    q gathers dflow(q) = sum_j w_j c(p) e_j(p) over p = q - off_j from the
    staged values; the owner of entry j sums c e_j f_j over the tile rows
    s, s + SEGS, ... (SEGS = threads // (k² + 1)) and the segments are added in
    order into the tile's partial; draw from the tile's own staged values.
    The parameter gradients add the tiles' partials in tile order."""
    n, h, w, kk = raw.shape
    p = (k - 1) // 2
    rows = RB_ROWS[k]
    segs = rows * RB_COLS // (kk + 1)
    sr, sc = rows + 2 * p, RB_COLS + 2 * p
    wv = torch.stack([wx.reshape(kk), wy.reshape(kk)], dim=-1).float()  # [k², 2]
    bv = torch.stack([bx.reshape(()), by.reshape(())]).float()
    # zero-filled copies: staged raw (r, col) <-> (y0 - P + r, x0 - P + col),
    # staged flow (r, col) <-> (y0 - 2P + r, x0 - 2P + col)
    rawp = torch.zeros(n, h + rows + 2 * p, w + RB_COLS + 2 * p, kk)
    rawp[:, p : p + h, p : p + w] = raw.float()
    gp = torch.zeros(n, h + rows + 2 * p, w + RB_COLS + 2 * p, 2)
    gp[:, p : p + h, p : p + w] = grad.float()
    inside = torch.zeros(n, h + rows + 2 * p, w + RB_COLS + 2 * p, dtype=torch.bool)
    inside[:, p : p + h, p : p + w] = True
    flowp = torch.zeros(n, h + rows + 4 * p, w + RB_COLS + 4 * p, 2)
    flowp[:, 2 * p : 2 * p + h, 2 * p : 2 * p + w] = flow.float()
    draw, dflow = torch.zeros(n, h, w, kk), torch.zeros(n, h, w, 2)
    parts = []
    for b in range(n):
        for y0 in range(0, h, rows):
            for x0 in range(0, w, RB_COLS):
                r = rawp[b, y0 : y0 + sr, x0 : x0 + sc]  # [sr, sc, k²]
                fl = flowp[b, y0 : y0 + sr + 2 * p, x0 : x0 + sc + 2 * p]
                taps = torch.stack([fl[j // k : j // k + sr, j % k : j % k + sc]
                                    for j in range(kk)], dim=2)  # [sr, sc, k², 2]
                s = r * r
                m = s.amin(-1, keepdim=True)
                e = torch.exp(m - s)
                den = e.sum(-1, keepdim=True)
                inn = inside[b, y0 : y0 + sr, x0 : x0 + sc, None]
                c = torch.where(inn, gp[b, y0 : y0 + sr, x0 : x0 + sc] / den, 0.0)  # [sr, sc, 2]
                # dflow: staged p = (qy + 2P - j // k, qx + 2P - j % k)
                ce = e[..., None] * c[:, :, None]  # [sr, sc, k², 2]
                df = torch.zeros(rows, RB_COLS, 2)
                for j in range(kk):
                    pr, pc = 2 * p - j // k, 2 * p - j % k
                    df += wv[j] * ce[pr : pr + rows, pc : pc + RB_COLS, j]
                th, tw = min(rows, h - y0), min(RB_COLS, w - x0)
                dflow[b, y0 : y0 + th, x0 : x0 + tw] = df[:th, :tw]
                # the tile's own pixels
                tile = (slice(p, p + rows), slice(p, p + RB_COLS))
                et, ct, rt, st, mt = e[tile], c[tile], r[tile], s[tile], m[tile]
                ft = taps[tile]  # [16, 32, k², 2]
                # the parameter partial: owner j over tile rows s0, s0 + SEGS, ...
                contrib = torch.cat([(ct[:, :, None] * et[..., None] * ft).reshape(rows, RB_COLS,
                                                                                 kk * 2),
                                     ct], dim=2)  # [rows, cols, (k² + 1) 2]
                seg = [contrib[s0::segs].sum((0, 1)) for s0 in range(segs)]
                part = seg[0]
                for v in seg[1:]:
                    part = part + v
                parts.append(part)
                # draw
                out = (bv + (et[..., None] * wv * ft).sum(2)) / den[tile]
                ge = ((wv * ft - out[:, :, None]) * ct[:, :, None]).sum(-1)
                tie = st == mt
                tb = (ct * bv).sum(-1, keepdim=True) / tie.sum(-1, keepdim=True)
                dr = -2.0 * rt * (et * ge + tie * tb)
                draw[b, y0 : y0 + th, x0 : x0 + tw] = dr[:th, :tw]
    total = parts[0]
    for v in parts[1:]:
        total = total + v
    dw = total[: 2 * kk].reshape(kk, 2)
    return (draw, dflow, dw[:, 0].reshape(wx.shape), total[2 * kk].reshape(bx.shape),
            dw[:, 1].reshape(wy.shape), total[2 * kk + 1].reshape(by.shape))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_backward_kernel_tiles_match_rf_bwd(k):
    """At the shapes of test_reg_dist_filter_backward_plain_matches_rf_bwd (a
    map smaller than one tile: every pixel's neighbours come from the halo
    arithmetic at the image border), with its ties and underflowing taps."""
    rng = np.random.RandomState(80 + k)
    inputs = _inputs(rng, 2, 7, 9, k, np.float32)
    cot = rng.randn(2, 7, 9, 2).astype(np.float32)
    want = _jax_grads(inputs, k, cot)
    got = _rf_bwd_tiled(_t(cot), *map(_t, inputs), k)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).reshape(g.shape)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=RTOL32 * scale,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("k,n,h,w", [(3, 1, 37, 70), (5, 2, 20, 40), (7, 1, 33, 35)])
def test_backward_kernel_tiles_match_the_closed_form(k, n, h, w):
    """Maps of several tiles with ragged edges: the halos cross tile seams
    (a pixel's c and m recomputed in the neighbouring tile) and the
    parameter partials of several tiles are added in order."""
    rng = np.random.RandomState(90 + k)
    inputs = _inputs(rng, n, h, w, k, np.float32)
    cot = rng.randn(n, h, w, 2).astype(np.float32)
    got = _rf_bwd_tiled(_t(cot), *map(_t, inputs), k)
    want = T_reg.reg_dist_filter_backward_plain(_t(cot), *map(_t, inputs), k)
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape
        scale = max(1.0, float(r.abs().max()))
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=RTOL32 * scale,
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
