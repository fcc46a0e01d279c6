"""LiteFlowNet Regularization: confidence normalisation and flow filtering.

Counterpart of ``dfvo_tpu/ops/regfilter.py``: a k x k local filter of the
flow with per-pixel data-dependent weights ``dist`` times a learned
per-offset weight,

    out_x = (bx + Σ_j dist_j·wx_j·flow_x(p+off_j)) / Σ_j dist_j

and the same for y, with flow zero-padded and taps ky-major. On the path,
``dist`` is the normalised ``moduleDist`` output,
``dist = exp(-(raw²) - max_j(-(raw_j²)))`` (``dfvo_tpu/models/liteflownet.py``
Regularization), and the two steps are one op:

* ``reg_scale_filter_plain``: the tap-major sum in PyTorch (counterpart of
  ``dfvo_tpu.ops.regfilter.reg_scale_filter``, its ``_unfold_mul_xla``).
* ``reg_dist_filter_plain``: the normalisation, then
  ``reg_scale_filter_plain``; the CPU path and the oracle of the kernel.
* ``reg_dist_filter_cuda``: the kernel ``csrc/regfilter.cu``, which
  normalises in registers as it filters.
* ``reg_dist_filter_backward_plain``: the gradients with respect to the raw
  logits, the flow and the four parameters in closed form (the counterpart
  of the JAX package's normalisation differentiated by autodiff, then
  ``_rf_bwd``); the CPU backward and the oracle of the backward kernel.
* ``reg_dist_filter_backward_cuda``: the kernels of ``csrc/regfilter_bwd.cu``,
  one pass over pixel tiles with their halo (every gradient, and a partial
  of the parameter gradients per tile), then a fixed-order sum of the
  partials.
* ``reg_dist_filter``: plain on the CPU, the kernel on a CUDA device;
  through :class:`RegDistFilterFunction` when a gradient is recorded, whose
  backward launches ``reg_dist_filter_backward_cuda`` on a CUDA tensor and
  runs ``reg_dist_filter_backward_plain`` on a CPU tensor.
"""

import collections

import torch
import torch.nn.functional as F

from . import cuda_lib
from .correlation import acc_dtype
from .kernel_grad import kernel_function, records_grad


def reg_scale_filter_plain(dist, flow, wx, bx, wy, by, k):
    """Tap-major weighted unfold, accumulated in float32 (float64 for a
    float64 flow).

    Args:
        dist: [N,H,W,k²] confidence (ky-major offsets).
        flow: [N,H,W,2] flow to filter.
        wx/bx, wy/by: per-tap weights (k² values in any shape) and biases
            (one value each) of the scale_x / scale_y 1x1 convs.
        k: filter size.

    Returns:
        [N,H,W,2] filtered flow in the flow's dtype.
    """
    n, h, w, kk = dist.shape
    p = (k - 1) // 2
    acc = acc_dtype(flow.dtype)
    fp = F.pad(flow.to(acc), (0, 0, p, p, p, p))
    dist_t = dist.permute(0, 3, 1, 2).to(acc)  # [N,k²,H,W]
    shx = torch.stack(
        [fp[:, j // k : j // k + h, j % k : j % k + w, 0] for j in range(kk)],
        dim=1,
    )
    shy = torch.stack(
        [fp[:, j // k : j // k + h, j % k : j % k + w, 1] for j in range(kk)],
        dim=1,
    )
    wxv = wx.reshape(1, kk, 1, 1).to(acc)
    wyv = wy.reshape(1, kk, 1, 1).to(acc)
    accx = bx.reshape(()).to(acc) + torch.sum(dist_t * wxv * shx, dim=1)
    accy = by.reshape(()).to(acc) + torch.sum(dist_t * wyv * shy, dim=1)
    inv = 1.0 / torch.sum(dist_t, dim=1)
    return torch.stack([accx * inv, accy * inv], dim=-1).to(flow.dtype)


def reg_dist_filter_plain(raw, flow, wx, bx, wy, by, k):
    """Normalise the raw ``moduleDist`` output [N,H,W,k²] to
    ``exp(-(raw²) - max(-(raw²)))`` in its dtype, then filter the flow with
    it (:func:`reg_scale_filter_plain`)."""
    dist = -(raw**2)
    dist = torch.exp(dist - torch.amax(dist, dim=-1, keepdim=True))
    return reg_scale_filter_plain(dist, flow, wx, bx, wy, by, k)


def reg_dist_filter_backward_plain(grad, raw, flow, wx, bx, wy, by, k, needs=(True,) * 6):
    """Gradients of ``reg_dist_filter_plain`` for the cotangent ``grad``
    [N,H,W,2], in closed form, computed in float32 (float64 for a float64
    flow). Per pixel p, with s_j = raw_j², m = min_j s_j, e_j = exp(m - s_j),
    D = Σ_j e_j, f_j = flow(p + off_j), out = (b + Σ_j e_j·w_j·f_j) / D and
    c = g / D (x and y each):

        ∂raw_j  = -2·raw_j·(e_j·Σ_xy c·(w_j·f_j - out)
                            + [s_j = m]·Σ_xy c·b / #{i: s_i = m})
        ∂flow(q) = Σ_j w_j·(c·e_j)(q - off_j)   over the q - off_j in the image
        ∂w_j    = Σ_p c·e_j·f_j,   ∂b = Σ_p c

    The second term of ∂raw is the cotangent of the max in the
    normalisation: minus the sum over j of e_j times the first bracket,
    which is Σ_xy c·b, split evenly over the tied minimal taps as autodiff
    of ``amax`` (and of ``jnp.max``) splits it.
    Returns (∂raw, ∂flow, ∂wx, ∂bx, ∂wy, ∂by), each in its input's shape and
    dtype, None where ``needs`` is False."""
    n, h, w, kk = raw.shape
    p = (k - 1) // 2
    acc = acc_dtype(flow.dtype)
    r = raw.to(acc)
    s = r * r
    m = torch.amin(s, dim=-1, keepdim=True)
    e = torch.exp(m - s)  # [N,H,W,k²]
    fp = F.pad(flow.to(acc), (0, 0, p, p, p, p))
    # the flow at each tap: [N,H,W,k²,2]
    sh = torch.stack([fp[:, j // k : j // k + h, j % k : j % k + w] for j in range(kk)], dim=3)
    wv = torch.stack([wx.reshape(kk), wy.reshape(kk)], dim=-1).to(acc)  # [k²,2]
    b = torch.stack([bx.reshape(()), by.reshape(())]).to(acc)  # [2]
    den = e.sum(dim=-1, keepdim=True)
    c = grad.to(acc) / den  # [N,H,W,2]
    ce = e[..., None] * c[:, :, :, None]  # [N,H,W,k²,2]
    draw = dflow = None
    if needs[0]:
        wf = wv * sh
        out = (b + (e[..., None] * wf).sum(dim=3)) / den
        ge = ((wf - out[:, :, :, None]) * c[:, :, :, None]).sum(dim=-1)
        tie = s == m
        bias = (c * b).sum(dim=-1, keepdim=True) / tie.sum(dim=-1, keepdim=True)
        draw = (-2.0 * r * (e * ge + tie * bias)).to(raw.dtype)
    if needs[1]:
        coef = ce * wv
        dfp = fp.new_zeros(fp.shape)
        for j in range(kk):
            dfp[:, j // k : j // k + h, j % k : j % k + w] += coef[:, :, :, j]
        dflow = dfp[:, p : p + h, p : p + w].to(flow.dtype)
    dw = (ce * sh).sum(dim=(0, 1, 2)) if needs[2] or needs[4] else None  # [k²,2]
    db = c.sum(dim=(0, 1, 2))
    params = []
    for i, t in enumerate((wx, bx, wy, by)):
        if not needs[2 + i]:
            params.append(None)
            continue
        g = dw[:, i // 2] if i % 2 == 0 else db[i // 2]
        params.append(g.reshape(t.shape).to(t.dtype))
    return (draw, dflow, *params)


def _check_args(name, raw, flow, wx, bx, wy, by, k):
    """Raise ValueError unless ``raw`` [N,H,W,k²] and ``flow`` [N,H,W,2] are
    of one dtype in NHWC-contiguous memory, k is 3, 5 or 7, and the weights
    hold k² values and the biases one, contiguous and of one dtype."""
    if raw.dim() != 4 or k not in (3, 5, 7) or raw.shape[3] != k * k:
        raise ValueError(f"{name}: k must be 3, 5 or 7 and raw [N,H,W,k²] must "
                         f"have k² taps, got k={k}, raw {tuple(raw.shape)}")
    n, h, w, kk = raw.shape
    if tuple(flow.shape) != (n, h, w, 2) or flow.dtype != raw.dtype:
        raise ValueError(
            f"{name}: flow {tuple(flow.shape)} {flow.dtype} does not "
            f"match raw {tuple(raw.shape)} {raw.dtype}"
        )
    for label, t in (("raw", raw), ("flow", flow)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be NHWC-contiguous memory, "
                             f"got strides {t.stride()}")
    params = (wx, bx, wy, by)
    if wx.numel() != kk or wy.numel() != kk or bx.numel() != 1 or by.numel() != 1:
        raise ValueError(f"{name}: weights must hold k² values, biases 1")
    if len({t.dtype for t in params}) != 1 or not all(t.is_contiguous() for t in params):
        raise ValueError(f"{name}: weights and biases must be contiguous and "
                         "of one dtype")


def reg_dist_filter_cuda(raw, flow, wx, bx, wy, by, k):
    """Launch ``csrc/regfilter.cu``; same semantics as
    :func:`reg_dist_filter_plain`.

    Takes CUDA ``raw`` [N,H,W,k²] and ``flow`` [N,H,W,2] of one dtype
    (float32 or bfloat16) in NHWC-contiguous memory, k in {3, 5, 7}, and the
    four parameter tensors as they are (contiguous, one dtype, float32 or
    bfloat16, read in place). Raises ValueError for anything else, before
    the device is looked at, and RuntimeError when autograd would need a
    gradient of the output.
    """
    cuda_lib.forbid_grad("reg_dist_filter", raw, flow, wx, bx, wy, by)
    _check_args("reg_dist_filter", raw, flow, wx, bx, wy, by, k)
    n, h, w = raw.shape[:3]
    cuda_lib.require_cuda("reg_dist_filter", raw, flow, wx, bx, wy, by)
    out = torch.empty((n, h, w, 2), dtype=flow.dtype, device=flow.device)
    if out.numel() == 0:
        return out
    rc = cuda_lib.load().dfvo_reg_dist_filter(
        raw.data_ptr(), flow.data_ptr(), wx.data_ptr(), bx.data_ptr(),
        wy.data_ptr(), by.data_ptr(), cuda_lib.dtype_code(wx.dtype), out.data_ptr(),
        n, h, w, k, cuda_lib.dtype_code(raw.dtype), cuda_lib.stream_of(raw),
    )
    cuda_lib.check(rc, "reg_dist_filter")
    reg_dist_filter_cuda.launches += 1
    reg_dist_filter_cuda.variant_launches["async_tile"] += 1
    reg_dist_filter_cuda.batch_launches[n] += 1
    return out


reg_dist_filter_cuda.launches = 0
reg_dist_filter_cuda.variant_launches = {"async_tile": 0}
# by batch size N
reg_dist_filter_cuda.batch_launches = collections.Counter()


def reg_dist_filter_backward_cuda(grad, raw, flow, wx, bx, wy, by, k, needs=(True,) * 6):
    """Launch the filter's backward kernels (``csrc/regfilter_bwd.cu``); same
    semantics as :func:`reg_dist_filter_backward_plain`.

    Takes the cotangent ``grad`` [N,H,W,2] with any strides (autograd may
    hand a view; the kernels read it through its strides, with no copy) and
    the forward's inputs as :func:`reg_dist_filter_cuda` takes them, on one
    CUDA device; raises for anything else. Each gradient is written dense
    in its input's shape and dtype. Two launches: the pass over the pixel
    tiles, then one block that sums the parameter gradients' per-tile
    partials in a fixed order (left out when no parameter gradient is
    needed)."""
    tensors = (grad, raw, flow, wx, bx, wy, by)
    cuda_lib.require_cuda("reg_dist_filter backward", *tensors)
    _check_args("reg_dist_filter backward", raw, flow, wx, bx, wy, by, k)
    if tuple(grad.shape) != tuple(flow.shape):
        raise ValueError(f"reg_dist_filter backward: cotangent {tuple(grad.shape)}, expected "
                         f"{tuple(flow.shape)}")
    n, h, w, kk = raw.shape
    grads = [torch.empty_like(t) if need else None
             for t, need in zip((raw, flow, wx, bx, wy, by), needs)]
    need_part = any(needs[2:])
    if not any(needs):
        return tuple(grads)
    if raw.numel() == 0:
        return tuple(g if g is None or i < 2 else g.zero_() for i, g in enumerate(grads))
    grad = grad.to(flow.dtype)
    lib = cuda_lib.load()
    part = (torch.empty((lib.dfvo_reg_dist_filter_bwd_parts(n, h, w, k), 2 * kk + 2),
                        dtype=torch.float32, device=raw.device) if need_part else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.dfvo_reg_dist_filter_bwd(
        raw.data_ptr(), flow.data_ptr(), wx.data_ptr(), bx.data_ptr(), wy.data_ptr(),
        by.data_ptr(), cuda_lib.dtype_code(wx.dtype), grad.data_ptr(), *grad.stride(),
        *map(ptr, grads[:2]), ptr(part), *map(ptr, grads[2:]), n, h, w, k,
        cuda_lib.dtype_code(raw.dtype), cuda_lib.stream_of(raw),
    )
    cuda_lib.check(rc, "reg_dist_filter backward")
    reg_dist_filter_backward_cuda.launches += 1
    reg_dist_filter_backward_cuda.dtype_launches[raw.dtype] += 1
    reg_dist_filter_backward_cuda.batch_launches[n] += 1
    return tuple(grads)


reg_dist_filter_backward_cuda.launches = 0
reg_dist_filter_backward_cuda.dtype_launches = {torch.float32: 0, torch.bfloat16: 0}
# by batch size N
reg_dist_filter_backward_cuda.batch_launches = collections.Counter()


RegDistFilterFunction = kernel_function(
    "RegDistFilterFunction", reg_dist_filter_cuda, reg_dist_filter_plain, 6,
    reg_dist_filter_backward_cuda, reg_dist_filter_backward_plain)


def reg_dist_filter(raw, flow, wx, bx, wy, by, k):
    """Normalise the raw confidence and filter the flow with it: plain on
    the CPU, the CUDA kernel on a CUDA device; through
    :class:`RegDistFilterFunction` when a gradient is recorded."""
    if records_grad(raw, flow, wx, bx, wy, by):
        return RegDistFilterFunction.apply(raw, flow, wx, bx, wy, by, k)
    if raw.device.type == "cpu":
        return reg_dist_filter_plain(raw, flow, wx, bx, wy, by, k)
    return reg_dist_filter_cuda(raw, flow, wx, bx, wy, by, k)
