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
* ``reg_dist_filter``: plain on the CPU, the kernel on a CUDA device;
  through :class:`RegDistFilterFunction` when a gradient is recorded, whose
  backward is the VJP of ``reg_dist_filter_plain`` with respect to the raw
  logits, the flow and the four parameters (the JAX package's
  normalisation differentiated by autodiff, then ``_rf_bwd``), on the
  card too: the filter has no backward kernel yet, unlike the cost volume
  and the head conv.
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
    if raw.dim() != 4 or k not in (3, 5, 7) or raw.shape[3] != k * k:
        raise ValueError(f"reg_dist_filter: k must be 3, 5 or 7 and raw [N,H,W,k²] must "
                         f"have k² taps, got k={k}, raw {tuple(raw.shape)}")
    n, h, w, kk = raw.shape
    if tuple(flow.shape) != (n, h, w, 2) or flow.dtype != raw.dtype:
        raise ValueError(
            f"reg_dist_filter: flow {tuple(flow.shape)} {flow.dtype} does not "
            f"match raw {tuple(raw.shape)} {raw.dtype}"
        )
    for name, t in (("raw", raw), ("flow", flow)):
        if not t.is_contiguous():
            raise ValueError(f"reg_dist_filter: {name} must be NHWC-contiguous memory, "
                             f"got strides {t.stride()}")
    params = (wx, bx, wy, by)
    if wx.numel() != kk or wy.numel() != kk or bx.numel() != 1 or by.numel() != 1:
        raise ValueError("reg_dist_filter: weights must hold k² values, biases 1")
    if len({t.dtype for t in params}) != 1 or not all(t.is_contiguous() for t in params):
        raise ValueError("reg_dist_filter: weights and biases must be contiguous and "
                         "of one dtype")
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


RegDistFilterFunction = kernel_function(
    "RegDistFilterFunction", reg_dist_filter_cuda, reg_dist_filter_plain, 6)


def reg_dist_filter(raw, flow, wx, bx, wy, by, k):
    """Normalise the raw confidence and filter the flow with it: plain on
    the CPU, the CUDA kernel on a CUDA device; through
    :class:`RegDistFilterFunction` when a gradient is recorded."""
    if records_grad(raw, flow, wx, bx, wy, by):
        return RegDistFilterFunction.apply(raw, flow, wx, bx, wy, by, k)
    if raw.device.type == "cpu":
        return reg_dist_filter_plain(raw, flow, wx, bx, wy, by, k)
    return reg_dist_filter_cuda(raw, flow, wx, bx, wy, by, k)
