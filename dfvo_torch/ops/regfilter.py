"""LiteFlowNet Regularization flow filtering.

Counterpart of ``dfvo_tpu/ops/regfilter.py``: a k x k local filter of the
flow with per-pixel data-dependent weights ``dist`` times a learned
per-offset weight,

    out_x = (bx + Σ_j dist_j·wx_j·flow_x(p+off_j)) / Σ_j dist_j

and the same for y, with flow zero-padded and taps ky-major.

* ``reg_scale_filter_plain``: the tap-major sum in PyTorch (counterpart of
  ``_unfold_mul_xla``); the CPU path and the oracle of the CUDA kernel.
* ``reg_scale_filter_cuda``: the kernel ``csrc/regfilter.cu``.
* ``reg_scale_filter``: plain on the CPU, the kernel on a CUDA device.
"""

import torch
import torch.nn.functional as F

from . import cuda_lib


def reg_scale_filter_plain(dist, flow, wx, bx, wy, by, k):
    """Tap-major weighted unfold, accumulated in float32.

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
    fp = F.pad(flow.float(), (0, 0, p, p, p, p))
    dist_t = dist.permute(0, 3, 1, 2).float()  # [N,k²,H,W]
    shx = torch.stack(
        [fp[:, j // k : j // k + h, j % k : j % k + w, 0] for j in range(kk)],
        dim=1,
    )
    shy = torch.stack(
        [fp[:, j // k : j // k + h, j % k : j % k + w, 1] for j in range(kk)],
        dim=1,
    )
    wxv = wx.reshape(1, kk, 1, 1).float()
    wyv = wy.reshape(1, kk, 1, 1).float()
    accx = bx.reshape(()).float() + torch.sum(dist_t * wxv * shx, dim=1)
    accy = by.reshape(()).float() + torch.sum(dist_t * wyv * shy, dim=1)
    inv = 1.0 / torch.sum(dist_t, dim=1)
    return torch.stack([accx * inv, accy * inv], dim=-1).to(flow.dtype)


def reg_scale_filter_cuda(dist, flow, wx, bx, wy, by, k):
    """Launch ``csrc/regfilter.cu``; same semantics as the plain version.

    Takes CUDA ``dist`` [N,H,W,k²] and ``flow`` [N,H,W,2] of one dtype
    (float32 or bfloat16) and k in {3, 5, 7}; raises for anything else.
    """
    cuda_lib.require_cuda("reg_scale_filter", dist, flow, wx, bx, wy, by)
    n, h, w, kk = dist.shape
    if k not in (3, 5, 7) or kk != k * k:
        raise ValueError(f"reg_scale_filter: k must be 3, 5 or 7 with k² taps, "
                         f"got k={k}, dist {tuple(dist.shape)}")
    if tuple(flow.shape) != (n, h, w, 2) or flow.dtype != dist.dtype:
        raise ValueError(
            f"reg_scale_filter: flow {tuple(flow.shape)} {flow.dtype} does not "
            f"match dist {tuple(dist.shape)} {dist.dtype}"
        )
    if wx.numel() != kk or wy.numel() != kk or bx.numel() != 1 or by.numel() != 1:
        raise ValueError("reg_scale_filter: weights must hold k² values, biases 1")
    dist = dist.contiguous()
    flow = flow.contiguous()
    wts = torch.cat(
        [wx.reshape(kk), wy.reshape(kk), bx.reshape(1), by.reshape(1)]
    ).float().contiguous()
    out = torch.empty_like(flow)
    if out.numel() == 0:
        return out
    rc = cuda_lib.load().dfvo_regfilter(
        dist.data_ptr(), flow.data_ptr(), wts.data_ptr(), out.data_ptr(),
        n, h, w, k, cuda_lib.dtype_code(dist.dtype), cuda_lib.stream_of(dist),
    )
    cuda_lib.check(rc, "reg_scale_filter")
    reg_scale_filter_cuda.launches += 1
    return out


reg_scale_filter_cuda.launches = 0


def reg_scale_filter(dist, flow, wx, bx, wy, by, k):
    """Confidence-weighted k x k flow filtering: plain on the CPU, the CUDA
    kernel on a CUDA device."""
    if dist.device.type == "cpu":
        return reg_scale_filter_plain(dist, flow, wx, bx, wy, by, k)
    return reg_scale_filter_cuda(dist, flow, wx, bx, wy, by, k)
