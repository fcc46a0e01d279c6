"""Local cost-volume (correlation) op.

Counterpart of ``dfvo_tpu/ops/correlation.py``. Semantics:

    out[n, y, x, (dy+D)·(2D+1)+(dx+D)] =
        mean_c f1[n, y·s, x·s, c] · f2[n, y·s+dy·s, x·s+dx·s, c]

with f2 zero-padded, D = max_disp, s = stride, output size
ceil(H/s) x ceil(W/s), channel order dy-major.

* ``correlation_plain``: shift-multiply-reduce in PyTorch (the counterpart
  of ``correlation_xla``); the CPU path and the oracle of the CUDA kernel.
* ``correlation``: the plain version for a CPU tensor, the CUDA kernel
  (``pallas_corr.correlation_cuda``) for a CUDA tensor. When autograd
  records and an input requires grad, it goes through
  :class:`CorrelationFunction`, whose backward is the VJP of
  ``correlation_plain`` (the JAX package's ``_corr_bwd``).
"""

import torch
import torch.nn.functional as F

from .kernel_grad import kernel_function, records_grad
from .pallas_corr import correlation_cuda


def acc_dtype(dtype):
    """float32, or float64 for a float64 input."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def correlation_plain(f1, f2, max_disp=3, stride=1):
    """Cost volume via (2D+1)² shifted products, summed in float32 (float64
    for a float64 input).

    Args:
        f1, f2: [N x H x W x C] feature maps (NHWC).
        max_disp: D, displacement window radius.
        stride: output subsampling and displacement step.

    Returns:
        [N x ceil(H/s) x ceil(W/s) x (2D+1)²] volume in the input dtype.
    """
    n, h, w, c = f1.shape
    d = max_disp
    pad = d * stride
    acc = acc_dtype(f1.dtype)
    f1s = f1[:, ::stride, ::stride, :].to(acc)
    f2p = F.pad(f2.to(acc), (0, 0, pad, pad, pad, pad))
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            y0 = pad + dy * stride
            x0 = pad + dx * stride
            f2s = f2p[:, y0 : y0 + h : stride, x0 : x0 + w : stride, :]
            outs.append((f1s * f2s).mean(dim=-1))
    return torch.stack(outs, dim=-1).to(f1.dtype)


CorrelationFunction = kernel_function(
    "CorrelationFunction", correlation_cuda, correlation_plain, 2)


def correlation(f1, f2, max_disp=3, stride=1):
    """Plain version on the CPU, the CUDA kernel on a CUDA device; through
    :class:`CorrelationFunction` when a gradient is recorded."""
    if records_grad(f1, f2):
        return CorrelationFunction.apply(f1, f2, max_disp, stride)
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, max_disp=max_disp, stride=stride)
    return correlation_cuda(f1, f2, max_disp=max_disp, stride=stride)
