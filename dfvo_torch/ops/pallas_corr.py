"""CUDA cost-volume kernel wrapper (counterpart of
``dfvo_tpu/ops/pallas_corr.py``; the kernel is ``csrc/correlation.cu``).

Stride reduction, as on the TPU: every displacement is a multiple of the
stride and the zero padding is D·s, so

    corr(f1, f2, D, s) == corr(f1[::s, ::s], f2[::s, ::s], D, 1)

and the kernel only implements stride 1; this wrapper subsamples.
"""

import torch

from . import cuda_lib


def correlation_cuda(f1, f2, max_disp=3, stride=1):
    """Launch the stride-1 CUDA kernel; same semantics as
    :func:`dfvo_torch.ops.correlation.correlation_plain`.

    Takes [N,H,W,C] float32 or bfloat16 CUDA tensors of one dtype, D in
    {3, 4}, C <= 1536. Raises for anything else. Output has the input dtype.
    """
    cuda_lib.require_cuda("correlation", f1, f2)
    if f1.shape != f2.shape or f1.dim() != 4 or f1.dtype != f2.dtype:
        raise ValueError(
            f"correlation: f1 {tuple(f1.shape)} {f1.dtype} and f2 "
            f"{tuple(f2.shape)} {f2.dtype} must be equal-shape NHWC"
        )
    if max_disp not in (3, 4):
        raise ValueError(f"correlation: max_disp must be 3 or 4, got {max_disp}")
    if stride < 1:
        raise ValueError(f"correlation: stride must be >= 1, got {stride}")
    if stride != 1:
        f1 = f1[:, ::stride, ::stride, :]
        f2 = f2[:, ::stride, ::stride, :]
    f1 = f1.contiguous()
    f2 = f2.contiguous()
    n, h, w, c = f1.shape
    if c > 1536:
        raise ValueError(f"correlation: at most 1536 channels, got {c}")
    kk = (2 * max_disp + 1) ** 2
    out = torch.empty((n, h, w, kk), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    rc = cuda_lib.load().dfvo_correlation(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w, c, max_disp,
        cuda_lib.dtype_code(f1.dtype), cuda_lib.stream_of(f1),
    )
    cuda_lib.check(rc, "correlation")
    correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0
