"""CUDA cost-volume kernel wrapper (counterpart of
``dfvo_tpu/ops/pallas_corr.py``; the kernels are in ``csrc/correlation.cu``).

Stride reduction, as on the TPU: every displacement is a multiple of the
stride and the zero padding is D·s, so

    corr(f1, f2, D, s) == corr(f1[::s, ::s], f2[::s, ::s], D, 1)

and the kernels only implement stride 1; this wrapper passes the subsampled
views to them through their strides, without a copy.

Two variants, chosen by :func:`correlation_variant` from dtype and layout:
``tensor_core`` (bf16, C a multiple of 16 up to 256, 16-byte aligned
pixels: the main path) and ``cuda_core`` (float32 and everything else).
"""

import torch

from . import cuda_lib

TC_MAX_CHANNELS = 256
MAX_CHANNELS = 1536


def pixel_strides(t, name="correlation"):
    """(N, H, W) element strides of an NHWC tensor whose channels are
    contiguous; the kernels address pixel (n, y, x) at
    ``data_ptr + (n*sN + y*sH + x*sW) * itemsize``. Raises for a channel
    stride other than 1."""
    if t.dim() != 4 or (t.stride(3) != 1 and t.shape[3] > 1):
        raise ValueError(f"{name}: channels must be contiguous (channel stride 1), "
                         f"got strides {t.stride()}")
    return tuple(t.stride()[:3])


def correlation_variant(f1, f2):
    """'tensor_core' or 'cuda_core' for two stride-1 NHWC maps."""
    c = f1.shape[3]
    aligned = all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in pixel_strides(t))
        for t in (f1, f2)
    )
    if (f1.dtype == torch.bfloat16 and c % 16 == 0 and c <= TC_MAX_CHANNELS
            and f1.shape[0] <= 65535 and aligned):
        return "tensor_core"
    return "cuda_core"


def correlation_cuda(f1, f2, max_disp=3, stride=1):
    """Launch a CUDA cost-volume kernel; same semantics as
    :func:`dfvo_torch.ops.correlation.correlation_plain`.

    Takes [N,H,W,C] float32 or bfloat16 CUDA tensors of one dtype with
    contiguous channels (any N/H/W strides), D in {3, 4}, C <= 1536. Raises
    for anything else. Output has the input dtype.
    """
    cuda_lib.forbid_grad("correlation", f1, f2)
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
    n, h, w, c = f1.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"correlation: at most {MAX_CHANNELS} channels, got {c}")
    s1, s2 = pixel_strides(f1), pixel_strides(f2)
    kk = (2 * max_disp + 1) ** 2
    out = torch.empty((n, h, w, kk), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    variant = correlation_variant(f1, f2)
    if variant == "tensor_core":
        rc = lib.dfvo_correlation_tc(
            f1.data_ptr(), *s1, f2.data_ptr(), *s2, out.data_ptr(),
            n, h, w, c, max_disp, cuda_lib.stream_of(f1),
        )
    else:
        rc = lib.dfvo_correlation(
            f1.data_ptr(), *s1, f2.data_ptr(), *s2, out.data_ptr(),
            n, h, w, c, max_disp, cuda_lib.dtype_code(f1.dtype),
            cuda_lib.stream_of(f1),
        )
    cuda_lib.check(rc, f"correlation ({variant})")
    correlation_cuda.launches += 1
    correlation_cuda.variant_launches[variant] += 1
    correlation_cuda.disp_launches[max_disp] += 1
    return out


correlation_cuda.launches = 0
correlation_cuda.variant_launches = {"tensor_core": 0, "cuda_core": 0}
# by window: D = 3 (LiteFlowNet, 49 channels) and D = 4 (HD3, 81 channels)
correlation_cuda.disp_launches = {3: 0, 4: 0}
