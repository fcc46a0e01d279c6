"""CUDA cost-volume kernel wrapper (counterpart of
``dfvo_tpu/ops/pallas_corr.py``; the kernels are in ``csrc/correlation.cu``).

Stride reduction, as on the TPU: every displacement is a multiple of the
stride and the zero padding is D·s, so

    corr(f1, f2, D, s) == corr(f1[::s, ::s], f2[::s, ::s], D, 1)

and the kernels only implement stride 1; this wrapper passes the subsampled
views to them through their strides, without a copy.

Two variants, chosen by :func:`correlation_variant` from dtype and layout:
``tensor_core`` (bf16, C a multiple of 16 up to 256, 16-byte aligned
pixels: the main path) and ``reg_tile`` (float32, and bf16 at C > 256,
C not a multiple of 16 or unaligned pixels: register-tiled on the CUDA
cores, a small map split over the channels by a thread block cluster).

:func:`correlation_backward_cuda` launches the backward kernel
(``csrc/correlation_bwd.cu``): both input gradients in one launch, by the
same stride reduction (the gradients of the subsampled views, written
through their strides into zero-filled full-size gradients).
"""

import collections

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
    """'tensor_core' or 'reg_tile' for two stride-1 NHWC maps."""
    c = f1.shape[3]
    aligned = all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in pixel_strides(t))
        for t in (f1, f2)
    )
    if (f1.dtype == torch.bfloat16 and c % 16 == 0 and c <= TC_MAX_CHANNELS
            and f1.shape[0] <= 65535 and aligned):
        return "tensor_core"
    return "reg_tile"


def _check_args(name, f1, f2, max_disp, stride):
    if f1.shape != f2.shape or f1.dim() != 4 or f1.dtype != f2.dtype:
        raise ValueError(
            f"{name}: f1 {tuple(f1.shape)} {f1.dtype} and f2 "
            f"{tuple(f2.shape)} {f2.dtype} must be equal-shape NHWC"
        )
    if max_disp not in (3, 4):
        raise ValueError(f"{name}: max_disp must be 3 or 4, got {max_disp}")
    if stride < 1:
        raise ValueError(f"{name}: stride must be >= 1, got {stride}")
    if f1.shape[3] > MAX_CHANNELS:
        raise ValueError(f"{name}: at most {MAX_CHANNELS} channels, got {f1.shape[3]}")


def correlation_cuda(f1, f2, max_disp=3, stride=1):
    """Launch a CUDA cost-volume kernel; same semantics as
    :func:`dfvo_torch.ops.correlation.correlation_plain`.

    Takes [N,H,W,C] float32 or bfloat16 CUDA tensors of one dtype with
    contiguous channels (any N/H/W strides), D in {3, 4}, C <= 1536. Raises
    for anything else. Output has the input dtype.
    """
    cuda_lib.forbid_grad("correlation", f1, f2)
    cuda_lib.require_cuda("correlation", f1, f2)
    _check_args("correlation", f1, f2, max_disp, stride)
    if stride != 1:
        f1 = f1[:, ::stride, ::stride, :]
        f2 = f2[:, ::stride, ::stride, :]
    n, h, w, c = f1.shape
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
    correlation_cuda.batch_launches[n] += 1
    return out


correlation_cuda.launches = 0
correlation_cuda.variant_launches = {"tensor_core": 0, "reg_tile": 0}
# by window: D = 3 (LiteFlowNet, 49 channels) and D = 4 (HD3, 81 channels)
correlation_cuda.disp_launches = {3: 0, 4: 0}
# by batch size N
correlation_cuda.batch_launches = collections.Counter()


def correlation_backward_cuda(grad, f1, f2, max_disp=3, stride=1, needs=(True, True)):
    """Launch the cost volume's backward kernel (``csrc/correlation_bwd.cu``);
    same semantics as
    :func:`dfvo_torch.ops.correlation.correlation_backward_plain`.

    Takes the cotangent ``grad`` [N, ceil(H/s), ceil(W/s), (2D+1)²] and the
    forward's inputs as :func:`correlation_cuda` takes them, on one CUDA
    device; raises for anything else. Returns (df1, df2) in the inputs'
    dtype, None where ``needs`` is False; one launch (stride s > 1 adds the
    zero fill of each full-size gradient)."""
    cuda_lib.require_cuda("correlation backward", grad, f1, f2)
    _check_args("correlation backward", f1, f2, max_disp, stride)
    kk = (2 * max_disp + 1) ** 2
    f1v, f2v = f1[:, ::stride, ::stride, :], f2[:, ::stride, ::stride, :]
    n, h, w, c = f1v.shape
    if tuple(grad.shape) != (n, h, w, kk):
        raise ValueError(f"correlation backward: cotangent {tuple(grad.shape)}, expected "
                         f"{(n, h, w, kk)}")
    s1, s2 = (pixel_strides(t, "correlation backward") for t in (f1v, f2v))
    grads = []
    for need, t in zip(needs, (f1, f2)):
        if not need:
            grads.append(None)
        elif stride == 1:
            grads.append(torch.empty(t.shape, dtype=t.dtype, device=t.device))
        else:
            grads.append(torch.zeros(t.shape, dtype=t.dtype, device=t.device))
    if not any(needs) or grad.numel() == 0:
        return tuple(grads)
    views = [None if t is None else t[:, ::stride, ::stride, :] for t in grads]
    d1, d2 = (pixel_strides(v) if v is not None else (0, 0, 0) for v in views)
    grad = grad.to(f1.dtype).contiguous()
    lib = cuda_lib.load()
    rc = lib.dfvo_correlation_bwd(
        f1v.data_ptr(), *s1, f2v.data_ptr(), *s2, grad.data_ptr(),
        None if views[0] is None else views[0].data_ptr(), *d1,
        None if views[1] is None else views[1].data_ptr(), *d2,
        n, h, w, c, max_disp, cuda_lib.dtype_code(f1.dtype), cuda_lib.stream_of(f1),
    )
    cuda_lib.check(rc, "correlation backward")
    correlation_backward_cuda.launches += 1
    correlation_backward_cuda.dtype_launches[f1.dtype] += 1
    correlation_backward_cuda.disp_launches[max_disp] += 1
    correlation_backward_cuda.batch_launches[n] += 1
    return tuple(grads)


correlation_backward_cuda.launches = 0
correlation_backward_cuda.dtype_launches = {torch.float32: 0, torch.bfloat16: 0}
correlation_backward_cuda.disp_launches = {3: 0, 4: 0}
correlation_backward_cuda.batch_launches = collections.Counter()
