"""Tiny-output-channel "head" convolutions (Cout <= 4, stride 1).

Counterpart of ``dfvo_tpu/ops/headconv.py``. Serves LiteFlowNet's
flow-delta heads (k = 7/5/3, Cout = 2, 'same' zero padding) and
Monodepth2's disparity heads (3x3, Cout = 1, reflect-padded by the caller).

* ``head_conv_plain``: ``F.conv2d`` in float32; the CPU path and the oracle
  of the CUDA kernel.
* ``head_conv_cuda``: the kernels of ``csrc/headconv.cu``, in two variants
  chosen by :func:`head_conv_variant` from dtype and shape:
  ``tensor_core`` (bf16, Cin in {16, 32, 64, 128}, Cout <= 2,
  k in {3, 5, 7}, 16-byte aligned pixels: all 14 heads of the main path)
  and ``cuda_core`` (float32, Cin = 3, unaligned bases, Cout 3-4, k = 1).
* ``head_conv``: plain on the CPU, the kernel on a CUDA device; through
  :class:`HeadConvFunction` when a gradient is recorded, whose backward is
  the VJP of ``head_conv_plain`` with respect to x, the kernel and the
  bias (the JAX package's ``_hc_bwd``).
"""

import collections

import torch
import torch.nn.functional as F

from . import cuda_lib
from .correlation import acc_dtype
from .kernel_grad import kernel_function, records_grad


def head_conv_plain(x, kernel, bias=None, prepadded=False):
    """[N,H,W,Cin] x [k,k,Cin,Cout] -> [N,H',W',Cout] in x's dtype.

    'Same' zero padding, or ``prepadded=True`` for an input already padded
    by (k-1)//2 per side (a VALID conv). Computed in float32 (float64 for a
    float64 input)."""
    k = kernel.shape[0]
    pad = 0 if prepadded else (k - 1) // 2
    acc = acc_dtype(x.dtype)
    y = F.conv2d(
        x.permute(0, 3, 1, 2).to(acc),
        kernel.permute(3, 2, 0, 1).to(acc),
        None if bias is None else bias.to(acc),
        padding=pad,
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)


def head_conv_variant(x, kernel):
    """'tensor_core' or 'cuda_core' for an NHWC input and [k,k,Cin,Cout]
    weights."""
    k, cin, cout = kernel.shape[0], kernel.shape[2], kernel.shape[3]
    aligned = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in x.stride()[:3]))
    if (x.dtype == torch.bfloat16 and k in (3, 5, 7) and cin in (16, 32, 64, 128)
            and cout <= 2 and x.shape[0] <= 65535 and aligned):
        return "tensor_core"
    return "cuda_core"


def head_conv_cuda(x, kernel, bias=None, prepadded=False):
    """Launch a kernel of ``csrc/headconv.cu``; same semantics as the plain
    version.

    Takes a CUDA float32 or bfloat16 NHWC input, an odd k <= 7, Cout <= 4
    and at most 48 KB of float32 weights; raises for anything else. The
    tensor-core variant reads ``kernel`` (any strides, e.g. the permuted
    OIHW parameter) and ``bias`` as they are when their dtype is x's."""
    tensors = (x, kernel) if bias is None else (x, kernel, bias)
    cuda_lib.forbid_grad("head_conv", *tensors)
    cuda_lib.require_cuda("head_conv", *tensors)
    if x.dim() != 4 or kernel.dim() != 4:
        raise ValueError("head_conv: x must be NHWC and kernel [k,k,Cin,Cout]")
    n, in_h, in_w, cin = x.shape
    k, k2, kcin, cout = kernel.shape
    if k != k2 or k % 2 == 0 or k > 7 or kcin != cin or not 1 <= cout <= 4:
        raise ValueError(
            f"head_conv: kernel {tuple(kernel.shape)} must be [k,k,{cin},Cout] "
            "with odd k <= 7 and Cout <= 4"
        )
    if 4 * k * k * cin * cout > 48 * 1024:
        raise ValueError("head_conv: weights exceed 48 KB of shared memory")
    if bias is not None and bias.numel() != cout:
        raise ValueError(f"head_conv: bias must hold {cout} values")
    if prepadded:
        pad, out_h, out_w = 0, in_h - (k - 1), in_w - (k - 1)
    else:
        pad, out_h, out_w = (k - 1) // 2, in_h, in_w
    out = torch.empty((n, out_h, out_w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    variant = head_conv_variant(x, kernel)
    if variant == "tensor_core":
        # weights in x's dtype, as dfvo_tpu casts them; on the main path they
        # already are, and nothing is launched here
        kernel = kernel.to(x.dtype)
        b = None if bias is None else bias.reshape(cout).to(x.dtype).contiguous()
        rc = lib.dfvo_headconv_tc(
            x.data_ptr(), *x.stride()[:3], kernel.data_ptr(), *kernel.stride(),
            None if b is None else b.data_ptr(), out.data_ptr(), n, in_h, in_w,
            cin, out_h, out_w, k, cout, pad, cuda_lib.stream_of(x),
        )
    else:
        x = x.contiguous()
        wts = kernel.float().contiguous()
        b = None if bias is None else bias.float().contiguous()
        rc = lib.dfvo_headconv(
            x.data_ptr(), wts.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), n, in_h, in_w, cin, out_h, out_w, k, cout, pad,
            cuda_lib.dtype_code(x.dtype), cuda_lib.stream_of(x),
        )
    cuda_lib.check(rc, f"head_conv ({variant})")
    head_conv_cuda.launches += 1
    head_conv_cuda.variant_launches[variant] += 1
    head_conv_cuda.batch_launches[n] += 1
    return out


head_conv_cuda.launches = 0
head_conv_cuda.variant_launches = {"tensor_core": 0, "cuda_core": 0}
# by batch size N
head_conv_cuda.batch_launches = collections.Counter()


HeadConvFunction = kernel_function("HeadConvFunction", head_conv_cuda, head_conv_plain, 3)


def head_conv(x, kernel, bias=None, prepadded=False):
    """Small-Cout conv, stride 1: plain on the CPU, the CUDA kernel on a
    CUDA device; through :class:`HeadConvFunction` when a gradient is
    recorded."""
    if records_grad(x, kernel, bias):
        return HeadConvFunction.apply(x, kernel, bias, prepadded)
    if x.device.type == "cpu":
        return head_conv_plain(x, kernel, bias, prepadded)
    return head_conv_cuda(x, kernel, bias, prepadded)
