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
  and ``reg_tile`` (register-tiled on the CUDA cores: float32, which is
  every head of a finetuning update, and bf16 outside the tensor-core set:
  Cin = 3, unaligned bases, Cout 3-4, k = 1).
* ``head_conv_backward_plain``: the gradients with respect to x, the
  kernel and the bias in closed form, a loop over the k x k taps (the
  counterpart of the JAX package's ``_hc_bwd``, the VJP of the plain XLA
  conv); the CPU backward and the oracle of the backward kernel.
* ``head_conv_backward_cuda``: the kernels of ``csrc/headconv_bwd.cu``,
  all three gradients from one staging, then a second launch that sums the
  weight and bias gradients' per-block partials in a fixed order.
* ``head_conv``: plain on the CPU, the kernel on a CUDA device; through
  :class:`HeadConvFunction` when a gradient is recorded, whose backward
  launches ``head_conv_backward_cuda`` on a CUDA tensor and runs
  ``head_conv_backward_plain`` on a CPU tensor.
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


def head_conv_backward_plain(grad, x, kernel, bias=None, prepadded=False,
                            needs=(True, True, True)):
    """Gradients of ``head_conv_plain`` for the cotangent ``grad``
    [N,H',W',Cout], in closed form, summed in float32 (float64 for a float64
    input). With pad p (0 when ``prepadded``):

        dx[y, x, ci]     = Σ_{ky,kx,co} g[y+p-ky, x+p-kx, co] · w[ky, kx, ci, co]
        dw[ky, kx, ci, co] = Σ_{n,oy,ox} x[oy-p+ky, ox-p+kx, ci] · g[oy, ox, co]
        db[co]           = Σ_{n,oy,ox} g[oy, ox, co]

    with g zero outside the output and x zero outside the input. Returns
    (dx, dw, db) in the inputs' dtypes, None where ``needs`` is False or
    the bias is None."""
    k = kernel.shape[0]
    pad = 0 if prepadded else (k - 1) // 2
    acc = acc_dtype(x.dtype)
    g = grad.to(acc)
    n, oh, ow, _ = g.shape
    w = kernel.to(acc)
    need_dx, need_dw, need_db = needs[0], needs[1], bias is not None and needs[2]
    xp = F.pad(x.to(acc), (0, 0, pad, pad, pad, pad)) if need_dw else None
    dxp = g.new_zeros((n, oh + k - 1, ow + k - 1, x.shape[3])) if need_dx else None
    dw = torch.zeros_like(w) if need_dw else None
    for ky in range(k):
        for kx in range(k):
            rows, cols = slice(ky, ky + oh), slice(kx, kx + ow)
            if need_dx:
                dxp[:, rows, cols] += g @ w[ky, kx].T
            if need_dw:
                dw[ky, kx] = torch.einsum("nhwi,nhwo->io", xp[:, rows, cols], g)
    dx = None
    if need_dx:
        dx = dxp[:, pad : pad + x.shape[1], pad : pad + x.shape[2]].to(x.dtype)
    db = g.sum(dim=(0, 1, 2)).to(bias.dtype) if need_db else None
    return dx, None if dw is None else dw.to(kernel.dtype), db


def head_conv_variant(x, kernel):
    """'tensor_core' or 'reg_tile' for an NHWC input and [k,k,Cin,Cout]
    weights."""
    k, cin, cout = kernel.shape[0], kernel.shape[2], kernel.shape[3]
    aligned = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in x.stride()[:3]))
    if (x.dtype == torch.bfloat16 and k in (3, 5, 7) and cin in (16, 32, 64, 128)
            and cout <= 2 and x.shape[0] <= 65535 and aligned):
        return "tensor_core"
    return "reg_tile"


def _check_args(name, x, kernel, bias, prepadded):
    """(pad, out_h, out_w) of an NHWC input and [k,k,Cin,Cout] weights the
    kernels take; raises for anything else."""
    if x.dim() != 4 or kernel.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC and kernel [k,k,Cin,Cout]")
    n, in_h, in_w, cin = x.shape
    k, k2, kcin, cout = kernel.shape
    if k != k2 or k % 2 == 0 or k > 7 or kcin != cin or not 1 <= cout <= 4:
        raise ValueError(
            f"{name}: kernel {tuple(kernel.shape)} must be [k,k,{cin},Cout] "
            "with odd k <= 7 and Cout <= 4"
        )
    if 4 * k * k * cin * cout > 48 * 1024:
        raise ValueError(f"{name}: weights exceed 48 KB of shared memory")
    if bias is not None and bias.numel() != cout:
        raise ValueError(f"{name}: bias must hold {cout} values")
    if prepadded:
        return 0, in_h - (k - 1), in_w - (k - 1)
    return (k - 1) // 2, in_h, in_w


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
    pad, out_h, out_w = _check_args("head_conv", x, kernel, bias, prepadded)
    n, in_h, in_w, cin = x.shape
    k, cout = kernel.shape[0], kernel.shape[3]
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
head_conv_cuda.variant_launches = {"tensor_core": 0, "reg_tile": 0}
# by batch size N
head_conv_cuda.batch_launches = collections.Counter()


def head_conv_backward_cuda(grad, x, kernel, bias=None, prepadded=False,
                           needs=(True, True, True)):
    """Launch the head conv's backward kernels (``csrc/headconv_bwd.cu``);
    same semantics as :func:`head_conv_backward_plain`.

    Takes the cotangent ``grad`` [N,H',W',Cout] and the forward's inputs as
    :func:`head_conv_cuda` takes them (float32 or bfloat16, ``kernel`` with
    any strides), on one CUDA device; raises for anything else. dx is
    written dense, dw with ``kernel``'s strides (on the path the gradient
    of the OIHW parameter, permuted), db dense. One launch, and a second
    that sums the weight and bias gradients' per-block partials when either
    is needed."""
    tensors = (grad, x, kernel) if bias is None else (grad, x, kernel, bias)
    cuda_lib.require_cuda("head_conv backward", *tensors)
    pad, out_h, out_w = _check_args("head_conv backward", x, kernel, bias, prepadded)
    n, in_h, in_w, cin = x.shape
    k, cout = kernel.shape[0], kernel.shape[3]
    if tuple(grad.shape) != (n, out_h, out_w, cout):
        raise ValueError(f"head_conv backward: cotangent {tuple(grad.shape)}, expected "
                         f"{(n, out_h, out_w, cout)}")
    need_dx, need_dw, need_db = needs[0], needs[1], bias is not None and needs[2]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device) if need_dx else None
    dw = torch.empty_like(kernel) if need_dw else None
    db = torch.empty_like(bias) if need_db else None
    if not (need_dx or need_dw or need_db):
        return dx, dw, db
    code = cuda_lib.dtype_code(x.dtype)
    if x.stride(3) != 1:
        x = x.contiguous()
    # the weights in x's dtype, as the forward reads them; on the path they
    # already are, and nothing is launched here
    wk = kernel.to(x.dtype)
    grad = grad.to(x.dtype).contiguous()
    lib = cuda_lib.load()
    parts = lib.dfvo_headconv_bwd_parts(n, in_h, in_w) if need_dw or need_db else 0
    work = (torch.empty((parts, k * k * cin * cout + cout), dtype=torch.float32,
                        device=x.device) if parts else None)
    stream = cuda_lib.stream_of(x)
    rc = lib.dfvo_headconv_bwd(
        x.data_ptr(), *x.stride()[:3], wk.data_ptr(), *wk.stride(), grad.data_ptr(),
        None if dx is None else dx.data_ptr(), None if work is None else work.data_ptr(),
        n, in_h, in_w, cin, out_h, out_w, k, cout, pad, int(need_dw), int(need_db), code,
        stream,
    )
    cuda_lib.check(rc, "head_conv backward")
    if work is not None:
        rc = lib.dfvo_headconv_bwd_reduce(
            work.data_ptr(), parts, None if dw is None else dw.data_ptr(),
            *(dw.stride() if dw is not None else (0, 0, 0, 0)),
            cuda_lib.dtype_code(kernel.dtype), None if db is None else db.data_ptr(),
            cuda_lib.dtype_code(bias.dtype) if bias is not None else 0, k, cin, cout, stream,
        )
        cuda_lib.check(rc, "head_conv backward (partial sums)")
    head_conv_backward_cuda.launches += 1
    head_conv_backward_cuda.dtype_launches[x.dtype] += 1
    head_conv_backward_cuda.batch_launches[n] += 1
    return dx, dw, db


head_conv_backward_cuda.launches = 0
head_conv_backward_cuda.dtype_launches = {torch.float32: 0, torch.bfloat16: 0}
# by batch size N
head_conv_backward_cuda.batch_launches = collections.Counter()


HeadConvFunction = kernel_function("HeadConvFunction", head_conv_cuda, head_conv_plain, 3,
                                   head_conv_backward_cuda, head_conv_backward_plain)


def head_conv(x, kernel, bias=None, prepadded=False):
    """Small-Cout conv, stride 1: plain on the CPU, the CUDA kernel on a
    CUDA device; through :class:`HeadConvFunction` when a gradient is
    recorded."""
    if records_grad(x, kernel, bias):
        return HeadConvFunction.apply(x, kernel, bias, prepadded)
    if x.device.type == "cpu":
        return head_conv_plain(x, kernel, bias, prepadded)
    return head_conv_cuda(x, kernel, bias, prepadded)
