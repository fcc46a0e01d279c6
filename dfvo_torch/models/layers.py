"""Shared layers for the network stack, on NHWC tensors.

Counterpart of ``dfvo_tpu/models/layers.py``. Activations are NHWC, which
is NCHW in ``torch.channels_last`` memory: the convolution modules permute
to the logical NCHW view that ``torch.nn`` expects and back, without a copy,
and the kernels in ``dfvo_torch/ops`` read the NHWC memory directly.
Parameters keep torch's own layouts and names (OIHW conv weights), so the
reference's torch checkpoints map onto these modules key for key.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.headconv import head_conv
from ..utils.device import upload


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied to an NHWC tensor."""

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` applied to an NHWC tensor."""

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))


class FrozenBatchNorm(nn.Module):
    """Inference batch norm: y = γ(x-μ)/√(σ²+ε) + β, always from the running
    statistics (also during finetuning), channels last."""

    def __init__(self, features, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * inv + (self.bias - self.running_mean * inv)


class HeadConv(nn.Module):
    """Stride-1 conv with Cout <= 4 on the head-conv op (``ops/headconv``:
    the CUDA kernel on the card). Parameters are ``nn.Conv2d``'s
    (``weight`` OIHW, ``bias``).

    ``padding`` is 'SAME' (zero pad) or 'PREPADDED' (input already padded by
    (k-1)//2 per side, e.g. reflect-padded Conv3x3 heads).
    """

    def __init__(self, in_ch, out_ch, kernel_size, padding="SAME", device=None):
        super().__init__()
        if out_ch > 4:
            raise ValueError(f"HeadConv serves Cout <= 4, got {out_ch}")
        if padding not in ("SAME", "PREPADDED"):
            raise ValueError(f"unknown HeadConv padding {padding!r}")
        self.padding = padding
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x):
        return head_conv(
            x, self.weight.permute(2, 3, 1, 0), self.bias,
            prepadded=self.padding == "PREPADDED",
        )


@functools.lru_cache(maxsize=None)
def _reflect_index(n, device):
    """Source indices of a 1-pixel reflect pad of n: 1, 0, 1, ..., n-1, n-2."""
    idx = np.concatenate([[1], np.arange(n), [n - 2]])
    return upload(idx, device)


def reflect_pad1_nhwc(x):
    """1-pixel reflect pad of H and W as one gather, in NHWC memory (the
    head-conv kernel reads whole pixels; the reflect pad of the NCHW view
    returns NCHW memory on the card)."""
    h, w = x.shape[1:3]
    return x[:, _reflect_index(h, x.device)[:, None], _reflect_index(w, x.device)[None, :]]


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 convolution; Cout <= 4 runs as a pre-padded
    head conv."""

    def __init__(self, in_ch, out_ch, device=None):
        super().__init__()
        if out_ch <= 4:
            self.conv = HeadConv(in_ch, out_ch, 3, padding="PREPADDED",
                                 device=device)
        else:
            self.conv = Conv2d(in_ch, out_ch, 3, device=device)

    def forward(self, x):
        if isinstance(self.conv, HeadConv):
            return self.conv(reflect_pad1_nhwc(x))
        return self.conv(to_nhwc(F.pad(to_nchw(x), (1, 1, 1, 1), mode="reflect")))


class ConvBlock(nn.Module):
    """Conv3x3 followed by ELU."""

    def __init__(self, in_ch, out_ch, device=None):
        super().__init__()
        self.conv = Conv3x3(in_ch, out_ch, device=device)

    def forward(self, x):
        return F.elu(self.conv(x))


def upsample2x_nearest(x):
    """Nearest-neighbour 2x spatial upsample for NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)


@functools.lru_cache(maxsize=None)
def _interp_matrix(src, dst, align_corners):
    """[dst x src] 1-D bilinear interpolation matrix (numpy, float32)."""
    if align_corners and dst > 1:
        pos = np.linspace(0.0, src - 1.0, dst)
    else:
        pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        pos = np.clip(pos, 0.0, src - 1.0)  # border clamp (torch semantics)
    i0 = np.clip(np.floor(pos).astype(int), 0, src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    w1 = pos - i0
    M = np.zeros((dst, src), np.float32)
    M[np.arange(dst), i0] += 1.0 - w1
    M[np.arange(dst), i1] += w1
    M.setflags(write=False)
    return M


@functools.lru_cache(maxsize=None)
def _interp_tensor(src, dst, align_corners, dtype, device):
    return upload(_interp_matrix(src, dst, align_corners).copy(), device, dtype)


def resize_bilinear(x, out_h, out_w, align_corners=False):
    """Bilinear resize for NHWC tensors, torch ``F.interpolate`` semantics
    without antialiasing, as two separable matmuls with the JAX package's
    interpolation matrices; an exact 2x half-pixel downsample is a 2x2 mean
    pool."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    if not align_corners and h == 2 * out_h and w == 2 * out_w:
        return x.reshape(n, out_h, 2, out_w, 2, c).mean(dim=(2, 4))
    Mr = _interp_tensor(h, out_h, align_corners, x.dtype, x.device)
    Mc = _interp_tensor(w, out_w, align_corners, x.dtype, x.device)
    y = torch.einsum("hH,nHwc->nhwc", Mr, x)
    return torch.einsum("wW,nhWc->nhwc", Mc, y)
