"""Layers of the reference networks on NHWC tensors: a frozen copy of
``dfvo_torch/models/layers.py`` with the head conv as its plain formula.
Parameters keep torch's layouts and names, so one state dict serves the
reference and the measured program alike."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops import head_conv_plain


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def nhwc_out(y):
    return to_nhwc(y)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied to an NHWC tensor."""

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` applied to an NHWC tensor."""

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))


class FrozenBatchNorm(nn.Module):
    """y = gamma (x - mu) / sqrt(var + eps) + beta from the running
    statistics, channels last."""

    def __init__(self, features, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x):
        return (x - self.running_mean) / torch.sqrt(self.running_var + self.eps) \
            * self.weight + self.bias


class HeadConv(nn.Module):
    """Stride-1 conv with Cout <= 4 (the head conv C), 'SAME' zero padding or
    'PREPADDED'; parameters are ``nn.Conv2d``'s."""

    def __init__(self, in_ch, out_ch, kernel_size, padding="SAME", device=None):
        super().__init__()
        self.padding = padding
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x):
        return head_conv_plain(x, self.weight.permute(2, 3, 1, 0), self.bias,
                               prepadded=self.padding == "PREPADDED")


def reflect_pad1_nhwc(x):
    return to_nhwc(F.pad(to_nchw(x), (1, 1, 1, 1), mode="reflect"))


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 convolution; Cout <= 4 is a head conv."""

    def __init__(self, in_ch, out_ch, device=None):
        super().__init__()
        if out_ch <= 4:
            self.conv = HeadConv(in_ch, out_ch, 3, padding="PREPADDED", device=device)
        else:
            self.conv = Conv2d(in_ch, out_ch, 3, device=device)

    def forward(self, x):
        return self.conv(reflect_pad1_nhwc(x))


class ConvBlock(nn.Module):
    """Conv3x3 followed by ELU."""

    def __init__(self, in_ch, out_ch, device=None):
        super().__init__()
        self.conv = Conv3x3(in_ch, out_ch, device=device)

    def forward(self, x):
        return F.elu(self.conv(x))


def upsample2x_nearest(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
