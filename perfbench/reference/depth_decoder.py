"""Monodepth2 depth decoder on NHWC tensors.

A frozen float32 copy of ``dfvo_torch/models/depth_decoder.py`` (the benchmark's
reference; the cost volume, filter and head conv are the plain formulas of
``reference/ops.py``), itself the counterpart of the JAX package's model: a skip-connected
upconv decoder emitting sigmoid disparity at four scales. The blocks sit in
one ``decoder`` ModuleList in the reference's order (upconvs (4,0), (4,1),
..., (0,1), then the dispconvs), so monodepth2's ``depth.pth`` keys map
onto it unchanged.
"""

import torch
import torch.nn as nn

from .layers import Conv3x3, ConvBlock, upsample2x_nearest

NUM_CH_ENC = (64, 64, 128, 256, 512)  # ResNet-18 pyramid
NUM_CH_DEC = (16, 32, 64, 128, 256)
SCALES = (0, 1, 2, 3)


class DepthDecoder(nn.Module):
    """Returns {scale: [N x H/2^s x W/2^s x 1] sigmoid disparity}."""

    def __init__(self, device=None):
        super().__init__()
        blocks = []
        for i in range(4, -1, -1):
            cin = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i], device=device))
            cin = NUM_CH_DEC[i] + (NUM_CH_ENC[i - 1] if i > 0 else 0)
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i], device=device))
        for s in SCALES:
            blocks.append(Conv3x3(NUM_CH_DEC[s], 1, device=device))
        self.decoder = nn.ModuleList(blocks)

    def forward(self, input_features):
        outputs = {}
        x = input_features[-1]
        for step, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * step](x)
            x = upsample2x_nearest(x)
            if i > 0:
                x = torch.cat([x, input_features[i - 1]], dim=-1)
            x = self.decoder[2 * step + 1](x)
            if i in SCALES:
                outputs[i] = torch.sigmoid(self.decoder[10 + i](x))
        return outputs
