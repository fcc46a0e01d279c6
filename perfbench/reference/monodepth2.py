"""Monodepth2's depth network (ResNet-18 encoder, skip-connected decoder,
sigmoid disparity -> metric depth): a frozen copy of the depth half of
``dfvo_torch/models/monodepth2.py``."""

import torch.nn as nn

from .depth_decoder import DepthDecoder
from .ops import resize_bilinear
from .resnet_encoder import ResnetEncoder


class Monodepth2Depth(nn.Module):
    def __init__(self, min_depth=0.1, max_depth=100.0, baseline_multiplier=5.4,
                 device=None):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.baseline_multiplier = baseline_multiplier
        self.encoder = ResnetEncoder(device=device)
        self.decoder = DepthDecoder(device=device)

    def forward(self, img, out_hw=None):
        """img: [N x H x W x 3] in [0, 1], H and W multiples of 32. Returns
        ``depth`` [N x h x w]: the scale-0 disparity resized to ``out_hw``
        (half-pixel bilinear), scaled into [1/max_depth, 1/min_depth],
        inverted and multiplied by the baseline multiplier."""
        disp = self.decoder(self.encoder(img))[0]
        h, w = out_hw or img.shape[1:3]
        disp = resize_bilinear(disp, h, w, align_corners=False)[..., 0]
        lo, hi = 1.0 / self.max_depth, 1.0 / self.min_depth
        return {"depth": self.baseline_multiplier / (lo + (hi - lo) * disp)}
