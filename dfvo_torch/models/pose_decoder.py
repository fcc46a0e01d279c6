"""Monodepth2 pose decoder on NHWC tensors.

Counterpart of ``dfvo_tpu/models/pose_decoder.py``: a squeeze 1x1 conv on
the deepest encoder feature, three pose convs, the mean over the image,
and a 0.01-scaled (axis-angle, translation) output. The four convs sit in
one ``net`` ModuleList in the reference's order (squeeze, pose_0, pose_1,
pose_2), so monodepth2's ``pose.pth`` keys map onto it unchanged.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d

NUM_CH_ENC = (64, 64, 128, 256, 512)  # ResNet-18 pyramid


class PoseDecoder(nn.Module):
    """(axisangle, translation), each [N x F x 1 x 3], from the deepest
    features of ``num_input_features`` encoders."""

    def __init__(self, num_input_features=1, num_frames_to_predict_for=2, device=None):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            Conv2d(NUM_CH_ENC[-1], 256, 1, device=device),  # squeeze
            Conv2d(num_input_features * 256, 256, 3, 1, 1, device=device),
            Conv2d(256, 256, 3, 1, 1, device=device),
            Conv2d(256, 6 * num_frames_to_predict_for, 1, device=device),
        ])

    def forward(self, last_features):
        """last_features: list of [N x H x W x 512] deepest features."""
        out = torch.cat([F.relu(self.net[0](f)) for f in last_features], dim=-1)
        out = F.relu(self.net[1](out))
        out = F.relu(self.net[2](out))
        out = torch.mean(self.net[3](out), dim=(1, 2))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]
