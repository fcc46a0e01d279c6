"""Monodepth2 depth and pose networks (encoder + decoder wrappers).

Counterpart of ``dfvo_tpu/models/monodepth2.py``, including
disparity-to-depth conversion and the x5.4 KITTI stereo-baseline
multiplier.
"""

import torch
import torch.nn as nn

from ..geometry.lie import transformation_from_parameters
from .depth_decoder import DepthDecoder
from .layers import resize_bilinear
from .pose_decoder import PoseDecoder
from .resnet_encoder import ResnetEncoder


def disp_to_depth(disp, min_depth, max_depth):
    """Sigmoid disparity -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


class Monodepth2Depth(nn.Module):
    """Single-view depth: ResNet-18 encoder -> skip-connected decoder ->
    sigmoid disparity at 4 scales -> metric depth.

    ``min_depth``/``max_depth`` set the disparity range; the baseline
    multiplier is x5.4 for KITTI stereo-trained models.
    """

    def __init__(self, min_depth=0.1, max_depth=100.0, baseline_multiplier=5.4,
                 device=None):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.baseline_multiplier = baseline_multiplier
        self.encoder = ResnetEncoder(device=device)
        self.decoder = DepthDecoder(device=device)

    def forward(self, img, out_hw=None):
        """img: [N x H x W x 3] in [0, 1]; H and W multiples of 32 (the
        decoder's skip connections).

        Returns a dict with ``depth`` [N x h x W] (scale 0 resized to
        ``out_hw``, by default the input size, x baseline multiplier),
        ``disp`` scaled disparity of the same size and ``disps`` {scale: raw
        sigmoid disparity}.
        """
        feats = self.encoder(img)
        disps = self.decoder(feats)
        h, w = out_hw or img.shape[1:3]
        disp0 = resize_bilinear(disps[0], h, w, align_corners=False)
        scaled_disp, depth = disp_to_depth(disp0, self.min_depth, self.max_depth)
        return {
            "depth": depth[..., 0] * self.baseline_multiplier,
            "disp": scaled_disp[..., 0],
            "disps": disps,
        }


class Monodepth2Pose(nn.Module):
    """Two-view pose CNN: ResNet-18 on two stacked RGB frames -> pose
    decoder -> the relative pose as a transform (the inverse composition of
    the first predicted frame), translation x the baseline multiplier."""

    def __init__(self, baseline_multiplier=5.4, device=None):
        super().__init__()
        self.baseline_multiplier = baseline_multiplier
        self.encoder = ResnetEncoder(num_input_images=2, device=device)
        self.decoder = PoseDecoder(num_input_features=1, num_frames_to_predict_for=2,
                                   device=device)

    def forward(self, img_pair):
        """img_pair: [N x H x W x 6] two stacked RGB frames in [0, 1].

        Returns [N x 4 x 4] relative poses.
        """
        feats = self.encoder(img_pair)
        axisangle, translation = self.decoder([feats[-1]])
        T = transformation_from_parameters(axisangle[:, 0, 0], translation[:, 0, 0],
                                           invert=True)
        t = T[:, :3, 3:] * self.baseline_multiplier
        return torch.cat([torch.cat([T[:, :3, :3], t], dim=-1), T[:, 3:]], dim=-2)
