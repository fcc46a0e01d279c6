"""Monodepth2 depth network (encoder + decoder wrapper).

Counterpart of the depth half of ``dfvo_tpu/models/monodepth2.py``,
including disparity-to-depth conversion and the x5.4 KITTI
stereo-baseline multiplier.
"""

import torch.nn as nn

from .depth_decoder import DepthDecoder
from .layers import resize_bilinear
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

    def forward(self, img):
        """img: [N x H x W x 3] in [0, 1].

        Returns a dict with ``depth`` [N x H x W] (scale 0 at input size, x
        baseline multiplier), ``disp`` [N x H x W] scaled disparity and
        ``disps`` {scale: raw sigmoid disparity}.
        """
        feats = self.encoder(img)
        disps = self.decoder(feats)
        _, h, w, _ = img.shape
        disp0 = resize_bilinear(disps[0], h, w, align_corners=False)
        scaled_disp, depth = disp_to_depth(disp0, self.min_depth, self.max_depth)
        return {
            "depth": depth[..., 0] * self.baseline_multiplier,
            "disp": scaled_disp[..., 0],
            "disps": disps,
        }
