"""ResNet-18 encoder on NHWC tensors.

Counterpart of ``dfvo_tpu/models/resnet_encoder.py``, including the
multi-image input of the pose network (two stacked RGB frames, a
6-channel ``conv1``). Submodules carry torchvision's names
(``encoder.layer1.0.conv1``, ``downsample.0/1``), so the reference's
monodepth2 ``encoder.pth`` and ``pose_encoder.pth`` keys map onto them
unchanged.
"""

import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, FrozenBatchNorm, to_nchw, to_nhwc


class BasicBlock(nn.Module):
    """torchvision BasicBlock: two 3x3 convs + identity/downsample skip."""

    def __init__(self, inplanes, planes, stride=1, device=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False,
                            device=device)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, device=device)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False, device=device),
                FrozenBatchNorm(planes, device=device),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class _ResNet(nn.Module):
    def __init__(self, blocks, in_channels=3, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = FrozenBatchNorm(64, device=device)
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), blocks)):
            layers = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                layers.append(BasicBlock(inplanes, planes, stride, device=device))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))


class ResnetEncoder(nn.Module):
    """ResNet-18 encoder returning the 5-scale feature pyramid, channels
    [64, 64, 128, 256, 512] at strides [2, 4, 8, 16, 32], of
    ``num_input_images`` RGB frames stacked on the channels (1 for depth,
    2 for pose)."""

    def __init__(self, num_input_images=1, device=None):
        super().__init__()
        self.encoder = _ResNet((2, 2, 2, 2), 3 * num_input_images, device=device)

    def forward(self, x):
        e = self.encoder
        x = (x - 0.45) / 0.225  # monodepth2 input normalisation
        f0 = F.relu(e.bn1(e.conv1(x)))
        x = to_nhwc(F.max_pool2d(to_nchw(f0), 3, 2, 1))
        feats = [f0]
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return feats
