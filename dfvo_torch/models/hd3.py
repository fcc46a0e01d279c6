"""HD3 flow/stereo network on NHWC tensors.

Counterpart of ``dfvo_tpu/models/hd3.py``: a DLA-34 (or VGG) feature
pyramid over both images in one batch, a cost volume per level (the
correlation op with D = 4: 81 channels, the CUDA kernel on the card), and
the coarse-to-fine decoding of discrete motion distributions
(``models/hd3_ops.py``). ``task='flow'`` estimates 2-D motion,
``task='stereo'`` 1-D disparity.

Submodules carry the reference torch network's names (``encoder.base.
level3.tree1.root.conv``, ``encoder.dla_up.ida_0.up_1``, ``cost_bn_0``,
``Decoder_0.cls.2``, ...; Sequential indices where the reference has a
Sequential), which the JAX package's module names mirror with ``_i``
suffixes, so the zoo checkpoint maps onto this module key for key.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.correlation import correlation
from .hd3_ops import density2vector, disp2flow, flow_warp
from .layers import (Conv2d, ConvTranspose2d, FrozenBatchNorm, nhwc_out, resize_bilinear,
                     to_nchw)


def _conv(cin, cout, kernel, stride=1, dilation=1, bias=False, device=None):
    """Conv with padding dilation·(k-1)/2 per side."""
    return Conv2d(cin, cout, kernel, stride, dilation * (kernel - 1) // 2, dilation=dilation,
                  bias=bias, device=device)


def _conv_bn_relu(cin, cout, kernel, stride=1, dilation=1, device=None):
    return nn.Sequential(_conv(cin, cout, kernel, stride, dilation, device=device),
                         FrozenBatchNorm(cout, device=device), nn.ReLU())


def _deconv(cin, cout, kernel, stride, padding, groups=1, device=None):
    """A transposed convolution without bias (the JAX package's ``Deconv``,
    an input-dilated correlation with the kernel flipped)."""
    return ConvTranspose2d(cin, cout, kernel, stride, padding, groups=groups, bias=False,
                           device=device)


def _max_pool(x, s):
    return nhwc_out(F.max_pool2d(to_nchw(x), s, s))


# -- DLA-34 -----------------------------------------------------------------------


class DLABasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, device=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, device=device)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, 1, dilation, device=device)
        self.bn2 = FrozenBatchNorm(planes, device=device)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Root(nn.Module):
    def __init__(self, in_channels, out_channels, kernel=1, residual=False, device=None):
        super().__init__()
        self.residual = residual
        self.conv = _conv(in_channels, out_channels, kernel, device=device)
        self.bn = FrozenBatchNorm(out_channels, device=device)

    def forward(self, *xs):
        out = self.bn(self.conv(torch.cat(xs, dim=-1)))
        if self.residual:
            out = out + xs[0]
        return F.relu(out)


class Tree(nn.Module):
    """A deep-layer-aggregation tree. The aggregation's inputs gather in one
    ``children`` list shared down the recursion: the level root's bottom
    first, then each subtree's output; the leaf's Root concatenates
    (x2, x1, *children) in that order."""

    def __init__(self, levels, in_channels, out_channels, stride=1, level_root=False,
                 root_dim=0, root_kernel_size=1, dilation=1, root_residual=False,
                 device=None):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels, self.stride, self.level_root = levels, stride, level_root
        if levels == 1:
            self.tree1 = DLABasicBlock(in_channels, out_channels, stride, dilation, device)
            self.tree2 = DLABasicBlock(out_channels, out_channels, 1, dilation, device)
            self.root = Root(root_dim, out_channels, root_kernel_size, root_residual, device)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride, root_dim=0,
                              root_kernel_size=root_kernel_size, dilation=dilation,
                              root_residual=root_residual, device=device)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_kernel_size=root_kernel_size, dilation=dilation,
                              root_residual=root_residual, device=device)
        self.project = None
        if in_channels != out_channels:
            self.project = nn.Sequential(_conv(in_channels, out_channels, 1, device=device),
                                         FrozenBatchNorm(out_channels, device=device))

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = _max_pool(x, self.stride) if self.stride > 1 else x
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        x1 = self.tree1(x, residual)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """The DLA-34 trunk; returns all 7 level outputs."""

    def __init__(self, levels, channels, device=None):
        super().__init__()
        ch = channels
        self.base_layer = _conv_bn_relu(3, ch[0], 7, device=device)
        self.level0 = self._conv_level(ch[0], ch[0], levels[0], 1, device)
        self.level1 = self._conv_level(ch[0], ch[1], levels[1], 2, device)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False, device=device)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True, device=device)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True, device=device)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True, device=device)
        self.level6 = Tree(levels[6], ch[5], ch[6], 2, level_root=True, device=device)

    @staticmethod
    def _conv_level(inplanes, planes, convs, stride, device):
        """Sequential of (conv, bn, relu) x convs; the first conv strides."""
        layers = []
        for i in range(convs):
            layers += list(_conv_bn_relu(inplanes if i == 0 else planes, planes, 3,
                                         stride if i == 0 else 1, device=device))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.base_layer(x)
        outs = []
        for i in range(7):
            x = getattr(self, f"level{i}")(x)
            outs.append(x)
        return outs


class IDAUp(nn.Module):
    """Iterative deep aggregation: each input projected to ``out_dim``
    (``proj_i``, where its channels differ) and upsampled by a depthwise
    transposed conv (``up_i``, where its factor is not 1), then merged left
    to right by ``node_i``."""

    def __init__(self, node_kernel, out_dim, channels, up_factors, device=None):
        super().__init__()
        self.channels, self.out_dim = tuple(channels), out_dim
        self.up_factors = tuple(int(f) for f in up_factors)
        for i, (c, f) in enumerate(zip(self.channels, self.up_factors)):
            if c != out_dim:
                setattr(self, f"proj_{i}", _conv_bn_relu(c, out_dim, 1, device=device))
            if f != 1:
                setattr(self, f"up_{i}", _deconv(out_dim, out_dim, f * 2, f, f // 2,
                                                 groups=out_dim, device=device))
        for i in range(1, len(self.channels)):
            setattr(self, f"node_{i}", _conv_bn_relu(2 * out_dim, out_dim, node_kernel,
                                                     device=device))

    def forward(self, layers):
        assert len(layers) == len(self.channels)
        layers = list(layers)
        for i, (c, f) in enumerate(zip(self.channels, self.up_factors)):
            x = layers[i]
            if c != self.out_dim:
                x = getattr(self, f"proj_{i}")(x)
            if f != 1:
                x = getattr(self, f"up_{i}")(x)
            layers[i] = x
        x = layers[0]
        y = []
        for i in range(1, len(layers)):
            x = getattr(self, f"node_{i}")(torch.cat([x, layers[i]], dim=-1))
            y.append(x)
        return x, y


class DLAUp(nn.Module):
    """Multi-scale aggregation over the DLA pyramid."""

    def __init__(self, channels, device=None):
        super().__init__()
        channels = list(channels)
        scales = np.array([2**i for i in range(len(channels))], int)
        in_channels = list(channels)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(3, channels[j], in_channels[j:],
                                            scales[j:] // scales[j], device=device))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers):
        layers = list(layers)
        ms_feat = [layers[-1]]
        for i in range(self.n):
            x, y = getattr(self, f"ida_{i}")(layers[-i - 2:])
            layers[-i - 1:] = y
            ms_feat.append(x)
        return ms_feat


class DLAUpEncoder(nn.Module):
    """DLA-34 + DLAUp; returns the aggregated features over channels[1:],
    fine to coarse."""

    def __init__(self, planes=(16, 32, 64, 128, 256, 512, 512), device=None):
        super().__init__()
        self.base = DLA((1, 1, 1, 2, 2, 1, 1), tuple(planes), device=device)
        self.dla_up = DLAUp(tuple(planes[1:]), device=device)

    def forward(self, x):
        feats = self.base(x)
        return self.dla_up(feats[1:])[::-1]


class VGGEncoder(nn.Module):
    """Plain strided-conv pyramid: per block three 3x3 conv + bn + relu,
    the first with stride 2."""

    def __init__(self, planes=(16, 32, 64, 96, 128, 196), device=None):
        super().__init__()
        self.n = len(planes)
        cin = 3
        for i, p in enumerate(planes):
            for j in (1, 2, 3):
                setattr(self, f"block_{i}_conv{j}",
                        _conv(cin, p, 3, 2 if j == 1 else 1, device=device))
                setattr(self, f"block_{i}_bn{j}", FrozenBatchNorm(p, device=device))
                cin = p

    def forward(self, x):
        outs = []
        for i in range(self.n):
            for j in (1, 2, 3):
                x = getattr(self, f"block_{i}_conv{j}")(x)
                x = F.relu(getattr(self, f"block_{i}_bn{j}")(x))
            outs.append(x)
        return outs


# -- decoders ---------------------------------------------------------------------


class PreActBlock(nn.Module):
    def __init__(self, inplanes, planes, normalize=True, device=None):
        super().__init__()
        self.normalize = normalize
        if normalize:
            self.bn1 = FrozenBatchNorm(inplanes, device=device)
        self.shortcut = None
        if inplanes != planes:
            self.shortcut = nn.Sequential(_conv(inplanes, planes, 1, device=device))
        self.conv1 = _conv(inplanes, planes, 3, device=device)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, device=device)

    def forward(self, x):
        out = F.relu(self.bn1(x)) if self.normalize else x
        shortcut = self.shortcut(out) if self.shortcut is not None else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        return out + shortcut


class ResnetDecoder(nn.Module):
    def __init__(self, inplanes, planes, device=None):
        super().__init__()
        self.block1 = PreActBlock(inplanes, planes, normalize=False, device=device)
        self.block2 = PreActBlock(planes, planes, normalize=True, device=device)

    def forward(self, x):
        return self.block2(self.block1(x))


class HDADecoder(nn.Module):
    def __init__(self, inplanes, planes, device=None):
        super().__init__()
        self.block1 = PreActBlock(inplanes, planes, normalize=False, device=device)
        self.block2 = PreActBlock(planes, planes, normalize=True, device=device)
        self.root = nn.Sequential(FrozenBatchNorm(2 * planes, device=device), nn.ReLU(),
                                  _conv(2 * planes, planes, 1, device=device))

    def forward(self, x):
        y1 = self.block1(x)
        y2 = self.block2(y1)
        return self.root(torch.cat([y1, y2], dim=-1))


class HD3Decoder(nn.Module):
    """A level's decoder: the mapping block, the classifier, and (below the
    finest level) the upsampled feature for the next level."""

    def __init__(self, inplanes, classes, up_classes, block, device=None):
        super().__init__()
        block_cls = ResnetDecoder if block == "resnet" else HDADecoder
        self.mapping = block_cls(inplanes, 128, device=device)
        self.cls = nn.Sequential(FrozenBatchNorm(128, device=device), nn.ReLU(),
                                 _conv(128, classes, 1, bias=True, device=device))
        self.up = None
        if up_classes > 0:
            self.up = nn.Sequential(FrozenBatchNorm(128, device=device), nn.ReLU(),
                                    _deconv(128, up_classes, 4, 2, 1, device=device),
                                    FrozenBatchNorm(up_classes, device=device), nn.ReLU())

    def forward(self, x):
        out = self.mapping(x)
        return self.cls(out), (self.up(out) if self.up is not None else None)


class HD3Context(nn.Module):
    """The dilated context head of the finest level."""

    DILATIONS = (1, 1, 2, 4, 8, 16, 1)

    def __init__(self, inplanes, classes, device=None):
        super().__init__()
        self.dc_conv = nn.Sequential(*[
            _conv_bn_relu(inplanes if i == 0 else 128, 128, 3, dilation=d, device=device)
            for i, d in enumerate(self.DILATIONS)])
        self.cls = _conv(128, classes, 1, bias=True, device=device)

    def forward(self, x):
        return self.cls(self.dc_conv(x)), None


# -- HD3Net -----------------------------------------------------------------------


class HD3Net(nn.Module):
    """Coarse-to-fine discrete-distribution matching.

    Call with two [N x H x W x 3] images (H, W multiples of 64). Returns
    (ms_prob, ms_vect): per level, coarse to fine, the [N x h x w x classes]
    logits and the motion vectors in full-resolution units
    (vect · 2^(ds - l)).
    """

    def __init__(self, task="flow", encoder="dlaup", decoder="hda",
                 corr_range=(4, 4, 4, 4, 4), context=False, ds=6, device=None):
        super().__init__()
        if task not in ("flow", "stereo"):
            raise ValueError(f"HD3Net: unknown task {task!r}")
        self.task, self.context, self.ds = task, context, ds
        self.dim = 1 if task == "stereo" else 2
        self.levels = len(corr_range)
        if task == "flow":
            self.classes = [(2 * d + 1) ** 2 for d in corr_range]
        else:
            self.classes = [2 * d + 1 for d in corr_range]
        if encoder == "vgg":
            pyr_channels = [16, 32, 64, 96, 128, 196]
            self.encoder = VGGEncoder(tuple(pyr_channels), device=device)
        else:
            pyr_channels = [16, 32, 64, 128, 256, 512, 512]
            self.encoder = DLAUpEncoder(tuple(pyr_channels), device=device)
        feat_d = pyr_channels[::-1]
        for l in range(self.levels):
            cost_d = len(range(81)[self._cost_slice(l)])
            setattr(self, f"cost_bn_{l}", FrozenBatchNorm(cost_d, device=device))
            in_d = cost_d
            if l > 0:
                in_d += feat_d[l] + self.classes[l] + self.dim
            up_classes = self.classes[l + 1] if l < self.levels - 1 else -1
            if context and l == self.levels - 1:
                dec = HD3Context(in_d, self.classes[l], device=device)
            else:
                dec = HD3Decoder(in_d, self.classes[l], up_classes, decoder, device=device)
            setattr(self, f"Decoder_{l}", dec)

    def _cost_slice(self, l):
        """The channels of the 81-channel cost volume that level l keeps:
        all for flow, the dy = 0 row for stereo."""
        if self.task != "stereo":
            return slice(None)
        c = self.classes[l] // 2
        return slice(c * (2 * c + 1), (c + 1) * (2 * c + 1))

    def forward(self, img1, img2):
        feats = self.encoder(torch.cat([img1, img2], dim=0))
        bs = img1.shape[0]
        fp_0 = [f[:bs] for f in feats[::-1]]
        fp_1 = [f[bs:] for f in feats[::-1]]

        ms_prob, ms_vect = [], []
        up_curr_vect = prev_up_feat = None
        for l in range(self.levels):
            ref_feat, tar_feat = fp_0[l], fp_1[l]
            if l > 0:
                vect = up_curr_vect
                if vect.shape[-1] < 2:
                    vect = disp2flow(vect)
                tar_feat = flow_warp(tar_feat, vect)
            cost_vol = correlation(ref_feat, tar_feat, max_disp=4, stride=1)
            cost_vol = getattr(self, f"cost_bn_{l}")(cost_vol[..., self._cost_slice(l)])
            if l == 0:
                decoder_input = cost_vol
            else:
                decoder_input = torch.cat([cost_vol, ref_feat, prev_up_feat, up_curr_vect],
                                          dim=-1)
            prob_map, up_feat = getattr(self, f"Decoder_{l}")(decoder_input)

            curr_vect = density2vector(prob_map, self.dim, True)
            if l > 0:
                curr_vect = curr_vect + up_curr_vect
            if self.task == "stereo":
                curr_vect = torch.clamp(curr_vect, max=0.0)
            ms_prob.append(prob_map)
            ms_vect.append(curr_vect * 2 ** (self.ds - l))
            prev_up_feat = up_feat
            if l < self.levels - 1:
                h, w = curr_vect.shape[1], curr_vect.shape[2]
                up_curr_vect = 2.0 * resize_bilinear(curr_vect, 2 * h, 2 * w,
                                                     align_corners=True)
        return ms_prob, ms_vect
