"""LiteFlowNet on NHWC tensors, with the cost-volume, regularization-filter
and head-conv ops.

A frozen float32 copy of ``dfvo_torch/models/liteflownet.py`` (the benchmark's
reference; the cost volume, filter and head conv are the plain formulas of
``reference/ops.py``), itself the counterpart of the JAX package's model: a 6-level feature pyramid
processed coarse-to-fine (levels 6 -> 2), each level running Matching (cost
volume -> flow delta), Subpixel (feature-concat refinement) and
Regularization (feature-driven local flow filtering). Outputs a dict of
flows {1..5}: flows[k] lives at 1/2^(k+1) resolution and is scaled by
20·0.5^k to pixel units of the full-resolution input.

Submodules carry the reference torch network's names (``moduleFeatures``,
``moduleMatching.{0..4}.moduleMain.{0,2,4,6}``, ...; the ModuleLists index
levels [2, 3, 4, 5, 6] as 0..4), so its ``network-*.pytorch`` checkpoint maps
onto this module key for key.
"""

import torch
import torch.nn as nn

from .layers import Conv2d, ConvTranspose2d, HeadConv
from .ops import correlation_plain as correlation
from .ops import (flow_to_coords, grid_sample, resize_bilinear, warp_image_by_flow)
from .ops import reg_dist_filter_plain as reg_dist_filter

LEVELS = (2, 3, 4, 5, 6)
# per-level constants, indexed by pyramid level 2..6
_FLOW_SCALE = {2: 10.0, 3: 5.0, 4: 2.5, 5: 1.25, 6: 0.625}
_LEVEL_KERNEL = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}
_DIST_CH = {2: 49, 3: 25, 4: 25, 5: 9, 6: 9}
_FEAT_CH = {1: 32, 2: 32, 3: 64, 4: 96, 5: 128, 6: 192}


def _conv(cin, cout, k, stride=1, device=None):
    """Conv with 'same'-style padding; stride-1 convs with Cout <= 4 run on
    the head-conv op."""
    if cout <= 4 and stride == 1:
        return HeadConv(cin, cout, k, device=device)
    return Conv2d(cin, cout, k, stride, (k - 1) // 2, device=device)


def _leaky(x):
    return torch.nn.functional.leaky_relu(x, 0.1)


def _deconv2x(channels, device=None):
    """Per-channel 4x4 stride-2 transposed conv (groups == channels)."""
    return ConvTranspose2d(channels, channels, 4, 2, 1, groups=channels,
                           bias=False, device=device)


def _trunk(channels, head_k, device=None):
    """Conv stack ending in a flow-delta head: Sequential indices 0, 2, 4 ...
    are convs, the odd ones LeakyReLU, the last conv has no activation."""
    layers = []
    for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
        last = i == len(channels) - 2
        layers.append(_conv(cin, cout, head_k if last else 3, device=device))
        if not last:
            layers.append(nn.LeakyReLU(0.1))
    return nn.Sequential(*layers)


def _pair_refs(f):
    """M consecutive frames -> the 2(M-1) reference-side batch (forward pairs
    i->i+1 then backward pairs i+1->i): frames [0..M-2] then [1..M-1]."""
    return torch.cat([f[:-1], f[1:]], dim=0)


def _pair_targets(f):
    """Target side of the forward+backward pairing: [1..M-1] then [0..M-2]."""
    return torch.cat([f[1:], f[:-1]], dim=0)


class Matching(nn.Module):
    def __init__(self, level, device=None):
        super().__init__()
        self.level = level
        if level == 2:
            self.moduleFeat = nn.Sequential(
                Conv2d(32, 64, 1, device=device), nn.LeakyReLU(0.1)
            )
        if level != 6:
            self.moduleUpflow = _deconv2x(2, device=device)
        if level < 4:
            self.moduleUpcorr = _deconv2x(49, device=device)
        self.moduleMain = _trunk((49, 128, 64, 32, 2), _LEVEL_KERNEL[level],
                                 device=device)

    def forward(self, feat1, feat2, flow, ids2=None):
        """``ids2`` enables the unique-frame form (consecutive pair mode):
        ``feat2`` holds the M unique frames and each warp maps the 2(M-1)
        output rows to source frames; at level 2 ``feat1`` is the unique
        array too and moduleFeat runs on M frames."""
        lvl = self.level
        if lvl == 2:
            if ids2 is not None:
                u = self.moduleFeat(feat1)
                feat1 = _pair_refs(u)
                feat2 = u
            else:
                feat1 = self.moduleFeat(feat1)
                feat2 = self.moduleFeat(feat2)
        if flow is not None:
            flow = self.moduleUpflow(flow)
        if lvl >= 4:
            if flow is not None:
                feat2 = warp_image_by_flow(
                    feat2, flow * _FLOW_SCALE[lvl], frame_ids=ids2
                )
            elif ids2 is not None:
                feat2 = _pair_targets(feat2)  # level 6: unwarped correlation
            corr = _leaky(correlation(feat1, feat2, 3, 1))
        else:
            # the stride-2 correlation reads only the phase-(0,0) subsample
            # of the warped map, so warp only those sites
            coords = flow_to_coords(flow * _FLOW_SCALE[lvl])[:, ::2, ::2]
            feat2_sub = grid_sample(feat2, coords, frame_ids=ids2)
            corr = _leaky(correlation(feat1[:, ::2, ::2], feat2_sub, 3, 1))
            corr = self.moduleUpcorr(corr)
        delta = self.moduleMain(corr)
        return delta if flow is None else flow + delta


class Subpixel(nn.Module):
    def __init__(self, level, device=None):
        super().__init__()
        self.level = level
        if level == 2:
            self.moduleFeat = nn.Sequential(
                Conv2d(32, 64, 1, device=device), nn.LeakyReLU(0.1)
            )
        feat = 64 if level == 2 else _FEAT_CH[level]
        self.moduleMain = _trunk((2 * feat + 2, 128, 64, 32, 2),
                                 _LEVEL_KERNEL[level], device=device)

    def forward(self, feat1, feat2, flow, ids2=None):
        lvl = self.level
        if lvl == 2:
            if ids2 is not None:
                u = self.moduleFeat(feat1)
                feat1 = _pair_refs(u)
                feat2 = u
            else:
                feat1 = self.moduleFeat(feat1)
                feat2 = self.moduleFeat(feat2)
        feat2 = warp_image_by_flow(feat2, flow * _FLOW_SCALE[lvl], frame_ids=ids2)
        x = torch.cat([feat1, feat2, flow], dim=-1)
        return flow + self.moduleMain(x)


class Regularization(nn.Module):
    def __init__(self, level, device=None):
        super().__init__()
        self.level = level
        k = _LEVEL_KERNEL[level]
        dist_ch = _DIST_CH[level]
        if level < 5:
            self.moduleFeat = nn.Sequential(
                Conv2d(_FEAT_CH[level], 128, 1, device=device), nn.LeakyReLU(0.1)
            )
        feat = 128 if level < 6 else _FEAT_CH[6]
        chans = (feat + 3, 128, 128, 64, 64, 32, 32)
        layers = []
        for cin, cout in zip(chans[:-1], chans[1:]):
            layers += [Conv2d(cin, cout, 3, 1, 1, device=device), nn.LeakyReLU(0.1)]
        self.moduleMain = nn.Sequential(*layers)
        p = (k - 1) // 2
        if level >= 5:
            self.moduleDist = nn.Sequential(
                Conv2d(32, dist_ch, k, 1, p, device=device)
            )
        else:  # separable kx1 then 1xk
            self.moduleDist = nn.Sequential(
                Conv2d(32, dist_ch, (k, 1), 1, (p, 0), device=device),
                Conv2d(dist_ch, dist_ch, (1, k), 1, (0, p), device=device),
            )
        # 1x1 convs whose weights the regularization filter consumes directly
        self.moduleScaleX = Conv2d(dist_ch, 1, 1, device=device)
        self.moduleScaleY = Conv2d(dist_ch, 1, 1, device=device)

    def forward(self, img1, img2, feat1, flow, ids2=None):
        lvl = self.level
        diff = img1 - warp_image_by_flow(
            img2, flow * _FLOW_SCALE[lvl], frame_ids=ids2
        )
        diff = torch.sqrt(torch.sum(diff**2, dim=-1, keepdim=True) + 1e-6)
        if lvl < 5:
            feat1 = self.moduleFeat(feat1)
        flow_centered = flow - torch.mean(flow, dim=(1, 2), keepdim=True)
        x = self.moduleMain(torch.cat([diff, flow_centered, feat1], dim=-1))
        # the raw confidence; reg_dist_filter normalises it to
        # exp(-(dist²) - max(-(dist²))) and filters the flow with it
        dist = self.moduleDist(x)
        sx, sy = self.moduleScaleX, self.moduleScaleY
        return reg_dist_filter(
            dist, flow, sx.weight, sx.bias, sy.weight, sy.bias,
            _LEVEL_KERNEL[lvl],
        )


class Features(nn.Module):
    """6-level shared feature pyramid."""

    def __init__(self, device=None):
        super().__init__()

        def stage(*convs):
            layers = []
            for cin, cout, k, s in convs:
                layers += [Conv2d(cin, cout, k, s, (k - 1) // 2, device=device),
                           nn.LeakyReLU(0.1)]
            return nn.Sequential(*layers)

        self.moduleOne = stage((3, 32, 7, 1))
        self.moduleTwo = stage((32, 32, 3, 2), (32, 32, 3, 1), (32, 32, 3, 1))
        self.moduleThr = stage((32, 64, 3, 2), (64, 64, 3, 1))
        self.moduleFou = stage((64, 96, 3, 2), (96, 96, 3, 1))
        self.moduleFiv = stage((96, 128, 3, 2))
        self.moduleSix = stage((128, 192, 3, 2))

    def forward(self, x):
        f1 = self.moduleOne(x)
        f2 = self.moduleTwo(f1)
        f3 = self.moduleThr(f2)
        f4 = self.moduleFou(f3)
        f5 = self.moduleFiv(f4)
        f6 = self.moduleSix(f5)
        return [f1, f2, f3, f4, f5, f6]


class LiteFlowNet(nn.Module):
    """Full coarse-to-fine flow network.

    Call with two [N x H x W x 3] images (H, W divisible by 32, intensities
    [0, 1]); returns {1: [N x H/4 x W/4 x 2], ..., 5: [N x H/64 x W/64 x 2]}
    flows in full-resolution pixel units.
    """

    def __init__(self, device=None):
        super().__init__()
        self.moduleFeatures = Features(device=device)
        self.moduleMatching = nn.ModuleList(Matching(l, device) for l in LEVELS)
        self.moduleSubpixel = nn.ModuleList(Subpixel(l, device) for l in LEVELS)
        self.moduleRegularization = nn.ModuleList(
            Regularization(l, device) for l in LEVELS
        )

    def forward(self, img1, img2, pair_mode="two"):
        """Pairing modes (same flows; they only change how the shared
        feature pass is amortised):

        * ``two``: independent img1/img2 batches.
        * ``shared``: img2 == img1 with the batch axis reversed (the
          forward+backward inference pattern); features computed once.
        * ``consecutive``: img1 is a stack of M unique frames (img2 ignored);
          flows for all forward pairs (i -> i+1) then all backward pairs
          (i+1 -> i), output batch 2(M-1). Features are computed once for the
          M frames, and every warp gathers from the M unique frames through
          the frame map ``ids2``.
        """
        if pair_mode not in ("two", "shared", "consecutive"):
            raise ValueError(f"unknown pair_mode {pair_mode!r}")
        ids2 = None
        if pair_mode == "consecutive":
            m = img1.shape[0]
            # built on the device: a host tensor's upload would synchronise
            ids2 = torch.cat([torch.arange(1, m, device=img1.device),
                              torch.arange(0, m - 1, device=img1.device)])
            feats_all = self.moduleFeatures(img1)
            feats1 = [_pair_refs(f) for f in feats_all]
            feats2 = feats_all  # unique frames; warps map via ids2
            pyr = {1: img1}
            for lvl in range(2, 7):
                h, w = feats_all[lvl - 1].shape[1:3]
                pyr[lvl] = resize_bilinear(pyr[lvl - 1], h, w)
            imgs1 = {lvl: _pair_refs(p) for lvl, p in pyr.items()}
            imgs2 = pyr
        else:
            feats1 = self.moduleFeatures(img1)
            if pair_mode == "shared":
                feats2 = [f.flip(0) for f in feats1]
            else:
                feats2 = self.moduleFeatures(img2)
            imgs1 = {1: img1}
            imgs2 = {1: img2}
            for lvl in range(2, 7):
                h, w = feats1[lvl - 1].shape[1:3]
                imgs1[lvl] = resize_bilinear(imgs1[lvl - 1], h, w)
                imgs2[lvl] = (
                    imgs1[lvl].flip(0)
                    if pair_mode == "shared"
                    else resize_bilinear(imgs2[lvl - 1], h, w)
                )

        flow = None
        flows = {}
        for i in range(len(LEVELS) - 1, -1, -1):
            lvl = LEVELS[i]
            f1, f2 = feats1[lvl - 1], feats2[lvl - 1]
            # level-2 modules run moduleFeat on the raw features themselves;
            # hand them the unique array so the conv runs on M frames
            mf1 = feats_all[1] if lvl == 2 and ids2 is not None else f1
            flow = self.moduleMatching[i](mf1, f2, flow, ids2=ids2)
            flow = self.moduleSubpixel[i](mf1, f2, flow, ids2=ids2)
            flow = self.moduleRegularization[i](
                imgs1[lvl], imgs2[lvl], f1, flow, ids2=ids2
            )
            flows[lvl - 1] = flow
        return {i: flows[i] * (20.0 * 0.5**i) for i in flows}
