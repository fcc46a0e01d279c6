"""Parameter bridge from the JAX package, and a seeded random init.

``*_from_flax`` take the Flax variable trees of ``dfvo_tpu`` (as numpy
arrays) and return this package's state dicts: the inverse of
``dfvo_tpu/models/convert.py``. Conv kernels go HWIO -> OIHW; the depthwise
deconv kernels, which the JAX package stores spatially flipped as a dilated
correlation, go back to ``ConvTranspose2d(C, C, 4, 2, 1, groups=C)`` form;
batch-norm ``params`` and ``batch_stats`` both carry over. The bridge lets
the two packages compute from the same weights.

``init_state_dict`` draws a module's parameters from a ``torch.Generator``
with the JAX package's initialisers (lecun-normal convs, normal(0.02)
deconvs, zero biases, identity batch norm), for runs without checkpoints.
"""

import math

import numpy as np
import torch
import torch.nn as nn

from .layers import FrozenBatchNorm, HeadConv

_DEC_ORDER = [(4, 0), (4, 1), (3, 0), (3, 1), (2, 0), (2, 1), (1, 0), (1, 1),
              (0, 0), (0, 1)]

_LFN_FEATURES = {
    "one_0": "moduleOne.0",
    "two_0": "moduleTwo.0",
    "two_1": "moduleTwo.2",
    "two_2": "moduleTwo.4",
    "thr_0": "moduleThr.0",
    "thr_1": "moduleThr.2",
    "fou_0": "moduleFou.0",
    "fou_1": "moduleFou.2",
    "fiv_0": "moduleFiv.0",
    "six_0": "moduleSix.0",
}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def conv_from_flax(kernel):
    """HWIO -> OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def deconv_from_flax(kernel):
    """Flipped (kH, kW, 1, C) correlation kernel -> ConvTranspose2d (C, 1, kH, kW)."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1)[:, :, ::-1, ::-1])


def _conv(sd, key, entry):
    sd[f"{key}.weight"] = conv_from_flax(entry["kernel"])
    if "bias" in entry:
        sd[f"{key}.bias"] = _t(entry["bias"])


def _bn(sd, key, params, stats):
    sd[f"{key}.weight"] = _t(params["scale"])
    sd[f"{key}.bias"] = _t(params["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])


def resnet_encoder_from_flax(params, stats):
    prefix = "encoder.encoder."
    sd = {}
    _conv(sd, prefix + "conv1", params["conv1"])
    _bn(sd, prefix + "bn1", params["bn1"], stats["bn1"])
    for stage in range(1, 5):
        b = 0
        while f"layer{stage}_{b}" in params:
            name = f"layer{stage}_{b}"
            p, s = params[name], stats[name]
            key = f"{prefix}layer{stage}.{b}"
            _conv(sd, f"{key}.conv1", p["conv1"])
            _bn(sd, f"{key}.bn1", p["bn1"], s["bn1"])
            _conv(sd, f"{key}.conv2", p["conv2"])
            _bn(sd, f"{key}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                _conv(sd, f"{key}.downsample.0", p["downsample_conv"])
                _bn(sd, f"{key}.downsample.1", p["downsample_bn"],
                    s["downsample_bn"])
            b += 1
    return sd


def depth_decoder_from_flax(params):
    prefix = "decoder.decoder."
    sd = {}
    for idx, (i, j) in enumerate(_DEC_ORDER):
        _conv(sd, f"{prefix}{idx}.conv.conv", params[f"upconv_{i}_{j}"]["conv"]["conv"])
    for s in range(4):
        _conv(sd, f"{prefix}{10 + s}.conv", params[f"dispconv_{s}"]["conv"])
    return sd


def monodepth2_depth_from_flax(variables):
    """Flax ``Monodepth2Depth`` variables -> ``models.Monodepth2Depth`` state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = resnet_encoder_from_flax(params["encoder"], stats["encoder"])
    sd.update(depth_decoder_from_flax(params["decoder"]))
    return sd


def liteflownet_from_flax(variables):
    """Flax ``LiteFlowNet`` variables -> ``models.LiteFlowNet`` state dict."""
    params = variables["params"]
    sd = {}
    for ours, theirs in _LFN_FEATURES.items():
        _conv(sd, f"moduleFeatures.{theirs}", params["features"][ours])
    for i, lvl in enumerate([2, 3, 4, 5, 6]):
        m = params[f"matching_{lvl}"]
        if lvl == 2:
            _conv(sd, f"moduleMatching.{i}.moduleFeat.0", m["feat_conv"])
        if lvl != 6:
            sd[f"moduleMatching.{i}.moduleUpflow.weight"] = deconv_from_flax(
                m["upflow"]["kernel"]
            )
        if lvl < 4:
            sd[f"moduleMatching.{i}.moduleUpcorr.weight"] = deconv_from_flax(
                m["upcorr"]["kernel"]
            )
        for j, t in enumerate([0, 2, 4, 6]):
            _conv(sd, f"moduleMatching.{i}.moduleMain.{t}", m[f"main_{j}"])

        s = params[f"subpixel_{lvl}"]
        if lvl == 2:
            _conv(sd, f"moduleSubpixel.{i}.moduleFeat.0", s["feat_conv"])
        for j, t in enumerate([0, 2, 4, 6]):
            _conv(sd, f"moduleSubpixel.{i}.moduleMain.{t}", s[f"main_{j}"])

        r = params[f"regularization_{lvl}"]
        key = f"moduleRegularization.{i}"
        if lvl < 5:
            _conv(sd, f"{key}.moduleFeat.0", r["feat_conv"])
        for j, t in enumerate([0, 2, 4, 6, 8, 10]):
            _conv(sd, f"{key}.moduleMain.{t}", r[f"main_{j}"])
        if lvl >= 5:
            _conv(sd, f"{key}.moduleDist.0", r["dist"])
        else:
            _conv(sd, f"{key}.moduleDist.0", r["dist_ver"])
            _conv(sd, f"{key}.moduleDist.1", r["dist_hor"])
        _conv(sd, f"{key}.moduleScaleX", r["scale_x"])
        _conv(sd, f"{key}.moduleScaleY", r["scale_y"])
    return sd


def init_state_dict(module, generator):
    """Seeded random state dict for ``module`` (float32, on the CPU).

    Conv weights are lecun-normal (std 1/sqrt(fan_in)), transposed-conv
    weights normal(0.02), biases zero, batch norm the identity: the JAX
    package's initialisers. Tensors are drawn in ``named_modules`` order, so
    one generator seed always gives the same weights.
    """
    sd = {}
    for name, mod in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.ConvTranspose2d):
            w = mod.weight
            sd[pre + "weight"] = 0.02 * torch.randn(
                w.shape, generator=generator
            )
        elif isinstance(mod, (nn.Conv2d, HeadConv)):
            w = mod.weight
            fan_in = math.prod(w.shape[1:])
            sd[pre + "weight"] = torch.randn(
                w.shape, generator=generator
            ) / math.sqrt(fan_in)
        elif isinstance(mod, FrozenBatchNorm):
            c = mod.weight.shape[0]
            sd[pre + "weight"] = torch.ones(c)
            sd[pre + "running_mean"] = torch.zeros(c)
            sd[pre + "running_var"] = torch.ones(c)
        else:
            continue
        if getattr(mod, "bias", None) is not None:
            sd[pre + "bias"] = torch.zeros(mod.bias.shape)
    return sd
