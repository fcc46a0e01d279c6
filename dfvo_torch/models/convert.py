"""Parameter bridge from the JAX package, and a seeded random init.

``*_from_flax`` take the Flax variable trees of ``dfvo_tpu`` (as numpy
arrays) and return this package's state dicts: the inverse of
``dfvo_tpu/models/convert.py``. Conv kernels go HWIO -> OIHW; the depthwise
deconv kernels, which the JAX package stores spatially flipped as a dilated
correlation, go back to ``ConvTranspose2d(C, C, 4, 2, 1, groups=C)`` form;
batch-norm ``params`` and ``batch_stats`` both carry over. The bridge lets
the two packages compute from the same weights.

``hd3_from_flax`` maps the JAX package's HD3 tree by name: the port's
modules carry the reference torch network's names, whose Sequential
indices the Flax names merge into ``_i`` suffixes; ``hd3_checkpoint``
reads the model zoo's HD3 checkpoint into those names.

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


def monodepth2_pose_from_flax(variables):
    """Flax ``Monodepth2Pose`` variables -> ``models.Monodepth2Pose`` state
    dict (the decoder's squeeze, pose_0, pose_1, pose_2 as ``net.0..3``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = resnet_encoder_from_flax(params["encoder"], stats["encoder"])
    for i, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        _conv(sd, f"decoder.net.{i}", params["decoder"][name])
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


def _merge_path(key):
    """A torch module path -> the Flax path components: Sequential indices
    merge into the parent name (``base_layer.0`` -> ``base_layer_0``)."""
    parts = []
    for comp in key.split("."):
        if comp.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{comp}"
        else:
            parts.append(comp)
    return parts


def _hd3_config(params):
    """The ``HD3Net`` options that built a Flax HD3 ``params`` tree."""
    levels = sum(1 for k in params if k.startswith("Decoder_"))
    last = params[f"Decoder_{levels - 1}"]
    context = "dc_conv_0_0" in last
    classes = []
    for l in range(levels):
        dec = params[f"Decoder_{l}"]
        classes.append(int(np.shape(dec["cls_2" if "cls_2" in dec else "cls"]["kernel"])[-1]))
    # the flow cost volume keeps all 81 channels, the stereo one a row of it
    task = "flow" if np.shape(params["cost_bn_0"]["scale"])[0] == 81 else "stereo"
    if task == "flow":
        corr_range = tuple(int(round(math.sqrt(c))) // 2 for c in classes)
    else:
        corr_range = tuple(c // 2 for c in classes)
    return dict(task=task, encoder="vgg" if "block_0_conv1" in params["encoder"] else "dlaup",
                decoder="hda" if "root_0" in params["Decoder_0"]["mapping"] else "resnet",
                corr_range=corr_range, context=context)


def hd3_from_flax(variables):
    """Flax ``HD3Net`` variables (any task, encoder, decoder and context)
    -> ``models.hd3.HD3Net`` state dict. Conv kernels go HWIO -> OIHW; the
    transposed convolutions, which the JAX package stores flipped as
    dilated correlations, go back to ``ConvTranspose2d`` form (depthwise
    ``up_i``: (k, k, 1, C) -> (C, 1, k, k); ``Decoder_l.up.2``: (k, k, Cin,
    Cout) -> (Cin, Cout, k, k))."""
    from .hd3 import HD3Net

    params, stats = variables["params"], variables.get("batch_stats", {})
    net = HD3Net(**_hd3_config(params), device=torch.device("meta"))
    bn = {name for name, m in net.named_modules() if isinstance(m, FrozenBatchNorm)}
    deconv = {name for name, m in net.named_modules() if isinstance(m, nn.ConvTranspose2d)}

    def leaf(tree, path, name):
        for comp in path:
            tree = tree[comp]
        return np.asarray(tree[name])

    sd = {}
    for key in net.state_dict():
        mod, name = key.rsplit(".", 1)
        path = _merge_path(mod)
        if mod in bn:
            src = {"weight": (params, "scale"), "bias": (params, "bias"),
                   "running_mean": (stats, "mean"), "running_var": (stats, "var")}[name]
            sd[key] = _t(leaf(src[0], path, src[1]))
        elif name == "bias":
            sd[key] = _t(leaf(params, path, "bias"))
        elif mod in deconv:
            k = leaf(params, path, "kernel")[::-1, ::-1]
            grouped = net.get_submodule(mod).groups > 1
            sd[key] = _t(k.transpose(3, 2, 0, 1) if grouped else k.transpose(2, 3, 0, 1))
        else:
            sd[key] = conv_from_flax(leaf(params, path, "kernel"))
    return sd


def load_checkpoint(path):
    """A torch checkpoint's tensors (a state dict, or a dict holding one
    under ``state_dict``) as float32 CPU tensors, the ``module.`` prefix of
    a data-parallel save dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    return {k.removeprefix("module."): v.float() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def hd3_checkpoint(path):
    """The model zoo's HD3 checkpoint under ``models.hd3.HD3Net``'s names:
    ``load_checkpoint`` with the ``hd3net.`` prefix of the reference's
    HD3Model wrapper dropped too (the JAX package's ``convert_hd3``)."""
    return {k.removeprefix("hd3net."): v for k, v in load_checkpoint(path).items()}


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
