"""Deep-model frontend: depth + bidirectional flow inference.

Counterpart of ``dfvo_tpu/pipeline/frontend.py``. Images go in once;
geometry-ready float32 tensors come out on the same device. Network
variables are plain state dicts, passed to every call as in the JAX
package, and applied with ``torch.func.functional_call`` to module
templates that hold no weights of their own (built on the meta device).
Inference (``infer``, ``infer_chunk``) records no gradient; online
finetuning applies the networks with autograd through ``flow_apply`` and
``depth_apply``.
"""

import os

import torch
from torch.func import functional_call

from ..models import LiteFlowNet, Monodepth2Depth
from ..models.convert import init_state_dict
from ..models.layers import resize_bilinear
from ..ops.warp import flow_to_coords, grid_sample


def flow_target_size(h, w, divisor):
    """Closest (th, tw) divisible by ``divisor`` with the best aspect-ratio
    match."""
    hs = [divisor * (h // divisor), divisor * (h // divisor + 1)]
    ws = [divisor * (w // divisor), divisor * (w // divisor + 1)]
    best = None
    for th in hs:
        for tw in ws:
            if th == 0 or tw == 0:
                continue
            ratio = abs(th / tw - h / w)
            if best is None or ratio < best[0]:
                best = (ratio, th, tw)
    return best[1], best[2]


def forward_backward_consistency(flow_fwd, flow_bwd):
    """Flow inconsistency map |flow_fwd - warp(-flow_bwd)| per pixel.

    Args:
        flow_fwd: [N x H x W x 2] forward flow (view1 -> view2).
        flow_bwd: [N x H x W x 2] backward flow.

    Returns:
        [N x H x W] inconsistency norm.
    """
    coords = flow_to_coords(flow_fwd)
    warped = grid_sample(-flow_bwd, coords, padding_mode="zeros")
    return torch.linalg.norm(flow_fwd - warped, dim=-1)


def _scale_xy(flow, sx, sy):
    """[x, y] vectors scaled per component by Python numbers (a device
    tensor of the two would be a blocking host-to-device copy per call)."""
    return torch.stack((flow[..., 0] * sx, flow[..., 1] * sy), dim=-1)


def resize_dense_flow(flow, out_h, out_w):
    """Bilinear flow resize (align_corners=True) with magnitude rescaling."""
    _, h, w, _ = flow.shape
    resized = resize_bilinear(flow, out_h, out_w, align_corners=True)
    return _scale_xy(resized, out_w / w, out_h / h)


def _load_checkpoint(path):
    """A torch checkpoint's tensors as float32 CPU tensors ("module."
    prefixes of data-parallel saves dropped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    return {k.removeprefix("module."): v.float() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def _match_template(sd, template, source):
    """The checkpoint's entries for every key of ``template``, shapes
    checked; entries the port's modules do not have (the encoder's
    classifier) are left out."""
    missing = sorted(k for k in template if k not in sd)
    bad = sorted(k for k in template if k in sd and sd[k].shape != template[k].shape)
    if missing or bad:
        raise ValueError(f"{source}: missing {missing[:5]} ({len(missing)}), "
                         f"shape mismatch {bad[:5]} ({len(bad)})")
    return {k: sd[k] for k in template}


class DeepFrontend:
    """Owns the network templates and the inference functions."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.h = cfg.image.height
        self.w = cfg.image.width
        # network compute dtype; geometry always runs float32
        tpu_cfg = cfg.get("tpu", {})
        self.dtype = (
            torch.bfloat16
            if str(tpu_cfg.get("dtype", "float32")) == "bfloat16"
            else torch.float32
        )
        dataset = cfg.dataset
        if "tum" in dataset and not ("kitti" in dataset or "robotcar" in dataset):
            depth_kw = dict(min_depth=0.1, max_depth=10.0, baseline_multiplier=1.0)
        else:
            depth_kw = dict(min_depth=0.1, max_depth=100.0, baseline_multiplier=5.4)
        self.depth_kw = depth_kw
        self.flow_kind = cfg.deep_flow.network
        if self.flow_kind == "hd3":
            raise NotImplementedError(
                "deep_flow.network: hd3 is not ported yet "
                "(ROADMAP queue 1, item 'HD3')"
            )
        if self.flow_kind != "liteflow":
            raise ValueError(f"unknown flow network: {self.flow_kind}")
        if bool(cfg.deep_pose.enable):
            raise NotImplementedError(
                "deep_pose.enable is not ported yet (ROADMAP queue 1, item "
                "'Deep pose and the optional keypoint filters')"
            )
        meta = torch.device("meta")
        self.depth_net = Monodepth2Depth(**depth_kw, device=meta)
        self.flow_net = LiteFlowNet(device=meta)
        self.flow_feed = flow_target_size(self.h, self.w, 32)

    # -- parameters ---------------------------------------------------------
    def init_variables(self, generator):
        """Seeded random float32 variables on the CPU (no checkpoint)."""
        return {
            "depth": init_state_dict(self.depth_net, generator),
            "flow": init_state_dict(self.flow_net, generator),
        }

    def load_variables(self, generator):
        """Float32 variables on the CPU: the seeded init, with each network
        replaced by its checkpoint where the configured path holds one.

        Monodepth2 comes as the model zoo's ``encoder.pth`` and
        ``depth.pth`` in ``depth.deep_depth.pretrained_model``, LiteFlowNet
        as ``deep_flow.flow_net_weight``; both load straight into the
        modules' parameter names.
        """
        variables = self.init_variables(generator)
        depth_dir = str(self.cfg.depth.deep_depth.pretrained_model or "")
        enc = os.path.join(depth_dir, "encoder.pth")
        dec = os.path.join(depth_dir, "depth.pth")
        if os.path.isfile(enc) and os.path.isfile(dec):
            sd = {"encoder." + k: v for k, v in _load_checkpoint(enc).items()}
            sd.update({"decoder." + k: v for k, v in _load_checkpoint(dec).items()})
            variables["depth"] = _match_template(sd, variables["depth"], depth_dir)
            print(f"==> Initialize Depth-CNN with [{depth_dir}]")
        flow_path = str(self.cfg.deep_flow.flow_net_weight or "")
        if os.path.isfile(flow_path):
            variables["flow"] = _match_template(_load_checkpoint(flow_path),
                                                variables["flow"], flow_path)
            print(f"==> Initialize {self.flow_kind} flow net with [{flow_path}]")
        return variables

    def trainable_keys(self, net):
        """The keys of ``net``'s ("depth" or "flow") parameters: the tensors
        that the JAX package keeps in its Flax ``params`` collection; the
        batch-norm running statistics are buffers and are left out."""
        module = {"depth": self.depth_net, "flow": self.flow_net}[net]
        return [k for k, _ in module.named_parameters()]

    @torch.no_grad()
    def prepare_variables(self, variables):
        """The inference copy of the variables: on the device, float32
        tensors cast to the network dtype, none requiring grad. After
        loading, and after each finetuning update (from masters already on
        the device, without a host round trip; a float32 master is shared,
        not copied)."""

        def prep(t):
            if t.dtype == torch.float32:
                t = t.to(self.dtype)
            return t.to(self.device).detach()

        return {
            net: {k: prep(v) for k, v in sd.items()}
            for net, sd in variables.items()
        }

    def flow_apply(self, flow_vars, img1, img2):
        """LiteFlowNet on two independent [N x H x W x 3] batches
        (``pair_mode="two"``), with autograd: {1..5} flows in float32."""
        flows = functional_call(self.flow_net, flow_vars, (img1, img2), {"pair_mode": "two"},
                                strict=True)
        return {s: f.float() for s, f in flows.items()}

    def depth_apply(self, depth_vars, imgs):
        """Monodepth2 on [N x H x W x 3] images, with autograd: the
        network's output dict (``depth``, ``disp``, ``disps`` {0..3})."""
        return functional_call(self.depth_net, depth_vars, (imgs,), strict=True)

    def _depth(self, variables, imgs):
        out = functional_call(self.depth_net, variables["depth"], (imgs,),
                              strict=True)
        return out["depth"].float()

    def _flow(self, variables, img1, img2, pair_mode):
        flows = functional_call(self.flow_net, variables["flow"],
                                (img1, img2), {"pair_mode": pair_mode},
                                strict=True)
        return flows[1].float()

    def _consistency(self, f_fwd_n, f_bwd_n):
        """Forward-backward inconsistency at the flow's native resolution,
        in full-resolution pixels, bilinearly upsampled to [N x H x W]."""
        hn, wn = f_fwd_n.shape[1], f_fwd_n.shape[2]
        warp = grid_sample(
            -f_bwd_n, flow_to_coords(f_fwd_n), padding_mode="zeros"
        )
        diff_n = torch.linalg.norm(
            _scale_xy(f_fwd_n - warp, self.w / wn, self.h / hn), dim=-1, keepdim=True
        )
        return resize_bilinear(diff_n, self.h, self.w, align_corners=True)[..., 0]

    # -- batched chunk inference ---------------------------------------------
    @torch.no_grad()
    def infer_chunk(self, variables, all_imgs):
        """Network inference for a whole frame chunk in one batch
        (LiteFlowNet ``consecutive`` mode).

        Args:
            variables: prepared network variables.
            all_imgs: [M x H x W x 3] float images in [0, 1]: M-1
                consecutive pairs (i -> i+1).

        Returns:
            dict with ``depths`` [M-1 x H x W] (raw metric depth of frames
            1..M-1), ``flow_fwd`` [M-1 x H x W x 2], ``flow_diff``
            [M-1 x H x W].
        """
        m = all_imgs.shape[0]
        imgs_net = all_imgs.to(self.dtype)
        depths = self._depth(variables, imgs_net[1:])

        th, tw = self.flow_feed
        feed = imgs_net
        if (th, tw) != (self.h, self.w):
            feed = resize_bilinear(imgs_net, th, tw, align_corners=True)
        flow_feed_res = self._flow(variables, feed, feed, "consecutive")

        f_fwd_n = flow_feed_res[: m - 1]
        f_bwd_n = flow_feed_res[m - 1 :]
        return {
            "depths": depths,
            "flow_fwd": resize_dense_flow(f_fwd_n, self.h, self.w),
            "flow_diff": self._consistency(f_fwd_n, f_bwd_n),
        }

    # -- per-frame inference --------------------------------------------------
    @torch.no_grad()
    def infer(self, variables, img_cur, img_ref, depth_cur=None):
        """Depth of the current view + bidirectional flow ref <-> cur.

        Args:
            variables: prepared network variables.
            img_cur, img_ref: [H x W x 3] float images in [0, 1].
            depth_cur: optional [H x W] externally supplied raw depth; when
                given, the depth network is skipped.

        Returns:
            dict with ``depth_cur`` [H x W] (raw metric depth),
            ``flow_fwd`` [H x W x 2] (ref -> cur, full-res pixels),
            ``flow_bwd`` [H x W x 2] and ``flow_diff`` [H x W].
        """
        img_cur = img_cur[None].to(self.dtype)
        img_ref = img_ref[None].to(self.dtype)
        if depth_cur is None:
            depth_cur = self._depth(variables, img_cur)[0]
        else:
            depth_cur = depth_cur.float()

        # batched forward+backward; img2 is img1 with the batch flipped, so
        # LiteFlowNet shares the feature pass
        img1 = torch.cat([img_ref, img_cur], dim=0)
        img2 = torch.cat([img_cur, img_ref], dim=0)
        th, tw = self.flow_feed
        if (th, tw) != (self.h, self.w):
            img1 = resize_bilinear(img1, th, tw, align_corners=True)
            img2 = resize_bilinear(img2, th, tw, align_corners=True)
        flow_feed_res = self._flow(variables, img1, img2, "shared")

        flow_full = resize_dense_flow(flow_feed_res, self.h, self.w)
        flow_diff = self._consistency(flow_feed_res[0:1], flow_feed_res[1:2])
        return {
            "depth_cur": depth_cur,
            "flow_fwd": flow_full[0],
            "flow_bwd": flow_full[1],
            "flow_diff": flow_diff[0],
        }
