"""Deep-model frontend: depth + bidirectional flow (+ pose) inference.

Counterpart of ``dfvo_tpu/pipeline/frontend.py``. Images go in once;
geometry-ready float32 tensors come out on the same device. Network
variables are plain state dicts, passed to every call as in the JAX
package, and applied with ``torch.func.functional_call`` to module
templates that hold no weights of their own (built on the meta device).
Inference (``infer``, ``infer_chunk``) records no gradient; online
finetuning applies the networks with autograd through ``flow_apply`` and
``depth_apply``. With ``deep_pose.enable`` the pose CNN runs in ``infer``
on the pair (ref, cur) stacked on the channels.

The flow network is LiteFlowNet (``deep_flow.network: liteflow``, fed at
multiples of 32) or HD3 (``hd3``: ``HD3Net`` with the DLA-34 encoder and
HDA decoders, fed at multiples of 64). HD3's flow is its final level's
vector times 1/2^(7 - levels), at a quarter of the feed size, in that
size's pixels. In a chunk HD3 runs on the 2(M-1) forward and backward
pairs as two batches (``[0..M-2, 1..M-1]`` against ``[1..M-1, 0..M-2]``),
each image encoded once per pair it is in, as the JAX package computes it.

The depth network's skip connections need a height and width that are
multiples of 32. At any other size (the extended paper's 370x1226) the
JAX package's depth network fails. There the port feeds it at the flow
network's feed size (``flow_target_size``, the closest multiples of 32
with the best aspect match): the images are resized with
``align_corners=True``, the rule of the flow network's image feed, and
the scale-0 disparity back to the image size with
``align_corners=False``, as ``Monodepth2Depth`` resizes it. At multiples
of 32 nothing changes.
"""

import os

import torch
from torch.func import functional_call

from ..models import HD3Net, LiteFlowNet, Monodepth2Depth, Monodepth2Pose
from ..models.convert import hd3_checkpoint, init_state_dict, load_checkpoint
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
        meta = torch.device("meta")
        if self.flow_kind == "liteflow":
            self.flow_net = LiteFlowNet(device=meta)
            self.flow_feed = flow_target_size(self.h, self.w, 32)
        elif self.flow_kind == "hd3":
            self.flow_net = HD3Net(task="flow", encoder="dlaup", decoder="hda",
                                   corr_range=(4, 4, 4, 4, 4), context=False, device=meta)
            self.flow_feed = flow_target_size(self.h, self.w, 64)
        else:
            raise ValueError(f"unknown flow network: {self.flow_kind}")
        self.depth_net = Monodepth2Depth(**depth_kw, device=meta)
        self.depth_feed = (self.h, self.w)
        if self.h % 32 or self.w % 32:
            self.depth_feed = flow_target_size(self.h, self.w, 32)
        self.use_pose_net = bool(cfg.deep_pose.enable)
        self.pose_net = None
        if self.use_pose_net:
            self.pose_net = Monodepth2Pose(
                baseline_multiplier=depth_kw["baseline_multiplier"], device=meta)

    # -- parameters ---------------------------------------------------------
    def init_variables(self, generator):
        """Seeded random float32 variables on the CPU (no checkpoint); the
        pose CNN's, when enabled, are drawn after the others."""
        variables = {
            "depth": init_state_dict(self.depth_net, generator),
            "flow": init_state_dict(self.flow_net, generator),
        }
        if self.use_pose_net:
            variables["pose"] = init_state_dict(self.pose_net, generator)
        return variables

    def load_variables(self, generator):
        """Float32 variables on the CPU: the seeded init, with each network
        replaced by its checkpoint where the configured path holds one.

        Monodepth2 comes as the model zoo's ``encoder.pth`` and
        ``depth.pth`` in ``depth.deep_depth.pretrained_model``, the flow
        network as ``deep_flow.flow_net_weight`` (HD3's with its
        ``module.`` and ``hd3net.`` prefixes dropped), and the pose CNN
        (with ``deep_pose.enable``) as ``pose_encoder.pth`` and
        ``pose.pth`` in ``deep_pose.pretrained_model``; all load straight
        into the modules' parameter names.
        """
        variables = self.init_variables(generator)
        depth_dir = str(self.cfg.depth.deep_depth.pretrained_model or "")
        enc = os.path.join(depth_dir, "encoder.pth")
        dec = os.path.join(depth_dir, "depth.pth")
        if os.path.isfile(enc) and os.path.isfile(dec):
            sd = {"encoder." + k: v for k, v in load_checkpoint(enc).items()}
            sd.update({"decoder." + k: v for k, v in load_checkpoint(dec).items()})
            variables["depth"] = _match_template(sd, variables["depth"], depth_dir)
            print(f"==> Initialize Depth-CNN with [{depth_dir}]")
        flow_path = str(self.cfg.deep_flow.flow_net_weight or "")
        if os.path.isfile(flow_path):
            read = hd3_checkpoint if self.flow_kind == "hd3" else load_checkpoint
            variables["flow"] = _match_template(read(flow_path), variables["flow"], flow_path)
            print(f"==> Initialize {self.flow_kind} flow net with [{flow_path}]")
        if self.use_pose_net:
            pose_dir = str(self.cfg.deep_pose.pretrained_model or "")
            enc = os.path.join(pose_dir, "pose_encoder.pth")
            dec = os.path.join(pose_dir, "pose.pth")
            if os.path.isfile(enc) and os.path.isfile(dec):
                sd = {"encoder." + k: v for k, v in load_checkpoint(enc).items()}
                sd.update({"decoder." + k: v for k, v in load_checkpoint(dec).items()})
                variables["pose"] = _match_template(sd, variables["pose"], pose_dir)
                print(f"==> Initialize Pose-CNN with [{pose_dir}]")
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
        """The flow network on two independent [N x H x W x 3] batches, with
        autograd: {1..5} flows in float32. LiteFlowNet's (``pair_mode=
        "two"``) are its pyramid; HD3 gives its one flow under every key,
        as the reference's HD3 does for the finetuning scales."""
        if self.flow_kind == "hd3":
            flow = self._hd3(flow_vars, img1, img2)
            return {s: flow for s in range(1, 6)}
        flows = functional_call(self.flow_net, flow_vars, (img1, img2), {"pair_mode": "two"},
                                strict=True)
        return {s: f.float() for s, f in flows.items()}

    def _hd3(self, flow_vars, img1, img2):
        """HD3's flow: the final level's vector x 1/2^(7 - levels), in
        float32."""
        _, ms_vect = functional_call(self.flow_net, flow_vars, (img1, img2), strict=True)
        return ms_vect[-1].float() * (1.0 / 2 ** (7 - len(ms_vect)))

    def depth_apply(self, depth_vars, imgs):
        """Monodepth2 on [N x H x W x 3] images, with autograd: the
        network's output dict (``depth``, ``disp`` at H x W, ``disps``
        {0..3} at the feed size)."""
        return functional_call(self.depth_net, depth_vars, (self._depth_feed(imgs),),
                               {"out_hw": (self.h, self.w)}, strict=True)

    def pose_apply(self, pose_vars, img_ref, img_cur):
        """The pose CNN on [N x H x W x 3] pairs (ref, cur): [N x 4 x 4]
        poses in the images' dtype."""
        return functional_call(self.pose_net, pose_vars,
                               (torch.cat([img_ref, img_cur], dim=-1),), strict=True)

    def _depth_feed(self, imgs):
        """Images at the depth network's feed size (resized as the flow
        network's feed is)."""
        fh, fw = self.depth_feed
        if (fh, fw) == tuple(imgs.shape[1:3]):
            return imgs
        return resize_bilinear(imgs, fh, fw, align_corners=True)

    def _depth(self, variables, imgs):
        out = functional_call(self.depth_net, variables["depth"], (self._depth_feed(imgs),),
                              {"out_hw": tuple(imgs.shape[1:3])}, strict=True)
        return out["depth"].float()

    def _flow(self, variables, img1, img2, pair_mode):
        """LiteFlowNet's finest flow in ``pair_mode``, or HD3's flow of the
        pairs (img1[i], img2[i])."""
        if self.flow_kind == "hd3":
            return self._hd3(variables["flow"], img1, img2)
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
        (LiteFlowNet ``consecutive`` mode; HD3 on the forward and backward
        pairs).

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
        if self.flow_kind == "hd3":
            flow_feed_res = self._flow(variables, torch.cat([feed[:-1], feed[1:]]),
                                       torch.cat([feed[1:], feed[:-1]]), None)
        else:
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
            ``flow_bwd`` [H x W x 2], ``flow_diff`` [H x W], and with the
            pose CNN ``deep_pose`` [4 x 4] (float32).
        """
        img_cur = img_cur[None].to(self.dtype)
        img_ref = img_ref[None].to(self.dtype)
        if depth_cur is None:
            depth_cur = self._depth(variables, img_cur)[0]
        else:
            depth_cur = depth_cur.float()

        # batched forward+backward; img2 is img1 with the batch flipped, so
        # LiteFlowNet shares the feature pass (HD3 encodes all four)
        img1 = torch.cat([img_ref, img_cur], dim=0)
        img2 = torch.cat([img_cur, img_ref], dim=0)
        th, tw = self.flow_feed
        if (th, tw) != (self.h, self.w):
            img1 = resize_bilinear(img1, th, tw, align_corners=True)
            img2 = resize_bilinear(img2, th, tw, align_corners=True)
        flow_feed_res = self._flow(variables, img1, img2, "shared")

        flow_full = resize_dense_flow(flow_feed_res, self.h, self.w)
        flow_diff = self._consistency(flow_feed_res[0:1], flow_feed_res[1:2])
        out = {
            "depth_cur": depth_cur,
            "flow_fwd": flow_full[0],
            "flow_bwd": flow_full[1],
            "flow_diff": flow_diff[0],
        }
        if self.use_pose_net:
            out["deep_pose"] = self.pose_apply(variables["pose"], img_ref, img_cur)[0].float()
        return out
