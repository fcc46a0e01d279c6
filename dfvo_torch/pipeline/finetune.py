"""Online self-supervised finetuning of the flow and depth networks.

Counterpart of ``dfvo_tpu/pipeline/finetune.py``:

* flow: the multi-scale photometric warp loss (0.85 SSIM + 0.15 L1), the
  edge-aware smoothness of the mean-normalised flow magnitude in both
  directions, and forward-backward consistency, each of the last two
  scaled by 1/2^s;
* depth: photometric reprojection with the pose of ``depth.pose_src``
  (the DF-VO pose with its translation divided by the stereo baseline
  multiplier, the pose CNN's, or the DF-VO direction at the pose CNN's
  length), identity auto-masking (the per-pixel minimum with the unwarped
  loss), and normalised-disparity smoothness;
* one Adam step (``optax.adam``'s) over the enabled networks' parameters
  per frame pair, for ``num_frames`` pairs (None: no limit).

The networks run in float32 with autograd, through the kernels' autograd
Functions (``ops/kernel_grad.py``). The float32 masters live on the device
and are updated in place; the gradients, the loss and the Adam moments
never leave it, and the Adam step count lives on the host, so an update
reads nothing back.
"""

import torch

from ..geometry.ops import reproject
from ..models.layers import resize_bilinear
from ..models.monodepth2 import disp_to_depth
from ..ops.losses import reprojection_loss, smooth_loss
from ..ops.warp import flow_to_coords, grid_sample
from ..utils.device import upload
from .frontend import forward_backward_consistency, resize_dense_flow

def _with_t(T, t):
    """[B x 4 x 4] transforms T with their translations replaced by ``t``
    [B x 3]."""
    T = T.clone()
    T[:, :3, 3] = t
    return T


class Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, with bias
    correction, over {net: {key: tensor}} trees. ``update`` changes the
    parameters and the moments in place; the step count is a host int."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        def zeros():
            return {net: {k: torch.zeros_like(t) for k, t in sd.items()}
                    for net, sd in params.items()}

        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g²,
        p <- p - lr mu_hat / (sqrt(nu_hat) + eps), with mu_hat and nu_hat
        the bias-corrected moments of step ``count + 1``."""
        count = state["count"] + 1
        c1 = 1.0 - self.b1**count
        c2 = 1.0 - self.b2**count
        for net in params:
            keys = list(params[net])
            p = [params[net][k] for k in keys]
            g = [grads[net][k] for k in keys]
            mu = [state["mu"][net][k] for k in keys]
            nu = [state["nu"][net][k] for k in keys]
            torch._foreach_lerp_(mu, g, 1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            step = torch._foreach_div(mu, denom)
            torch._foreach_mul_(step, -self.lr / c1)
            torch._foreach_add_(p, step)
        state["count"] = count
        return state


class OnlineFinetuner:
    """The finetuning losses and the update steps of one DeepFrontend.

    Args:
        frontend: the DeepFrontend whose networks are finetuned.
        cfg: the merged configuration (``online_finetune``).
    """

    def __init__(self, frontend, cfg):
        self.frontend = frontend
        self.cfg = cfg
        self.ft_cfg = cfg.online_finetune
        self.lr = self.ft_cfg.lr
        self.num_frames = self.ft_cfg.num_frames
        self.train_flow = bool(self.ft_cfg.flow.enable)
        self.train_depth = bool(self.ft_cfg.depth.enable)
        # the depth loss's pose: the DF-VO pose in network units, or one of
        # the pose CNN's sources (deep_pose, DF-VO2), which need the pose CNN
        self.pose_src = self.ft_cfg.depth.get("pose_src") or "DF-VO"
        if self.pose_src not in ("DF-VO", "deep_pose", "DF-VO2"):
            raise ValueError(
                f"online_finetune.depth.pose_src: {self.pose_src!r} not in "
                "['DF-VO', 'deep_pose', 'DF-VO2']"
            )
        if (
            self.train_depth
            and self.pose_src != "DF-VO"
            and not getattr(frontend, "use_pose_net", False)
        ):
            raise ValueError(
                f"pose_src {self.pose_src!r} needs the pose CNN "
                "(deep_pose.enable: True)"
            )
        if self.train_flow and getattr(frontend, "flow_kind", "liteflow") not in (
            "liteflow",
            "hd3",
        ):
            raise ValueError(
                "online flow finetuning supports liteflow and hd3 "
                f"(got {frontend.flow_kind!r})"
            )
        self.optimizer = Adam(self.lr)
        self.update = self.make_update_fn()

    # -- loss pieces --------------------------------------------------------
    def flow_loss(self, flow_vars, img_ref, img_cur):
        """The flow loss over the configured scales, for [B x H x W x 3]
        images: the flow network on the B forward and B backward pairs as
        one batch of 2B. Every term is a mean over the batch, so the loss
        of B pairs is the mean of their B losses. LiteFlowNet gives a flow
        per scale; HD3 gives its one final-level flow under every scale, so
        for HD3 only the 1/2^s weights differ between the scales."""
        h, w = self.frontend.h, self.frontend.w
        b = img_ref.shape[0]
        img1 = torch.cat([img_ref, img_cur], dim=0)
        img2 = torch.cat([img_cur, img_ref], dim=0)
        th, tw = self.frontend.flow_feed
        if (th, tw) != (h, w):
            img1 = resize_bilinear(img1, th, tw, align_corners=True)
            img2 = resize_bilinear(img2, th, tw, align_corners=True)
        flows = self.frontend.flow_apply(flow_vars, img1, img2)

        w_cons = self.ft_cfg.flow.loss.flow_consistency
        w_smooth = self.ft_cfg.flow.loss.flow_smoothness
        scales = list(self.ft_cfg.flow.scales)

        total = 0.0
        for s in scales:
            flow_full = resize_dense_flow(flows[s], h, w)
            f_fwd, f_bwd = flow_full[:b], flow_full[b:]

            # photometric: the current image warped into the reference view
            warped = grid_sample(img_cur, flow_to_coords(f_fwd), padding_mode="border")
            loss = torch.mean(reprojection_loss(warped, img_ref))

            # edge-aware smoothness of the normalised flow magnitude, both ways
            for f, img in ((f_fwd, img_ref), (f_bwd, img_cur)):
                mag = torch.linalg.norm(f, dim=-1, keepdim=True)
                norm_flow = mag / (torch.mean(mag, dim=(1, 2), keepdim=True) + 1e-7)
                loss = loss + w_smooth * smooth_loss(norm_flow, img) / (2**s)

            diff = forward_backward_consistency(f_fwd, f_bwd)
            loss = loss + w_cons * torch.mean(diff) / (2**s)
            total = total + loss
        return total / len(scales)

    def depth_loss(self, depth_vars, img_ref, img_cur, poses_ref2cur):
        """The depth loss over the configured scales; ``poses_ref2cur`` is
        [B x 4 x 4]."""
        h, w = self.frontend.h, self.frontend.w
        out = self.frontend.depth_apply(depth_vars, img_ref)
        kw = self.frontend.depth_kw

        w_app = self.ft_cfg.depth.loss.apperance_loss
        w_ds = self.ft_cfg.depth.loss.disparity_smoothness
        scales = list(self.ft_cfg.depth.scales)

        total = 0.0
        for s in scales:
            disp = out["disps"][s]
            disp_full = resize_bilinear(disp, h, w, align_corners=False)
            _, depth = disp_to_depth(disp_full[..., 0], kw["min_depth"], kw["max_depth"])
            coords = reproject(depth, poses_ref2cur, self._K, self._K_inv)
            warped = grid_sample(img_cur, coords, padding_mode="border")
            reproj = reprojection_loss(warped, img_ref)
            identity = reprojection_loss(img_cur, img_ref)
            # identity auto-masking: the per-pixel minimum
            photo = torch.mean(torch.minimum(reproj, identity))

            mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
            norm_disp = disp / (mean_disp + 1e-7)
            smooth = smooth_loss(norm_disp, resize_bilinear(
                img_ref, disp.shape[1], disp.shape[2], align_corners=False))
            total = total + w_app * photo + w_ds * smooth / (2**s)
        return total / len(scales)

    def loss_fn(self, trainable, variables, img_ref, img_cur, poses):
        """The total finetuning loss of a batch of frame pairs ([B x H x W x 3]
        images, [B x 4 x 4] DF-VO poses); ``trainable`` replaces the
        networks' parameters in ``variables``."""
        merged = self._merge(variables, trainable)
        loss = 0.0
        if self.train_flow:
            loss = loss + self.flow_loss(merged["flow"], img_ref, img_cur)
        if self.train_depth:
            poses = self._depth_pose(variables, img_ref, img_cur, poses)
            loss = loss + self.depth_loss(merged["depth"], img_ref, img_cur, poses)
        return loss

    def _depth_pose(self, variables, img_ref, img_cur, poses):
        """The pose of the depth loss, per ``depth.pose_src``: 'DF-VO' the
        DF-VO pose with its metric translation back in network units,
        'deep_pose' the pose CNN's (on the float32 masters; not trained),
        'DF-VO2' the DF-VO translation's direction at the pose CNN's
        length."""
        if self.pose_src == "DF-VO":
            return _with_t(poses, poses[:, :3, 3] / self.frontend.depth_kw["baseline_multiplier"])
        with torch.no_grad():
            deep = self.frontend.pose_apply(variables["pose"], img_ref, img_cur).to(poses.dtype)
        if self.pose_src == "deep_pose":
            return deep
        deep_scale = torch.linalg.vector_norm(deep[:, :3, 3], dim=-1, keepdim=True)
        t = poses[:, :3, 3]
        t_unit = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
        return _with_t(poses, t_unit * deep_scale)

    # -- update -------------------------------------------------------------
    def value_and_grad(self, variables, img_ref, img_cur, poses):
        """(loss, grads {net: {key: tensor}}) of :meth:`loss_fn` at the
        trainable tensors of ``variables``. A parameter that the loss does
        not reach (a disparity head of an unused scale) gets zeros, as
        ``jax.grad`` gives it."""
        masters = self._trainable(variables)
        trainable = {net: {k: t.detach().requires_grad_(True) for k, t in sd.items()}
                     for net, sd in masters.items()}
        with torch.enable_grad():
            loss = self.loss_fn(trainable, variables, img_ref, img_cur, poses)
            leaves = [t for sd in trainable.values() for t in sd.values()]
            flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = {}
        for net, sd in trainable.items():
            grads[net] = {}
            for k, t in sd.items():
                g = next(flat)
                grads[net][k] = torch.zeros_like(t) if g is None else g
        return loss.detach(), grads

    def make_update_fn(self, axis_name=None):
        """The finetuning step ``update(variables, opt_state, img_ref,
        img_cur, pose) -> (variables, opt_state, loss)`` for [H x W x 3]
        float images and a [4 x 4] pose, all on the device. The parameters
        and the moments are updated in place.

        With ``axis_name`` (the JAX package's ``pmean`` over a mesh axis)
        the step takes S sequences' pairs, [S x H x W x 3] images and
        [S x 4 x 4] poses, and makes one Adam step on the mean of their S
        losses, whose gradient is the mean of the S per-sequence
        gradients; the networks run once on the batch of 2S images. One
        GPU holds every sequence, so the name only selects this form."""

        def update(variables, opt_state, img_ref, img_cur, pose):
            if axis_name is None:
                img_ref, img_cur, pose = img_ref[None], img_cur[None], pose[None]
            loss, grads = self.value_and_grad(variables, img_ref, img_cur, pose)
            opt_state = self.optimizer.update(grads, opt_state, self._trainable(variables))
            return variables, opt_state, loss

        return update

    def make_chunk_update_fn(self):
        """The chunk finetuning step of the scan execution: one Adam update
        per frame pair, in order, as the JAX package's ``lax.scan`` does.

        Signature: ``(variables, opt_state, imgs_u8 [T+1 x H x W x 3],
        poses [T x 4 x 4], n_active) -> (variables, opt_state, losses
        [T])``. Pair i is (frame i -> frame i+1); pairs from ``n_active`` (a
        host int: the chunk's padding, the ``num_frames`` budget) on are
        skipped and report loss 0.
        """

        def chunk_update(variables, opt_state, imgs_u8, poses, n_active):
            imgs = imgs_u8.to(torch.float32) / 255.0
            losses = torch.zeros(poses.shape[0], dtype=torch.float32, device=poses.device)
            for i in range(min(int(n_active), poses.shape[0])):
                variables, opt_state, losses[i] = self.update(variables, opt_state, imgs[i],
                                                              imgs[i + 1], poses[i])
            return variables, opt_state, losses

        return chunk_update

    def _trainable(self, variables):
        return {net: {k: variables[net][k] for k in self.frontend.trainable_keys(net)}
                for net, on in (("flow", self.train_flow), ("depth", self.train_depth)) if on}

    def _merge(self, variables, trainable):
        """``variables`` with the networks' parameters replaced by
        ``trainable``'s."""
        variables = dict(variables)
        for net, sd in trainable.items():
            variables[net] = {**variables[net], **sd}
        return variables

    def init_state(self, variables, K, K_inv):
        """The Adam state of the trainable tensors (zero moments, step 0);
        keeps the intrinsics ([3 x 3] host arrays, or [S x 3 x 3] for the
        sequences of a multi-sequence step) on the networks' device for the
        depth loss."""
        self._K = upload(K, self.frontend.device, torch.float32)
        self._K_inv = upload(K_inv, self.frontend.device, torch.float32)
        return self.optimizer.init(self._trainable(variables))
