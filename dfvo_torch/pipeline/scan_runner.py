"""Batch ("scan") execution: the tracking of a whole chunk of frames in one
pass.

Counterpart of ``dfvo_tpu/pipeline/scan_runner.py``. A chunk of T frames
goes through the networks as one batch (``DeepFrontend.infer_chunk``), and
then through one batched tracking step over a leading frame axis (the JAX
package's ``jax.vmap``; ``tracking.tracking_step_chunk``). With simple
scale recovery every frame's tracking is independent but for two
recurrences: the scale-jump guard needs the previous frame's scale, and
the constant-motion model the previous frame's pose. The batched step runs
with dummies for both and defers the PnP fallback; then

1. the chunk's decision tensors (each frame's scale, mode, ``need_pnp``
   and spike flag) come to the host in one read, the chunk's only one;
2. the scale-spike pass runs there over the T float32 scales, with the
   float32 products of the JAX package's ``spike_fix``;
3. the PnP fallback runs once, batched over the frames that need it;
4. the constant-motion poses are put in by one gather whose indices the
   host derives from the modes, and the scale carry is updated.

Iterative scale recovery (seeded by the previous frame's scale) makes the
JAX package scan its whole step over the chunk. Of that step only the
scale stage reads the carry, and the carry is only the scale: the
constant-motion pose and the PnP fallback do not feed back into it. So
the batched step runs its scale stage frame by frame with the running
scale on the device and the guard applied there (step 2 is skipped), and
steps 1, 3 and 4 stay as they are: still one host read per chunk.

Padded frames at the end of a last chunk are tracked like any other and
dropped by the caller.
"""

import numpy as np
import torch

from ..utils import prng
from ..utils.device import upload
from .dfvo import depth_only
from .frontend import DeepFrontend
from .tracking import (
    TRACK_MODE_CONST,
    TRACK_MODE_ESSENTIAL,
    TRACK_MODE_PNP,
    TrackingConfig,
    pnp_fallback,
    tracking_step_chunk,
)

# the tracking outputs that a deferred PnP fallback reads, per frame
_PNP_INPUTS = ("kp_ref", "kp_cur", "kp_valid", "depth_ref")


def spike_pass(scales, modes, need_pnp, prev_scale, tcfg):
    """The sequential scale-spike pass of the JAX chunk step on the host.

    A frame whose scale jumps more than ``tcfg.scale_jump_guard`` times
    from the running scale loses it (-1); a spiked E frame falls to PnP
    (to constant motion with ``force_e_path``). A spiked or failed frame
    does not update the running scale.

    Args:
        scales: [T] float32 scales of the batched step.
        modes, need_pnp: [T] modes and PnP requests of the batched step.
        prev_scale: the running scale before the chunk.
        tcfg: TrackingConfig.

    Returns:
        (scales, modes, need_pnp, spikes) after the pass, numpy [T] each.
    """
    g = np.float32(tcfg.scale_jump_guard)
    ps = np.float32(prev_scale)
    eff = np.array(scales, np.float32)
    spikes = np.zeros(len(eff), bool)
    for i, s in enumerate(eff):
        spikes[i] = (ps > 0) & (s > 0) & ((s > ps * g) | (s * g < ps))
        if spikes[i]:
            eff[i] = -1.0
        elif s > 0:
            ps = s
    hit = spikes & (modes == TRACK_MODE_ESSENTIAL)
    fb_mode = TRACK_MODE_CONST if tcfg.force_e_path else TRACK_MODE_PNP
    modes = np.where(hit, fb_mode, modes)
    if not tcfg.force_e_path:
        need_pnp = need_pnp | hit
    return eff, modes, need_pnp, spikes


def const_motion_sources(modes):
    """Indices into [prev_motion, pose_0, ..., pose_{T-1}] of each frame's
    final pose: a constant-motion frame repeats the pose before it."""
    src, last = np.empty(len(modes), np.int64), 0
    for i, m in enumerate(modes):
        if m != TRACK_MODE_CONST:
            last = i + 1
        src[i] = last
    return src


def carried_scale(scales, prev_scale):
    """The running scale after the chunk: its last positive scale."""
    ps = np.float32(prev_scale)
    for s in scales:
        if s > 0:
            ps = np.float32(s)
    return ps


def make_chunk_step(frontend, tcfg):
    """The chunk step and the first frame's depth function for a frontend
    and a tracking configuration.

    Returns:
        (chunk_step, init_depth).
    """
    iterative = tcfg.scale_method == "iterative"

    @torch.no_grad()
    def chunk_step(variables, imgs_u8, carry, rngs, K, K_inv, oracle=None, info=None):
        """Track a chunk of frames.

        Args:
            variables: prepared network variables.
            imgs_u8: [T x H x W x 3] uint8 frames on the device.
            carry: (img_ref_u8 [H x W x 3], depth_ref_raw [H x W],
                prev_motion [4 x 4], prev_scale): the frame before the
                chunk, its raw depth, its relative pose and the running
                scale (a number; it lives on the host, where the spike
                pass runs).
            rngs: [T x 13 x 2] int64 step keys of the frames on the device
                (``prng.step_keys``).
            K, K_inv: [3 x 3] float32 intrinsics on the device.
            oracle: optional dict of ``depths`` [T x H x W], ``flow_fwd``
                [T x H x W x 2] and ``flow_diff`` [T x H x W]; tracking
                then reads ``oracle + net * 1e-30``, so the networks still
                run in full while the decision tree sees coherent data.
            info: optional dict that receives the host arrays of the
                chunk's decision: ``scale`` (after the spike pass),
                ``need_pnp`` and ``spike``.

        Returns:
            (poses [T x 4 x 4] relative poses cur -> ref on the device,
            modes [T] numpy int64, the new carry).
        """
        img_ref_u8, depth_ref0, prev_motion0, prev_scale0 = carry
        all_imgs = torch.cat([img_ref_u8[None], imgs_u8], dim=0).to(torch.float32) / 255.0
        fo = frontend.infer_chunk(variables, all_imgs)
        if oracle is not None:
            fo = dict(fo, **{k: oracle[k].to(torch.float32) + fo[k] * 1e-30
                             for k in ("depths", "flow_fwd", "flow_diff")})
        # the reference depth of pair i is the depth of frame i
        depth_refs = torch.cat([depth_ref0[None], fo["depths"][:-1]], dim=0)
        prev_scale0 = np.float32(float(prev_scale0))
        tr = tracking_step_chunk(rngs, fo["flow_fwd"], fo["flow_diff"], fo["depths"],
                                 depth_refs, K, K_inv, tcfg, prev_scale=prev_scale0)

        # the chunk's one host read
        decision = torch.stack([tr["scale"], tr["mode"].to(torch.float32),
                                tr["need_pnp"].to(torch.float32),
                                tr["spike"].to(torch.float32)]).cpu().numpy()
        scales = decision[0]
        modes = decision[1].astype(np.int64)
        need = decision[2] > 0
        spikes = decision[3] > 0  # the guard of the iterative scale stage
        if tcfg.scale_jump_guard > 0 and not iterative:
            scales, modes, need, spikes = spike_pass(scales, modes, need, prev_scale0, tcfg)

        # the deferred PnP fallback, batched over the frames that need it,
        # then the constant-motion poses; one index upload for both
        pnp_idx = np.flatnonzero(need)
        src = const_motion_sources(modes)
        idx = upload(np.concatenate([pnp_idx, src]), imgs_u8.device)
        poses = tr["pose"]
        if len(pnp_idx):
            sel = idx[: len(pnp_idx)]
            sub = [t.index_select(0, sel) for t in (
                rngs, *(tr[k] for k in _PNP_INPUTS), fo["flow_fwd"], fo["flow_diff"],
                depth_refs)]
            keys, kp_ref, kp_cur, valid, dref = sub[:5]
            pnp_T = pnp_fallback(keys, kp_ref, kp_cur, valid, dref, *sub[5:], K, K_inv,
                                 tcfg)["T"]
            poses = poses.index_copy(0, sel, pnp_T)
        poses = torch.cat([prev_motion0[None], poses], dim=0).index_select(
            0, idx[len(pnp_idx):])

        if info is not None:
            info.update(scale=scales, need_pnp=need, spike=spikes)
        new_carry = (imgs_u8[-1], fo["depths"][-1], poses[-1],
                     carried_scale(scales, prev_scale0))
        return poses, modes, new_carry

    def init_depth(variables, img_u8):
        return depth_only(frontend, variables, img_u8)

    return chunk_step, init_depth


class ScanRunner:
    """Chunked VO over an in-memory frame stream.

    Args:
        cfg: the merged configuration (``tpu.scan_chunk`` frames a chunk).
        frontend: a DeepFrontend, or None to build one on ``device``.
        device: the device of a new frontend (None: ``cuda``).
    """

    def __init__(self, cfg, frontend=None, device=None):
        self.cfg = cfg
        self.frontend = frontend or DeepFrontend(cfg, device or "cuda")
        self.tcfg = TrackingConfig.from_cfg(cfg)
        self.chunk = int(cfg.tpu.scan_chunk)
        self._chunk_step, self._init_depth = make_chunk_step(self.frontend, self.tcfg)

    def initial_carry(self, variables, img0_u8):
        """The carry before the first chunk: frame 0, its depth, the
        identity motion and scale 1."""
        dev = img0_u8.device
        return (img0_u8, self._init_depth(variables, img0_u8),
                torch.eye(4, dtype=torch.float32, device=dev), np.float32(1.0))

    def run(self, variables, frames, K, K_inv, rng_seed=0):
        """Track a whole in-memory sequence.

        Args:
            variables: float32 network variables (as from
                ``DeepFrontend.init_variables``).
            frames: [N x H x W x 3] uint8 array (N >= 2).
            K, K_inv: [3 x 3] numpy intrinsics.
            rng_seed: frame i's key is ``fold_in(PRNGKey(rng_seed), i)``.

        Returns:
            {frame: [4 x 4]} absolute poses (frame 0 = identity).
        """
        frames = np.asarray(frames, np.uint8)
        n = len(frames)
        dev = self.frontend.device
        variables = self.frontend.prepare_variables(variables)
        Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        Kit = torch.as_tensor(np.asarray(K_inv, np.float32), device=dev)
        carry = self.initial_carry(variables, upload(frames[0], dev))

        rel, t = [], self.chunk
        for start in range(1, n, t):
            chunk = frames[start : start + t]
            pad = t - len(chunk)
            if pad:  # a fixed chunk shape; padded frames are dropped below
                chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, 0)])
            keys = prng.step_keys(rng_seed, range(start, start + t)).astype(np.int64)
            poses, _, carry = self._chunk_step(variables, upload(chunk, dev), carry,
                                               upload(keys, dev), Kt, Kit)
            rel.append(poses.cpu().numpy()[: t - pad])

        rel = np.concatenate(rel, axis=0).astype(np.float64)
        out = {0: np.eye(4)}
        T = np.eye(4)
        for i in range(len(rel)):
            T = T @ rel[i]
            out[i + 1] = T
        return out

