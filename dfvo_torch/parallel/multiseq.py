"""Multi-sequence tracking and finetuning on one GPU.

Counterpart of ``dfvo_tpu/parallel/multiseq.py``. The JAX package tracks
many sequences at once with one (or more) per TPU core: ``jax.shard_map``
over a 1-D ``seq`` mesh, ``jax.vmap`` over the sequences of a core. On one
GPU there is no mesh: the sequences are the leading batch axis of every
call, so a step over S sequences pays the host's launch bill once.

* :meth:`MultiSeqRunner.make_vo_step`: one batched ``DeepFrontend.infer``
  over the S pairs (LiteFlowNet on 2S images, the depth network on S), then
  one ``tracking_step`` over a leading sequence axis with per-sequence
  intrinsics and keys. Where JAX's ``vmap`` turns the PnP ``lax.cond`` into
  a select, the step reads the PnP decision once and runs the fallback
  batched over the sequences that need it.
* :meth:`MultiSeqRunner.make_chunk_step`: the single-sequence chunk step
  (``pipeline/scan_runner.py``) once per sequence, as the JAX package runs
  it with one sequence per device.
* :meth:`MultiSeqRunner.make_train_step`: one Adam step on the mean of the
  S sequences' finetuning losses (the JAX package's ``pmean`` of the
  gradients), the networks run once on the 2S images of the S pairs.

Keys are the JAX package's raw keys (uint32 [... x 2] host arrays); each
step splits them as the JAX ``tracking_step`` splits its ``rng``
(``utils/prng.py`` ``split_step_keys``) and uploads them once.
"""

import dataclasses

import numpy as np
import torch

from ..pipeline.finetune import OnlineFinetuner
from ..pipeline.frontend import DeepFrontend
from ..pipeline.scan_runner import make_chunk_step as _build_chunk_step
from ..pipeline.tracking import TrackingConfig, tracking_step
from ..utils import prng
from ..utils.device import upload


def _step_keys(rngs, device):
    """Raw keys [... x 2] as the tracking step's int64 keys [... x 13 x 2]
    on ``device``."""
    return upload(prng.split_step_keys(np.asarray(rngs, np.uint32)).astype(np.int64), device)


class MultiSeqRunner:
    """Builds the multi-sequence step functions for a configuration.

    Args:
        cfg: the merged configuration.
        device: torch device of the networks and the steps.
    """

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.frontend = DeepFrontend(cfg, self.device)
        self.tcfg = TrackingConfig.from_cfg(cfg)
        self.finetuner = OnlineFinetuner(self.frontend, cfg)

    def make_vo_step(self):
        """The batched VO step.

        Returns fn(variables, img_cur_u8 [S x H x W x 3], img_ref_u8 [S],
        depth_ref [S x H x W], prev_motion [S x 4 x 4], rngs [S x 2] raw
        keys, K [S x 3 x 3], K_inv [S x 3 x 3]) -> (poses [S x 4 x 4],
        modes [S], depth_cur [S x H x W]), tensors on the device. As in the
        JAX package, the step passes no previous scale (1.0) and no pose
        CNN pose; it reads the device once (the PnP decision).
        """
        frontend = self.frontend
        # the drawer's rigid-flow map is not returned
        tcfg = dataclasses.replace(self.tcfg, want_rigid_flow_diff=False)

        @torch.no_grad()
        def vo_step(variables, img_cur_u8, img_ref_u8, depth_ref, prev_motion, rngs, K, K_inv):
            fo = frontend.infer(variables, img_cur_u8.to(torch.float32) / 255.0,
                                img_ref_u8.to(torch.float32) / 255.0)
            tr = tracking_step(_step_keys(rngs, img_cur_u8.device), fo["flow_fwd"],
                               fo["flow_diff"], fo["depth_cur"], depth_ref, prev_motion, K,
                               K_inv, tcfg)
            return tr["pose"], tr["mode"], fo["depth_cur"]

        return vo_step

    def make_chunk_step(self):
        """The chunked VO step (``tpu.execution: scan``) over S sequences.

        Returns fn(variables, imgs_u8 [S x T x H x W x 3], carry
        (img_ref_u8 [S x H x W x 3], depth_ref [S x H x W], prev_motion
        [S x 4 x 4], prev_scale [S] numpy), rngs [S x T x 2] raw keys,
        K [S x 3 x 3], K_inv [S x 3 x 3]) -> (poses [S x T x 4 x 4] on the
        device, modes [S x T] numpy, the new carry). Each sequence runs the
        single-sequence chunk step with its own intrinsics and keys (one
        host read per sequence).
        """
        chunk_step, _ = _build_chunk_step(self.frontend, self.tcfg)

        def multi_chunk_step(variables, imgs_u8, carry, rngs, K, K_inv):
            keys = _step_keys(rngs, imgs_u8.device)
            outs = [chunk_step(variables, imgs_u8[s], tuple(c[s] for c in carry), keys[s],
                               K[s], K_inv[s]) for s in range(imgs_u8.shape[0])]
            poses = torch.stack([o[0] for o in outs])
            modes = np.stack([o[1] for o in outs])
            new = [o[2] for o in outs]
            new_carry = (torch.stack([c[0] for c in new]), torch.stack([c[1] for c in new]),
                         torch.stack([c[2] for c in new]),
                         np.array([c[3] for c in new], np.float32))
            return poses, modes, new_carry

        return multi_chunk_step

    def make_train_step(self):
        """The finetuning step over S sequences.

        Returns fn(variables, opt_state, img_ref [S x H x W x 3] float,
        img_cur [S], poses [S x 4 x 4]) -> (variables, opt_state, loss):
        one Adam step on the mean of the S losses (their gradients'
        mean), ``OnlineFinetuner.make_update_fn(axis_name="seq")``. The
        parameters and the moments are updated in place.
        """
        return self.finetuner.make_update_fn(axis_name="seq")
