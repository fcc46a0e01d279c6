"""Faults planted under the timed path, for showing that the output check
fails them: the tests run each on the CPU, ``calibrate.py --fault-seeds``
on the card at the cell's own size.

Each fault takes a ``patch(obj, name, value)`` callable (pytest's
``monkeypatch.setattr``, or ``Patches.set``) and replaces one function of
the program with a broken one. Plant a fault before ``Run.setup``: the set-up
binds ``make_chunk_step`` and ``infer_chunk``.
"""

import torch


def state_unchanged(patch):
    """chunk_step returns its state unchanged: the carry it was given, and
    the carry's motion for every frame."""
    from dfvo_torch.pipeline import scan_runner

    make = scan_runner.make_chunk_step

    def make_broken(frontend, tcfg):
        step, init = make(frontend, tcfg)

        def broken(variables, imgs, carry, *args, **kwargs):
            _, modes, _ = step(variables, imgs, carry, *args, **kwargs)
            return carry[2][None].expand(len(imgs), 4, 4), modes, carry

        return broken, init

    patch(scan_runner, "make_chunk_step", make_broken)


def half_batch(patch):
    """infer_chunk computes the first half of the chunk's pairs and gives
    the rest their mean."""
    from dfvo_torch.pipeline.frontend import DeepFrontend

    infer = DeepFrontend.infer_chunk

    def broken(self, variables, all_imgs):
        m = all_imgs.shape[0]
        half = infer(self, variables, all_imgs[: (m + 1) // 2 + 1])
        k = half["depths"].shape[0]
        return {name: torch.cat([t, t.mean(0, keepdim=True).expand(m - 1 - k, *t.shape[1:])])
                for name, t in half.items()}

    patch(DeepFrontend, "infer_chunk", broken)


def altered_depth(patch):
    """One frame's depth altered where the network produces it."""
    from dfvo_torch.pipeline.frontend import DeepFrontend

    infer = DeepFrontend.infer_chunk

    def broken(self, variables, all_imgs):
        out = infer(self, variables, all_imgs)
        out["depths"][1] *= 1.1
        return out

    patch(DeepFrontend, "infer_chunk", broken)


def altered_pose(patch):
    """One frame's pose altered where the tracking produces it."""
    from dfvo_torch.pipeline import scan_runner

    track = scan_runner.tracking_step_chunk

    def broken(*args, **kwargs):
        out = dict(track(*args, **kwargs))
        pose = out["pose"].clone()
        pose[1, 0, 3] += 0.2
        out["pose"] = pose
        return out

    patch(scan_runner, "tracking_step_chunk", broken)


def _patch_cost_volume(patch, broken_of):
    """Replace the cost volume (kernel A on the card) that LiteFlowNet and
    HD3 call by ``broken_of(correlation)``."""
    from dfvo_torch.models import hd3, liteflownet

    for mod in (liteflownet, hd3):
        patch(mod, "correlation", broken_of(mod.correlation))


def cost_volume_tap(patch):
    """Kernel A writes one displacement a tap off: the centre tap of every
    cost volume takes its right neighbour's value."""
    def broken_of(correlation):
        def broken(f1, f2, max_disp=3, stride=1):
            out = correlation(f1, f2, max_disp, stride)
            centre = ((2 * max_disp + 1) ** 2) // 2
            out = out.clone()
            out[..., centre] = out[..., centre + 1]
            return out

        return broken

    _patch_cost_volume(patch, broken_of)


def cost_volume_chunk(patch):
    """Kernel A leaves one chunk of channels out of its sum: the last 32
    channels (half, where a map has 64 or fewer), the mean still taken over
    all of them."""
    def broken_of(correlation):
        def broken(f1, f2, max_disp=3, stride=1):
            c = f1.shape[-1]
            keep = c - min(32, c // 2)
            out = correlation(f1[..., :keep].contiguous(), f2[..., :keep].contiguous(),
                              max_disp, stride)
            return out * (keep / c)

        return broken

    _patch_cost_volume(patch, broken_of)


def filter_shift(patch):
    """Kernel B writes its filtered flow one pixel to the right (LiteFlowNet
    only: HD3 has no filter)."""
    from dfvo_torch.models import liteflownet

    reg_dist_filter = liteflownet.reg_dist_filter

    def broken(*args, **kwargs):
        return torch.roll(reg_dist_filter(*args, **kwargs), 1, dims=2)

    patch(liteflownet, "reg_dist_filter", broken)


def head_conv_chunk(patch):
    """Kernel C leaves one chunk of input channels out of its sum: the last
    32 (half, where the input has 64 or fewer)."""
    from dfvo_torch.models import layers

    head_conv = layers.head_conv

    def broken(x, kernel, bias=None, prepadded=False):
        keep = x.shape[-1] - min(32, x.shape[-1] // 2)
        return head_conv(x[..., :keep].contiguous(), kernel[:, :, :keep].contiguous(), bias,
                         prepadded=prepadded)

    patch(layers, "head_conv", broken)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, altered_depth, altered_pose,
                                  cost_volume_tap, cost_volume_chunk, filter_shift,
                                  head_conv_chunk)}
# faults of code that only one flow network (deep_flow.network) runs
ONLY_FOR = {"filter_shift": "liteflow"}


class Patches:
    """``set(obj, name, value)`` as ``monkeypatch.setattr`` does it; ``undo``
    restores every attribute in reverse order."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)
