"""HD3 training losses on NHWC tensors.

Counterpart of ``dfvo_tpu/models/hd3_losses.py``: the per-level KL
divergence between the predicted motion distributions and the bilinear
densities of the residual ground-truth motion, and the end-point error.
Off the tracking path (online finetuning uses the photometric losses of
``pipeline/finetune.py``).
"""

import torch

from .hd3_ops import disp2flow, resize_dense_vector, vector2density
from .layers import resize_bilinear


def downsample_flow(flo, scale_factor):
    """Bilinear flow downsample (align_corners=True) without magnitude
    rescaling. Returns (flow, valid mask of ones)."""
    n, h, w, _ = flo.shape
    nh, nw = int(h * scale_factor), int(w * scale_factor)
    out = resize_bilinear(flo, nh, nw, align_corners=True)
    return out, flo.new_ones((n, nh, nw, 1))


def hd3_loss(ms_prob, ms_pred, gt, corr_range, task="flow", ds=6):
    """The multi-level KL-divergence objective.

    Args:
        ms_prob: per-level [N x h x w x classes] logits of ``HD3Net``.
        ms_pred: per-level [N x h x w x dim] motion vectors (full-resolution
            units).
        gt: [N x H x W x 2] ground-truth flow at full resolution.
        corr_range: per-level support radii.
        task: 'flow' | 'stereo'.
        ds: downsample exponent of the coarsest level.

    Returns:
        scalar loss.
    """
    dim = 1 if task == "stereo" else 2
    n, H, W, _ = gt.shape
    total = 0.0
    for l, prob in enumerate(ms_prob):
        scaled_gt, valid = downsample_flow(gt, 1.0 / 2 ** (ds - l))
        if task == "stereo":
            scaled_gt = scaled_gt[..., 0:1]
        if l > 0:
            h, w = scaled_gt.shape[1], scaled_gt.shape[2]
            up_prev = 2.0 * resize_bilinear(ms_pred[l - 1] / 2 ** (ds - (l - 1)), h, w,
                                            align_corners=True)
            scaled_gt = scaled_gt / 2 ** (ds - l) - up_prev
        else:
            scaled_gt = scaled_gt / 2 ** (ds - l)
        gt_dist = (vector2density(scaled_gt, corr_range[l], dim) * valid).detach()
        log_pred = torch.log_softmax(prob, dim=-1)
        # KLDivLoss(batchmean): sum(target * (log(target) - log_pred)) / N
        safe_t = torch.where(gt_dist > 0, gt_dist, torch.ones_like(gt_dist))
        kld = torch.sum(gt_dist * (torch.log(safe_t) - log_pred)) / n
        total = total + 4 ** (ds - l) / (H * W) * kld
    return total


def end_point_error(output, gt, gt_mask=None):
    """Masked mean end-point error at the ground truth's resolution.

    Args:
        output: [N x h x w x (1|2)] prediction (stereo or flow).
        gt: [N x H x W x 2] ground truth.
        gt_mask: optional [N x H x W] validity.
    """
    if output.shape[-1] == 1:
        output = disp2flow(output)
    out = resize_dense_vector(output, gt.shape[1], gt.shape[2])
    err = torch.linalg.norm(out - gt, dim=-1)
    if gt_mask is None:
        return torch.mean(err)
    m = gt_mask.to(err.dtype)
    return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)
