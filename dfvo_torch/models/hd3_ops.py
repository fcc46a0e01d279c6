"""HD3 discrete-distribution ops on NHWC tensors.

Counterpart of ``dfvo_tpu/models/hd3_ops.py``: masked flow warping, the
conversions between a motion vector and a probability density over the
(2c+1)² (flow) or 2c+1 (stereo) support, the confidence map, and the
resize of a motion field.
"""

import torch
import torch.nn.functional as F

from ..ops.warp import flow_to_coords, grid_sample
from .layers import resize_bilinear


def flow_warp(x, flo, mul=True):
    """Backward-warp ``x`` [N x H x W x C] by ``flo`` [N x H x W x 2] with
    border padding; pixels that sample outside the map are zeroed by a
    warped validity mask (``grid_sample`` of ones with zero padding,
    thresholded at 0.9999). The mask is the same for every channel, so it
    is sampled on one channel and broadcast."""
    coords = flow_to_coords(flo)
    out = grid_sample(x, coords, padding_mode="border")
    mask = grid_sample(torch.ones_like(x[..., :1]), coords, padding_mode="zeros")
    mask = 1.0 - (mask < 0.9999).to(x.dtype)
    if mul:
        return out * mask
    return out, mask.expand_as(out)


def disp2flow(disp):
    """[N x H x W x 1] disparity -> [N x H x W x 2] flow with zero dy."""
    return torch.cat([disp, torch.zeros_like(disp)], dim=-1)


def vector2density(vect, c, dim):
    """A point motion estimate -> its bilinear probability density over the
    (2c+1)² (dim 2) or 2c+1 (dim 1) support."""
    if dim == 2:
        return _flow2distribution(vect, c)
    dist = _flow2distribution(disp2flow(vect), c)
    return dist[..., c * (2 * c + 1) : (c + 1) * (2 * c + 1)]


def _flow2distribution(flo, c):
    d = 2 * c + 1
    flo = flo.clamp(-c, c)
    x, y = flo[..., 0], flo[..., 1]
    x0 = torch.floor(x)
    x1 = x0 + 1
    y0 = torch.floor(y)
    y1 = y0 + 1

    def safe(v):
        return v.clamp(-c, c)

    wt_x0 = (x1 - x) * (x0 == safe(x0))
    wt_x1 = (x - x0) * (x1 == safe(x1))
    wt_y0 = (y1 - y) * (y0 == safe(y0))
    wt_y1 = (y - y0) * (y1 == safe(y1))

    def put(xs, ys, wt):
        label = ((safe(ys) + c) * d + safe(xs) + c).long()
        return F.one_hot(label, d * d).to(flo.dtype) * wt[..., None]

    return (put(x0, y0, wt_x0 * wt_y0) + put(x1, y0, wt_x1 * wt_y0)
            + put(x0, y1, wt_x0 * wt_y1) + put(x1, y1, wt_x1 * wt_y1))


def _corner_avg(prob):
    """The 2x2 means of the d x d support grid, flattened:
    [N x H x W x (d-1)²]."""
    n, h, w, C = prob.shape
    d = int(round(C**0.5))
    pr = prob.reshape(n, h, w, d, d)  # [..., dy, dx]
    avg = (pr[..., :-1, :-1] + pr[..., :-1, 1:] + pr[..., 1:, :-1] + pr[..., 1:, 1:]) / 4.0
    return avg.reshape(n, h, w, (d - 1) * (d - 1)), d


def _prob2cornerflow(prob, normalize=True):
    """The best 2x2 corner block of the d x d probability grid (the first
    among ties) and its four corners' probabilities and flows."""
    if normalize:
        prob = torch.softmax(prob, dim=-1)
    avg, d = _corner_avg(prob)
    idx = torch.argmax(avg, dim=-1)
    ind = (idx // (d - 1)) * d + idx % (d - 1)  # top-left corner in d x d

    def ind2flow(i):
        return torch.stack([(i % d - d // 2).to(prob.dtype),
                            (i // d - d // 2).to(prob.dtype)], dim=-1)

    corners = (0, 1, d, d + 1)  # tl, tr, bl, br
    cor_prob = [torch.gather(prob, -1, (ind + o)[..., None])[..., 0] for o in corners]
    cor_flow = [ind2flow(ind + o) for o in corners]
    return cor_prob, cor_flow


def density2vector(prob, dim, normalize=True):
    """A probability density (logits with ``normalize``) -> the expected
    motion vector over its best corner block."""
    if dim == 1:
        prob = _disp_prob2flow_prob(prob, normalize)
        return density2vector(prob, 2, normalize=False)[..., 0:1]
    cor_prob, cor_flow = _prob2cornerflow(prob, normalize)
    s = cor_prob[0] + cor_prob[1] + cor_prob[2] + cor_prob[3]
    pn = [p / torch.clamp(s, min=1e-12) for p in cor_prob]
    out_x = cor_flow[1][..., 0] - pn[0] - pn[2]
    out_y = cor_flow[2][..., 1] - pn[0] - pn[1]
    return torch.stack([out_x, out_y], dim=-1)


def _disp_prob2flow_prob(prob, normalize=True):
    if normalize:
        prob = torch.softmax(prob, dim=-1)
    n, h, w, d = prob.shape
    pad = prob.new_zeros((n, h, w, d * (d - 1) // 2))
    return torch.cat([pad, prob, pad], dim=-1)


def prob_gather(prob, normalize=True, dim=2):
    """Confidence map: 4x the best 2x2-averaged probability."""
    if normalize:
        prob = torch.softmax(prob, dim=-1)
    if dim == 1:
        prob = _disp_prob2flow_prob(prob, False)
    avg, _ = _corner_avg(prob)
    return 4.0 * torch.amax(avg, dim=-1, keepdim=True)


def resize_dense_vector(vec, des_height, des_width):
    """Bilinear resize (align_corners=True) of a motion field with its
    magnitudes rescaled to the new size."""
    _, h, w, c = vec.shape
    out = resize_bilinear(vec, des_height, des_width, align_corners=True)
    if c == 1:
        return out * (des_width / w)
    return torch.stack((out[..., 0] * (des_width / w), out[..., 1] * (des_height / h)), dim=-1)
