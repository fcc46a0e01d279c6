"""Batched RANSAC homography estimation (4-point DLT).

Counterpart of ``dfvo_tpu/solvers/homography.py`` (the reference's
``cv2.findHomography(..., RANSAC)``), used as the degeneracy detector of the
GRIC model selection.
"""

import math

import torch

from ..utils.precision import highp
from .linalg import inv_3x3, nullspace_vector
from .ransac import sample_points


def _hartley_transform(p, weights=None):
    """Similarity transforms [... x 3 x 3] taking points [... x N x 3] to
    zero (weighted) mean and mean distance sqrt(2)."""
    w = torch.ones_like(p[..., 0]) if weights is None else weights
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    mean = torch.sum(p[..., :2] * w[..., None], dim=-2) / wsum[..., None]
    centered = p[..., :2] - mean[..., None, :]
    dist = torch.sqrt(torch.sum(centered ** 2, dim=-1) + 1e-12)
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(dist * w, dim=-1) / wsum, min=1e-12)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    return torch.stack(
        [
            scale, zero, -scale * mean[..., 0],
            zero, scale, -scale * mean[..., 1],
            zero, zero, one,
        ],
        dim=-1,
    ).reshape(scale.shape + (3, 3))


@highp
def homography_from_sample(p1, p2, weights=None):
    """Normalised DLT homographies (x2 ~ H x1) from homogeneous pixel
    correspondences [... x N x 3] (N >= 4), optionally weighted
    ([... x N]).

    Returns:
        [... x 3 x 3] homographies (up to scale).
    """
    T1 = _hartley_transform(p1, weights)
    T2 = _hartley_transform(p2, weights)
    p1 = p1 @ T1.transpose(-1, -2)
    p2 = p2 @ T2.transpose(-1, -2)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    r1 = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], dim=-1)
    r2 = torch.stack([zero, zero, zero, x1, y1, one, -y2 * x1, -y2 * y1, -y2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    Hn = nullspace_vector(A).reshape(A.shape[:-2] + (3, 3))
    return inv_3x3(T2) @ (Hn @ T1)


@highp
def homography_transfer_error(H, p1, p2):
    """Squared forward transfer errors |p2 - proj(H p1)|^2 [... x N] of
    homogeneous pixel correspondences [N x 3] under H [... x 3 x 3]."""
    x1, y1, z1 = p1[..., 0], p1[..., 1], p1[..., 2]
    h = [[H[..., i, j, None] for j in range(3)] for i in range(3)]
    qx = h[0][0] * x1 + h[0][1] * y1 + h[0][2] * z1
    qy = h[1][0] * x1 + h[1][1] * y1 + h[1][2] * z1
    qw = h[2][0] * x1 + h[2][1] * y1 + h[2][2] * z1
    qw = torch.where(torch.abs(qw) < 1e-12, torch.full_like(qw, 1e-12), qw)
    return (qx / qw - p2[..., 0]) ** 2 + (qy / qw - p2[..., 1]) ** 2


@highp
def find_homography_ransac(rng, kp1, kp2, valid_mask, threshold=1.0,
                           num_hypotheses=256):
    """Batched RANSAC homography (x2 ~ H x1) with three inlier-set refits.

    Args:
        rng: PRNG key.
        kp1, kp2: [N x 2] pixel correspondences.
        valid_mask: [N] bool.
        threshold: inlier threshold in pixels.
        num_hypotheses: 4-point samples (static).

    Returns:
        dict with ``H`` [3x3], ``inliers`` [N], ``inlier_cnt``.
    """
    p1 = torch.cat([kp1, torch.ones_like(kp1[:, :1])], dim=-1)
    p2 = torch.cat([kp2, torch.ones_like(kp2[:, :1])], dim=-1)
    thr2 = threshold ** 2

    samp = sample_points(rng, torch.cat([p1, p2], dim=-1), valid_mask,
                         num_hypotheses, 4)
    Hs = homography_from_sample(samp[..., :3], samp[..., 3:])
    inliers = (homography_transfer_error(Hs, p1, p2) < thr2) & valid_mask
    counts = torch.sum(inliers, dim=-1)
    best = torch.argmax(counts, dim=0, keepdim=True)

    cur_inl = best_inl = inliers[best][0]
    best_H = Hs[best][0]
    best_cnt = counts[best][0]
    for _ in range(3):
        H = homography_from_sample(p1, p2, weights=cur_inl.to(p1.dtype))
        cur_inl = (homography_transfer_error(H, p1, p2) < thr2) & valid_mask
        cnt = torch.sum(cur_inl)
        better = cnt >= best_cnt
        best_H = torch.where(better, H, best_H)
        best_inl = torch.where(better, cur_inl, best_inl)
        best_cnt = torch.where(better, cnt, best_cnt)
    return {"H": best_H, "inliers": best_inl, "inlier_cnt": best_cnt}
