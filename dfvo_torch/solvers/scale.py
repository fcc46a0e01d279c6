"""1-D RANSAC scale estimation from triangulated-vs-CNN depth ratios.

Counterpart of ``dfvo_tpu/solvers/scale.py`` (the reference's sklearn
``RANSACRegressor(LinearRegression(fit_intercept=False))``): fits c
minimising |c * ratio - 1| over the inliers.
"""

import torch

from ..utils.precision import highp
from .ransac import sample_points


@highp
def scale_ransac_1d(rng, ratios, valid_mask, threshold=0.1, num_hypotheses=100,
                    min_samples=3):
    """RANSAC fit of c with residual |c * ratio - 1| (no intercept).

    Args:
        rng: PRNG key.
        ratios: [N] depth ratios.
        valid_mask: [N] bool.
        threshold: inlier residual threshold.
        num_hypotheses: trials (static).
        min_samples: points per minimal fit (static).

    Returns:
        dict with ``scale``, ``inliers`` [N], ``inlier_cnt``.
    """
    x = sample_points(rng, ratios[:, None], valid_mask, num_hypotheses,
                      min_samples)[..., 0]
    # least squares of x c = 1 on each sample: c = sum x / sum x^2
    cs = torch.sum(x, dim=1) / torch.clamp(torch.sum(x * x, dim=1), min=1e-12)
    inliers = (torch.abs(cs[:, None] * ratios - 1.0) < threshold) & valid_mask
    best = torch.argmax(torch.sum(inliers, dim=1), dim=0, keepdim=True)
    w = inliers[best][0].to(ratios.dtype)
    c = torch.sum(w * ratios) / torch.clamp(torch.sum(w * ratios * ratios), min=1e-12)
    inl = (torch.abs(c * ratios - 1.0) < threshold) & valid_mask
    return {"scale": c, "inliers": inl, "inlier_cnt": torch.sum(inl)}
