"""Geometric Robust Information Criterion (GRIC) for E-vs-H model
selection.

Counterpart of ``dfvo_tpu/solvers/gric.py`` (the reference's gric.py):
the same residual definitions and score, batched over leading model
dimensions.
"""

import math

import torch

from ..utils.precision import highp

_MODEL_K = {"FMat": 7.0, "EMat": 5.0, "HMat": 8.0}
_MODEL_D = {"FMat": 3.0, "EMat": 3.0, "HMat": 2.0}


def _masked(res, mask):
    return res if mask is None else torch.where(mask, res, torch.zeros_like(res))


@highp
def fundamental_residual(F, kp1, kp2, mask=None):
    """First-order geometric residual of F [... x 3 x 3] per pixel
    correspondence [... x N x 2] (leading axes broadcast against F's):
    (x2^T F x1)^2 / (|(F x1)_xy|^2 + |(F^T x2)_xy|^2), [... x N]."""
    p1 = torch.cat([kp1, torch.ones_like(kp1[..., :1])], dim=-1)
    p2 = torch.cat([kp2, torch.ones_like(kp2[..., :1])], dim=-1)
    Fx1 = p1 @ F.transpose(-1, -2)
    Ftx2 = p2 @ F
    num = torch.sum(p2 * Fx1, dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return _masked(num / torch.clamp(den, min=1e-12), mask)


@highp
def homography_residual(H, kp1, kp2, mask=None):
    """Approximate geometric residual of H [... x 3 x 3] per pixel
    correspondence [... x N x 2] (leading axes broadcast against H's): both rows' algebraic errors over their gradient
    norms, combined through the angle between the two gradients."""
    h = [H.reshape(H.shape[:-2] + (9,))[..., k, None] for k in range(9)]
    x1, y1 = kp1[..., 0], kp1[..., 1]
    x2, y2 = kp2[..., 0], kp2[..., 1]
    g2 = -x1 * h[6] - y1 * h[7] - h[8]
    G0 = torch.stack(torch.broadcast_tensors(h[0] - x2 * h[6], h[1] - x2 * h[7], g2), dim=-1)
    G1 = torch.stack(torch.broadcast_tensors(h[3] - y2 * h[6], h[4] - y2 * h[7], g2), dim=-1)
    magG0 = torch.linalg.vector_norm(G0, dim=-1)
    magG1 = torch.linalg.vector_norm(G1, dim=-1)
    magG0G1 = G0[..., 0] * G1[..., 0] + G0[..., 1] * G1[..., 1]
    alpha = torch.arccos(torch.clamp(magG0G1 / torch.clamp(magG0 * magG1, min=1e-12),
                                     -1.0, 1.0))
    alg0 = x1 * h[0] + y1 * h[1] + h[2] - x2 * (x1 * h[6] + y1 * h[7] + h[8])
    alg1 = x1 * h[3] + y1 * h[4] + h[5] - y2 * (x1 * h[6] + y1 * h[7] + h[8])
    D1 = alg0 / torch.clamp(magG0, min=1e-12)
    D2 = alg1 / torch.clamp(magG1, min=1e-12)
    sin_a = torch.sin(alpha)
    sin_a = torch.where(torch.abs(sin_a) < 1e-12, torch.full_like(sin_a, 1e-12), sin_a)
    res = (D1 * D1 + D2 * D2 - 2.0 * D1 * D2 * torch.cos(alpha)) / sin_a
    return _masked(res, mask)


@highp
def calc_gric(res, sigma, n, model, mask=None):
    """GRIC score over the last axis of ``res`` (lower is better).

    Args:
        res: [... x N] residuals.
        sigma: assumed residual standard deviation.
        n: effective number of correspondences (a number, or a tensor
            broadcasting against ``res``'s leading axes).
        model: 'FMat' | 'EMat' | 'HMat'.
        mask: optional [... x N] bool; excluded residuals contribute 0.
    """
    R = 4.0
    K = _MODEL_K[model]
    D = _MODEL_D[model]
    terms = _masked(torch.clamp(res / sigma ** 2, max=2.0 * (R - D)), mask)
    n = torch.as_tensor(n, dtype=terms.dtype)
    return torch.sum(terms, dim=-1) + n * D * math.log(R) + K * torch.log(R * n)
