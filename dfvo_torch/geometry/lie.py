"""SO(3)/SE(3) helpers on batched tensors.

Counterpart of ``dfvo_tpu/geometry/lie.py``: every function takes any
leading batch dimensions and runs on the device of its input.
"""

import torch

from ..utils.precision import highp


def skew(v):
    """[...x3] -> [...x3x3] skew-symmetric matrices ([v]_x w = v x w)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


@highp
def so3_exp(w):
    """Axis-angle vector [...x3] -> rotation matrix [...x3x3] (Rodrigues),
    with series coefficients near zero so the identity is exact."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + 1e-24)
    W = skew(w)
    W2 = W @ W
    small = theta_sq < 1e-12
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix [...x3x3] -> axis-angle vector [...x3], through
    atan2(|vee|, tr) as in the JAX package."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    two_sin_theta = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    theta = torch.atan2(0.5 * two_sin_theta, cos_theta)
    small = theta < 1e-4
    denom = torch.where(small, torch.ones_like(two_sin_theta), two_sin_theta)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / denom)
    return v * scale[..., None]


def make_se3(R, t):
    """(R [...x3x3], t [...x3]) -> homogeneous transform [...x4x4]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    zero = torch.zeros_like(t[..., None, :])
    bottom = torch.cat([zero, torch.ones_like(zero[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


@highp
def se3_inverse(T):
    """Inverse of homogeneous transform(s) in closed form [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_se3(Rt, -(Rt @ t[..., None])[..., 0])


def transformation_from_parameters(axisangle, translation, invert=False):
    """(axis-angle [...x3], translation [...x3]) -> [...x4x4] transform:
    the pose CNN's convention, T = trans(t) @ rot(aa), or with ``invert``
    its inverse composition [R^T, R^T (-t)]."""
    R = so3_exp(axisangle)
    if invert:
        R = R.transpose(-1, -2)
        return make_se3(R, (R @ -translation[..., None])[..., 0])
    return make_se3(R, translation)
