"""Multi-view geometry on tensors.

Counterpart of ``dfvo_tpu/geometry/ops.py``: NHWC maps and [x, y] pixel
coordinates, fixed shapes, on the device of the inputs.
"""

import torch

from ..ops.warp import coords_grid
from ..solvers.linalg import spd_smallest_eigvec
from ..utils.precision import highp


def _broadcast_K(K, n):
    return K[..., :3, :3].expand(n, 3, 3)


# ---------------------------------------------------------------------------
# dense image-space ops
# ---------------------------------------------------------------------------

@highp
def backproject_depth(depth, inv_K):
    """Depth map [N x H x W] -> homogeneous camera-frame points
    [N x H x W x 4], with inverse intrinsics [N x 3 x 3] or [3 x 3]."""
    n, h, w = depth.shape
    grid = coords_grid(h, w, depth.dtype, depth.device)
    pix = torch.cat([grid, torch.ones_like(grid[..., :1])], dim=-1)
    rays = torch.einsum("nij,hwj->nhwi", _broadcast_K(inv_K, n), pix)
    pts = rays * depth[..., None]
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


@highp
def transform_points(points_h, T):
    """Apply [N x 4 x 4] transforms to [N x H x W x 4] homogeneous points."""
    return torch.einsum("nij,nhwj->nhwi", T, points_h)


@highp
def project_points(points_h, K, eps=1e-7):
    """Homogeneous camera-frame points [N x H x W x 4] -> pixel [x, y]
    coordinates [N x H x W x 2] (unnormalised)."""
    n = points_h.shape[0]
    cam = torch.einsum("nij,nhwj->nhwi", _broadcast_K(K, n), points_h[..., :3])
    return cam[..., :2] / (cam[..., 2:3] + eps)


def reproject(depth, T, K, inv_K):
    """Depth + relative pose -> pixel coordinates of each pixel's
    correspondence in the other view."""
    points = backproject_depth(depth, inv_K)
    return project_points(transform_points(points, T), K)


def rigid_flow(depth, T, K, inv_K):
    """Pose-induced ("rigid") optical flow [N x H x W x 2] from depth and
    relative pose."""
    _, h, w = depth.shape
    coords = reproject(depth, T, K, inv_K)
    return coords - coords_grid(h, w, depth.dtype, depth.device)


# ---------------------------------------------------------------------------
# sparse keypoint ops
# ---------------------------------------------------------------------------

@highp
def unproject_kp(kp, kp_depth, inv_K):
    """Pixel keypoints [N x 2] + depths [N] -> camera-frame points [N x 3]."""
    pix_h = torch.cat([kp, torch.ones_like(kp[..., :1])], dim=-1)
    rays = pix_h @ inv_K.T
    return rays * kp_depth[..., None]


@highp
def triangulate_points(kp1, kp2, P1, P2):
    """DLT triangulation of correspondences seen by two [3 x 4] projection
    matrices: per point, the smallest eigenvector of the 4x4 normal matrix
    (shift-inverted power iteration, solvers/linalg.py).

    Returns:
        [N x 4] homogeneous points (not normalised).
    """
    def two_rows(kp, P):
        x = kp[..., 0:1]
        y = kp[..., 1:2]
        return x * P[2][None] - P[0][None], y * P[2][None] - P[1][None]

    a1, a2 = two_rows(kp1, P1)
    a3, a4 = two_rows(kp2, P2)
    A = torch.stack([a1, a2, a3, a4], dim=-2)
    AtA = torch.einsum("nij,nik->njk", A, A)
    return spd_smallest_eigvec(AtA)


@highp
def triangulate_depths(kp1, kp2, T_1w, T_2w):
    """Triangulate normalised-coordinate correspondences and return
    (X_w [N x 3], z1 [N], z2 [N]): the world points and their depths in
    each camera (T_iw world->camera)."""
    X_h = triangulate_points(kp1, kp2, T_1w[:3], T_2w[:3])
    wc = X_h[..., 3:]
    wc = torch.where(torch.abs(wc) < 1e-12, torch.full_like(wc, 1e-12), wc)
    X = X_h[..., :3] / wc
    X_homo = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    z1 = (X_homo @ T_1w[:3].T)[..., 2]
    z2 = (X_homo @ T_2w[:3].T)[..., 2]
    return X, z1, z2
