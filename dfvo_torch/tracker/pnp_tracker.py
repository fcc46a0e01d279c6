"""PnP tracker: metric pose from 3D (CNN depth) - 2D matches.

Counterpart of ``dfvo_tpu/tracker/pnp_tracker.py`` (the reference's
pnp_tracker.py): keypoints outside the image or the depth range are
masked, the repeated RANSAC runs as one pooled hypothesis budget, and the
pose is inverted to cur -> ref.
"""

import torch

from ..geometry.lie import make_se3, se3_inverse
from ..geometry.ops import unproject_kp
from ..solvers.pnp import solve_pnp_ransac
from ..utils.precision import highp


@highp
def compute_pose_3d2d(
    rng,
    kp_ref,
    kp_cur,
    valid_mask,
    depth_ref,
    K,
    K_inv,
    min_depth=0.0,
    max_depth=50.0,
    reproj_thre=1.0,
    repeats=5,
    num_hypotheses=256,
):
    """Pose (cur -> ref) from reference-view depth and current-view pixels.

    Args:
        rng: PRNG key.
        kp_ref: [N x 2] reference-view keypoints (3D source).
        kp_cur: [N x 2] matched current-view pixels.
        valid_mask: [N] bool.
        depth_ref: [H x W] reference-view depth map.
        K, K_inv: intrinsics.
        min_depth, max_depth: accepted depth range.
        reproj_thre: RANSAC reprojection threshold (pixels).
        repeats: RANSAC runs, pooled into one budget (static).

    Returns:
        dict with ``T`` [4x4] (cur -> ref), ``ok``, ``inliers`` [N],
        ``mask`` [N].
    """
    h, w = depth_ref.shape
    in_bounds = ((kp_cur[:, 0] >= 0) & (kp_cur[:, 0] < w)
                 & (kp_cur[:, 1] >= 0) & (kp_cur[:, 1] < h))
    # integer pixel by truncation (astype(int32) in the JAX package)
    xi = torch.clamp(kp_ref[:, 0].to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(kp_ref[:, 1].to(torch.int32), 0, h - 1).long()
    kp_depth = depth_ref[yi, xi]
    depth_ok = (kp_depth != 0) & (kp_depth > min_depth) & (kp_depth < max_depth)
    mask = valid_mask & in_bounds & depth_ok

    out = solve_pnp_ransac(
        rng, unproject_kp(kp_ref, kp_depth, K_inv), kp_cur, K, K_inv, mask,
        reproj_threshold=reproj_thre, num_hypotheses=repeats * num_hypotheses,
    )
    ok = out["ok"] & (torch.sum(mask) > 4)
    # (R, t) map ref-frame points into the cur camera; report cur -> ref
    T = se3_inverse(make_se3(out["R"], out["t"]))
    T = torch.where(ok, T, torch.eye(4, dtype=T.dtype, device=T.device))
    return {"T": T, "ok": ok, "inliers": out["inliers"], "mask": mask}
