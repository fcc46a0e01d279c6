"""The per-frame step of DF-VO: network frontend, then the tracking step.

Counterpart of the step functions of ``dfvo_tpu/pipeline/dfvo.py``: its
``depth_only`` closure (the first frame's depth), its ``full_step``
closure (here :func:`frame_step`: u8 images -> ``DeepFrontend.infer`` ->
``tracking_step``), and the pose chaining of ``DFVO.update_global_pose``.
The ``DFVO`` frame loop, datasets and result files come with the port's
entry point.
"""

import torch

from .tracking import tracking_step


def _to_unit_float(img_u8):
    return img_u8.to(torch.float32) / 255.0


@torch.no_grad()
def depth_only(frontend, variables, img_u8):
    """Raw depth [H x W] of one uint8 frame [H x W x 3] (the first frame's
    reference depth)."""
    img = _to_unit_float(img_u8)[None].to(frontend.dtype)
    return frontend._depth(variables, img)[0]


@torch.no_grad()
def frame_step(frontend, tcfg, variables, img_cur_u8, img_ref_u8, depth_ref_raw,
               prev_motion, rng, K, K_inv, prev_scale, gt_depth_cur=None):
    """One frame pair through the networks and the tracking step.

    Args:
        frontend: DeepFrontend.
        tcfg: TrackingConfig.
        variables: prepared network variables.
        img_cur_u8, img_ref_u8: [H x W x 3] uint8 frames on the device.
        depth_ref_raw: [H x W] raw depth of the reference frame.
        prev_motion: [4 x 4] previous relative pose.
        rng: the frame's key, ``fold_in(PRNGKey(cfg.seed), img_id)``.
        K, K_inv: [3 x 3] float32 intrinsics on the device.
        prev_scale: previous frame's scale (0-d tensor or number).
        gt_depth_cur: optional [H x W] depth that replaces the depth CNN.

    Returns:
        dict with ``pose``, ``mode``, ``scale``, ``depth_cur_raw``, the
        flows, keypoints, inliers, ``rigid_flow_diff`` and ``depth_cur``.
    """
    fo = frontend.infer(variables, _to_unit_float(img_cur_u8), _to_unit_float(img_ref_u8),
                        depth_cur=gt_depth_cur)
    tr = tracking_step(rng, fo["flow_fwd"], fo["flow_diff"], fo["depth_cur"], depth_ref_raw,
                       prev_motion, K, K_inv, tcfg, prev_scale=prev_scale)
    return {
        "pose": tr["pose"],
        "mode": tr["mode"],
        "scale": tr["scale"],
        "depth_cur_raw": fo["depth_cur"],
        "flow_fwd": fo["flow_fwd"],
        "flow_bwd": fo["flow_bwd"],
        "flow_diff": fo["flow_diff"],
        "kp_ref": tr["kp_ref"],
        "kp_cur": tr["kp_cur"],
        "kp_valid": tr["kp_valid"],
        "inliers": tr["inliers"],
        "rigid_flow_diff": tr["rigid_flow_diff"],
        "depth_cur": tr["depth_cur"],
    }


def update_global_pose(ref_pose, new_pose, scale=1.0):
    """Chain a relative pose (cur -> ref, geometry.camera.SE3) onto the
    reference frame's global pose: t <- R t_new * scale + t,
    R <- R R_new. Returns a new SE3."""
    pose = ref_pose.copy()
    pose.t = pose.R @ new_pose.t * scale + pose.t
    pose.R = pose.R @ new_pose.R
    return pose


def next_prev_scale(scale, prev_scale):
    """The scale carried to the next frame: this frame's when positive."""
    return torch.where(scale > 0, scale, prev_scale)
