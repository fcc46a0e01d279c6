"""TUM RGB-D toolkit: timestamp association, ATE after Horn's alignment,
and the Euler / quaternion / pose-vector conversions.

Counterpart of ``dfvo_tpu/evaluation/tum_tool.py`` (the reference's TUM
tools, ``associate.py`` and ``pose_evaluation_utils.py``), in numpy. The
TUM and Kinect loaders read their lists through ``read_file_list`` and
``associate``; ``apis/tum_eval.py`` scores with ``compute_ate``.

Euler convention: ``euler2mat(z, y, x) = Rx(x) @ Ry(y) @ Rz(z)``;
quaternions are ``[w, x, y, z]``.
"""

import numpy as np

from ..utils.io import quat2mat, rot2quat  # noqa: F401 (the toolkit's surface)


def read_file_list(filename):
    """Read a TUM-format file into {timestamp: [data...]}; '#' lines are
    comments (ref associate.py:49-71)."""
    out = {}
    with open(filename, "r") as f:
        for line in f.read().replace(",", " ").replace("\t", " ").split("\n"):
            parts = [v.strip() for v in line.split(" ") if v.strip() != ""]
            if not parts or parts[0].startswith("#"):
                continue
            out[float(parts[0])] = parts[1:]
    return out


def associate(first_list, second_list, offset=0.0, max_difference=0.02):
    """Greedy closest-timestamp association (ref associate.py:74-128).

    Returns:
        sorted list of (t_first, t_second) matches.
    """
    first_keys = set(first_list.keys())
    second_keys = set(second_list.keys())
    potential = [
        (abs(a - (b + offset)), a, b)
        for a in first_keys
        for b in second_keys
        if abs(a - (b + offset)) < max_difference
    ]
    potential.sort()
    matches = []
    for _, a, b in potential:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def align_horn(model, data):
    """Horn's closed-form SE(3) alignment of [3 x N] point sets: finds
    (R, t) minimizing ||R·model + t - data|| (ref
    pose_evaluation_utils.py align())."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    model_zc = model - model_mean
    data_zc = data - data_mean
    W = np.zeros((3, 3))
    for i in range(model.shape[1]):
        W += np.outer(model_zc[:, i], data_zc[:, i])
    U, d, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    R = U @ S @ Vh
    t = data_mean - R @ model_mean
    err = R @ model + t - data
    rmse = np.sqrt(np.sum(err * err) / model.shape[1])
    return R, t, rmse


def compute_ate(gt_traj, pred_traj):
    """ATE RMSE after Horn alignment.

    Args:
        gt_traj, pred_traj: {timestamp: [4x4]} with matching keys (or
        pred keys a subset of gt keys).

    Returns:
        (rmse, aligned_pred {timestamp: [4x4]}).
    """
    keys = sorted(set(gt_traj) & set(pred_traj))
    gt_xyz = np.array([gt_traj[k][:3, 3] for k in keys]).T
    pred_xyz = np.array([pred_traj[k][:3, 3] for k in keys]).T
    R, t, rmse = align_horn(pred_xyz, gt_xyz)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t[:, 0]
    aligned = {k: T @ pred_traj[k] for k in keys}
    return rmse, aligned


# -- pose-representation conversions (ref pose_evaluation_utils.py:83-382) --
# Re-expressed from the standard formulas; the reference vendors the
# nibabel/Shoemake implementations. Same conventions: intrinsic z-y-x
# Euler (R = Rz @ Ry @ Rx), [w, x, y, z] quaternions.


def euler2mat(z=0.0, y=0.0, x=0.0, isRadian=True):
    """Euler angles -> 3x3 rotation matrix, ``R = Rx(x) @ Ry(y) @ Rz(z)``
    (Rz applied first — the reference's composition order, ref
    pose_evaluation_utils.py:218-312; its docstring says "z then y then
    x", which is this, with Rz innermost)."""
    if not isRadian:
        z, y, x = np.radians(z), np.radians(y), np.radians(x)
    for name, a in (("z", z), ("y", y), ("x", x)):
        assert -np.pi <= a <= np.pi, (
            f"Inappropriate {name}: {a} (expected -pi <= {name} <= pi)"
        )
    cz, sz = np.cos(z), np.sin(z)
    cy, sy = np.cos(y), np.sin(y)
    cx, sx = np.cos(x), np.sin(x)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    Ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    Rx = np.array([[1.0, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return Rx @ Ry @ Rz


def mat2euler(M, cy_thresh=None, seq="zyx"):
    """3x3 rotation matrix -> Euler angles (z, y, x) (ref
    pose_evaluation_utils.py:137-217).

    ``seq='zyx'`` inverts ``euler2mat`` (``M = Rx @ Ry @ Rz``); the gimbal
    case |cos(y)| < cy_thresh collapses x to 0 and absorbs the remaining
    rotation into z (Shoemake's Graphics Gems IV treatment). ``seq='xyz'``
    decomposes ``M = Rz(z) @ Ry(y) @ Rx(x)`` instead (still returned in
    (z, y, x) order, like the reference).
    """
    M = np.asarray(M)
    if cy_thresh is None:
        try:
            cy_thresh = np.finfo(M.dtype).eps * 4
        except ValueError:
            cy_thresh = np.finfo(np.float64).eps * 4
    r11, r12, r13, r21, r22, r23, r31, r32, r33 = M.flat
    # cos(y) magnitude from the bottom-row pair: sqrt((cy*sx)^2 + (cx*cy)^2)
    cy = np.sqrt(r33 * r33 + r23 * r23)
    if seq == "zyx":
        if cy > cy_thresh:
            z = np.arctan2(-r12, r11)  # atan2(cy*sz, cy*cz)
            y = np.arctan2(r13, cy)  # atan2(sy, cy)
            x = np.arctan2(-r23, r33)  # atan2(cy*sx, cx*cy)
        else:  # cos(y) ~ 0: x and z degenerate; pick x = 0
            z = np.arctan2(r21, r22)
            y = np.arctan2(r13, cy)
            x = 0.0
        return z, y, x
    if seq == "xyz":
        # M = Rz @ Ry @ Rx: r31 = -sin(y), r11 = cy*cz, r21 = cy*sz,
        # r32 = cy*sx, r33 = cy*cx. (The reference's own xyz branch reuses
        # the zyx-branch cy estimate — wrong elements for this
        # factorization — and leaves x unbound in one gimbal case, a
        # latent NameError; implemented correctly here.)
        cy_x = np.sqrt(r11 * r11 + r21 * r21)
        if cy_x > cy_thresh:
            y = np.arctan2(-r31, cy_x)
            x = np.arctan2(r32, r33)
            z = np.arctan2(r21, r11)
        else:
            z = 0.0
            if r31 < 0:  # y = +pi/2: r12 = sin(x - z), r13 = cos(x - z)
                y = np.pi / 2
                x = np.arctan2(r12, r13)
            else:  # y = -pi/2
                y = -np.pi / 2
                x = np.arctan2(-r12, -r13)
        return z, y, x
    raise ValueError(f"Sequence not recognized: {seq!r}")


def euler2quat(z=0.0, y=0.0, x=0.0, isRadian=True):
    """Euler angles -> quaternion [w, x, y, z] of the same rotation as
    ``euler2mat`` (``q = qx * qy * qz``; ref
    pose_evaluation_utils.py:313-359)."""
    if not isRadian:
        z, y, x = np.radians(z), np.radians(y), np.radians(x)
    cz, sz = np.cos(z / 2), np.sin(z / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    cx, sx = np.cos(x / 2), np.sin(x / 2)
    return np.array(
        [
            cx * cy * cz - sx * sy * sz,
            cy * cz * sx + cx * sy * sz,
            cx * cz * sy - sx * cy * sz,
            cx * cy * sz + sx * cz * sy,
        ]
    )


def pose_vec_to_mat(vec):
    """[tx, ty, tz, rx, ry, rz] -> 4x4 homogeneous matrix with
    ``R = euler2mat(rz, ry, rx)`` (ref pose_evaluation_utils.py:360-370)."""
    T = np.eye(4)
    T[:3, :3] = euler2mat(vec[5], vec[4], vec[3])
    T[:3, 3] = vec[:3]
    return T


def dump_pose_seq_TUM(out_file, poses, times):
    """Write a pose-vector sequence as a TUM trajectory file
    ``t tx ty tz qx qy qz qw`` relative to the first frame, reproducing
    the reference's frame handling (each line holds
    ``first_pose @ inv(pose_p)`` — the vecs are world-to-camera; ref
    pose_evaluation_utils.py:371-382)."""
    first = pose_vec_to_mat(np.asarray(poses[0], dtype=np.float64))
    with open(out_file, "w") as f:
        for p in range(len(times)):
            T = first @ np.linalg.inv(
                pose_vec_to_mat(np.asarray(poses[p], dtype=np.float64))
            )
            qw, qx, qy, qz = rot2quat(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(
                "%f %f %f %f %f %f %f %f\n"
                % (times[p], tx, ty, tz, qx, qy, qz, qw)
            )
