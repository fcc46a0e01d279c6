"""Host-side IO: images, depths, pose files and intrinsics files.

Counterpart of ``dfvo_tpu/utils/io.py``, with the same file formats, so
trajectories written by either package score identically under the
KITTI and TUM tools. cv2 is imported by the readers that decode images,
so the module imports on hosts without it.
"""

import os

import numpy as np


def mkdir_if_not_exists(path):
    os.makedirs(path, exist_ok=True)


def read_image(path, h, w, crop=None):
    """Read an image as RGB uint8, optionally crop (normalized
    [[y0, y1], [x0, x1]]), then resize to (h, w) (cv2 INTER_LINEAR)."""
    import cv2

    img = cv2.imread(path, 1)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if crop is not None:
        img_h, img_w, _ = img.shape
        y0, y1 = int(img_h * crop[0][0]), int(img_h * crop[0][1])
        x0, x1 = int(img_w * crop[1][0]), int(img_w * crop[1][1])
        img = img[y0:y1, x0:x1]
    return cv2.resize(img, (w, h))


def read_depth(path, scale, target_size=None):
    """Read a 16-bit depth PNG, divide by ``scale``, optionally resize
    (nearest) to ``target_size`` = (h, w)."""
    import cv2

    depth = cv2.imread(path, -1)
    if depth is None:
        raise FileNotFoundError(f"cannot read depth: {path}")
    depth = depth / scale
    if target_size is not None:
        img_h, img_w = target_size
        depth = cv2.resize(depth, (img_w, img_h), interpolation=cv2.INTER_NEAREST)
    return depth


def preprocess_depth(depth, crop, depth_range):
    """Zero out depth outside the normalized crop region and the open
    (min, max) range."""
    min_depth, max_depth = depth_range
    h, w = depth.shape
    y0, y1 = int(h * crop[0][0]), int(h * crop[0][1])
    x0, x1 = int(w * crop[1][0]), int(w * crop[1][1])
    depth_mask = np.zeros((h, w))
    depth_mask[y0:y1, x0:x1] = 1
    depth_range_mask = (depth < max_depth) * (depth > min_depth)
    return depth * (depth_mask * depth_range_mask)


# ---------------------------------------------------------------------------
# quaternions (TUM format)
# ---------------------------------------------------------------------------

def quat2mat(q):
    """Quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    if n < np.finfo(float).eps:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def rot2quat(R):
    """3x3 rotation matrix -> quaternion [w, x, y, z] (Shepperd's method)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z])


# ---------------------------------------------------------------------------
# pose files
# ---------------------------------------------------------------------------

def load_poses_from_txt(file_name):
    """KITTI-format poses: each line is ``[idx] r11 r12 ... t3`` (the
    flattened 3x4, optionally prefixed by a frame index). -> {frame: 4x4}."""
    poses = {}
    with open(file_name, "r") as f:
        for cnt, line in enumerate(f.readlines()):
            vals = [float(v) for v in line.strip().split(" ") if v != ""]
            if not vals:
                continue
            with_idx = len(vals) == 13
            P = np.eye(4)
            P[:3, :4] = np.array(vals[int(with_idx):]).reshape(3, 4)
            frame_idx = vals[0] if with_idx else cnt
            poses[frame_idx] = P
    return poses


def load_poses_from_txt_tum(file_name):
    """TUM-format poses (``timestamp tx ty tz qx qy qz qw``), re-based so the
    first pose is the identity. -> {timestamp: 4x4}."""
    poses = {}
    with open(file_name, "r") as f:
        for line in f.readlines():
            parts = line.strip().split(" ")
            if not parts or parts[0] == "#":
                continue
            timestamp, tx, ty, tz, qx, qy, qz, qw = [float(v) for v in parts]
            P = np.eye(4)
            P[:3, :3] = quat2mat([qw, qx, qy, qz])
            P[:3, 3] = [tx, ty, tz]
            poses[timestamp] = P
    if poses:
        keys = list(poses.keys())
        inv0 = np.linalg.inv(poses[keys[0]])
        for k in keys:
            poses[k] = inv0 @ poses[k]
    return poses


def save_traj(txt, poses, format="kitti"):
    """Write absolute poses {id: 4x4}: ``kitti`` is the id and 12 numbers,
    ``tum`` the timestamp, translation and quaternion."""
    with open(txt, "w") as f:
        for i in poses:
            pose = poses[i]
            if format == "kitti":
                line = str(i) + " " + " ".join(str(v) for v in pose.flatten()[:12])
            elif format == "tum":
                qw, qx, qy, qz = rot2quat(pose[:3, :3])
                tx, ty, tz = pose[:3, 3]
                line = " ".join(str(v) for v in [i, tx, ty, tz, qx, qy, qz, qw])
            else:
                raise ValueError(f"unknown trajectory format: {format}")
            f.write(line + "\n")


def convert_SE3_to_arr(SE3_dict, timestamps=None):
    """{id: SE3} -> {timestamp: 4x4 array} (ids in order when no
    timestamps are given)."""
    poses_dict = {}
    keys = sorted(SE3_dict.keys()) if timestamps is None else timestamps
    for cnt, i in enumerate(SE3_dict):
        poses_dict[keys[cnt]] = SE3_dict[i].pose
    return poses_dict


# ---------------------------------------------------------------------------
# intrinsics files
# ---------------------------------------------------------------------------

_KITTI_RAW_H, _KITTI_RAW_W = 370.0, 1226.0


def _scaled_intrinsics(vals, new_h, new_w):
    return [
        vals[2] / _KITTI_RAW_W * new_w,
        vals[6] / _KITTI_RAW_H * new_h,
        vals[0] / _KITTI_RAW_W * new_w,
        vals[5] / _KITTI_RAW_H * new_h,
    ]


def load_kitti_odom_intrinsics(file_name, new_h, new_w):
    """KITTI odometry ``calib.txt`` -> {cam_id: [cx, cy, fx, fy]} rescaled
    from the raw 1226x370 resolution to (new_h, new_w)."""
    intrinsics = {}
    with open(file_name, "r") as f:
        for cnt, line in enumerate(f.readlines()):
            vals = [float(v) for v in line.split(" ")[1:]]
            intrinsics[cnt] = _scaled_intrinsics(vals, new_h, new_w)
    return intrinsics


def load_kitti_raw_intrinsics(file_name, new_h, new_w):
    """KITTI raw ``calib_cam_to_cam.txt`` (its ``P_rect`` lines), in the
    format of :func:`load_kitti_odom_intrinsics`."""
    intrinsics = {}
    with open(file_name, "r") as f:
        for line in f.readlines():
            if "P_rect" in line:
                vals = [float(v) for v in line.split(" ")[1:]]
                cnt = int(line.split(":")[0][-2:])
                intrinsics[cnt] = _scaled_intrinsics(vals, new_h, new_w)
    return intrinsics
