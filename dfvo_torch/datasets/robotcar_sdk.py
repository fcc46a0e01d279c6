"""Oxford RobotCar SDK pieces: the camera model with its undistortion
look-up table, the Bayer demosaic, and pose interpolation.

Counterpart of ``dfvo_tpu/datasets/robotcar_sdk.py`` (the reference's
vendored ``camera_model.py``, ``image.py`` and ``interpolate_poses.py``):
host numpy and cv2. The demosaic is cv2's, as in the JAX package.
"""

import csv
import os

import numpy as np

from ..utils.io import quat2mat, rot2quat


class CameraModel:
    """RobotCar camera model: intrinsics and undistortion look-up table.

    ``models_dir`` holds ``<model>.txt`` ([fx fy cx cy] on the first line,
    the camera's G_camera_image on the next four when present) and
    ``<model>_distortion_lut.bin`` (float64 [2 x H*W], each pixel's source
    coordinates).
    """

    def __init__(self, models_dir, images_dir):
        self.camera = self._camera_name(images_dir)
        model = self._model_name(images_dir)
        vals = np.loadtxt(os.path.join(models_dir, model + ".txt"))
        self.focal_length = (vals[0][0], vals[0][1])
        self.principal_point = (vals[0][2], vals[0][3])
        self.G_camera_image = vals[1:5] if vals.shape[0] >= 5 else np.eye(4)
        lut = np.fromfile(os.path.join(models_dir, model + "_distortion_lut.bin"), np.double)
        self.lut = lut.reshape((2, lut.size // 2))

    @staticmethod
    def _camera_name(images_dir):
        if "stereo" in images_dir:
            return "stereo"
        for cam in ("mono_left", "mono_right", "mono_rear"):
            if cam in images_dir:
                return cam
        raise ValueError(f"cannot infer camera from path: {images_dir}")

    @staticmethod
    def _model_name(images_dir):
        if "stereo" not in images_dir:
            return CameraModel._camera_name(images_dir)
        if "left" in images_dir:
            return "stereo_wide_left"
        if "right" in images_dir:
            return "stereo_wide_right"
        return "stereo_narrow_left"  # the centre camera

    def undistort(self, image):
        """Bilinear look-up-table undistortion."""
        import cv2

        h, w = image.shape[:2]
        map_x = self.lut[0].reshape(h, w).astype(np.float32)
        map_y = self.lut[1].reshape(h, w).astype(np.float32)
        return cv2.remap(image, map_x, map_y, interpolation=cv2.INTER_LINEAR)


def load_image(image_path, model=None):
    """A raw RobotCar image, demosaiced (every camera is GBRG) and, with a
    ``model``, undistorted: [H x W x 3] RGB uint8."""
    import cv2

    raw = cv2.imread(image_path, cv2.IMREAD_GRAYSCALE)
    if raw is None:
        raise FileNotFoundError(image_path)
    img = cv2.cvtColor(raw, cv2.COLOR_BayerGB2RGB)
    if model is not None:
        img = model.undistort(img)
    return img


# ---------------------------------------------------------------------------
# pose interpolation
# ---------------------------------------------------------------------------

def _euler_to_rot(r, p, y):
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _rot_to_quat(R):
    return rot2quat(R)


def _slerp(q0, q1, f):
    dot = np.dot(q0, q1)
    if dot < 0:
        q1 = -q1
        dot = -dot
    dot = min(dot, 1.0)
    theta = np.arccos(dot)
    if theta < 1e-8:
        return q0
    s = np.sin(theta)
    return (np.sin((1 - f) * theta) * q0 + np.sin(f * theta) * q1) / s


def interpolate_poses(abs_poses, pose_timestamps, requested_timestamps, origin_timestamp):
    """Absolute poses at ``requested_timestamps``: rotations by slerp,
    translations linearly, clamped at both ends, re-based so that the pose
    at ``origin_timestamp`` is the identity. -> list of [4x4]."""
    pose_timestamps = np.asarray(pose_timestamps, np.int64)
    quats = np.array([_rot_to_quat(P[:3, :3]) for P in abs_poses])
    trans = np.array([P[:3, 3] for P in abs_poses])

    def interp_one(t):
        i = np.searchsorted(pose_timestamps, t)
        if i <= 0:
            return abs_poses[0]
        if i >= len(pose_timestamps):
            return abs_poses[-1]
        t0, t1 = pose_timestamps[i - 1], pose_timestamps[i]
        f = (t - t0) / max(t1 - t0, 1)
        q = _slerp(quats[i - 1], quats[i], f)
        P = np.eye(4)
        P[:3, :3] = quat2mat(q / np.linalg.norm(q))
        P[:3, 3] = (1 - f) * trans[i - 1] + f * trans[i]
        return P

    inv_origin = np.linalg.inv(interp_one(origin_timestamp))
    return [inv_origin @ interp_one(t) for t in requested_timestamps]


def interpolate_vo_poses(vo_path, pose_timestamps, origin_timestamp):
    """The relative VO poses of ``vo.csv`` (source_ts, dest_ts, x, y, z,
    roll, pitch, yaw) chained into absolute poses, then interpolated at
    ``pose_timestamps``."""
    abs_poses, stamps = [np.eye(4)], []
    with open(vo_path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            xyzrpy = [float(v) for v in row[2:8]]
            T_rel = np.eye(4)
            T_rel[:3, :3] = _euler_to_rot(*xyzrpy[3:])
            T_rel[:3, 3] = xyzrpy[:3]
            if not stamps:
                stamps.append(int(row[1]))
            abs_poses.append(abs_poses[-1] @ T_rel)
            stamps.append(int(row[0]))
    return interpolate_poses(abs_poses, stamps, pose_timestamps, origin_timestamp)


def interpolate_ins_poses(ins_path, pose_timestamps, origin_timestamp):
    """The INS poses of ``ins.csv`` (by its header's ``timestamp``,
    ``northing``, ``easting``, ``down``, ``roll``, ``pitch`` and ``yaw``)
    interpolated at ``pose_timestamps``."""
    abs_poses, stamps = [], []
    with open(ins_path) as f:
        reader = csv.reader(f)
        idx = {name: i for i, name in enumerate(next(reader))}
        for row in reader:
            T = np.eye(4)
            T[:3, :3] = _euler_to_rot(float(row[idx["roll"]]), float(row[idx["pitch"]]),
                                      float(row[idx["yaw"]]))
            T[:3, 3] = [float(row[idx["northing"]]), float(row[idx["easting"]]),
                        float(row[idx["down"]])]
            abs_poses.append(T)
            stamps.append(int(row[idx["timestamp"]]))
    return interpolate_poses(abs_poses, stamps, pose_timestamps, origin_timestamp)
