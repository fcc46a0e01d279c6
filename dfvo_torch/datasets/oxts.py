"""KITTI raw OXTS (GPS/IMU) ground-truth poses.

Counterpart of ``dfvo_tpu/datasets/oxts.py``: Mercator projection of
lat/lon to metres, roll/pitch/yaw to a rotation, and the pose relative to
frame 0 re-expressed in the camera convention (x right, y down, z forward).
"""

import os
from glob import glob

import numpy as np

EARTH_RADIUS = 6378137.0

# GPS/IMU (x fwd, y left, z up) -> camera (x right, y down, z fwd)
_IMU_TO_CAM = np.array(
    [
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
        [1.0, 0.0, 0.0],
    ]
)


def _rotx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _read_oxts_line(path):
    with open(path, "r") as f:
        vals = f.readline().split()
    return [float(v) for v in vals]


def _gps_pose(vals, scale):
    lat, lon, alt, roll, pitch, yaw = vals[:6]
    tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    T = np.eye(4)
    T[:3, :3] = _rotz(yaw) @ _roty(pitch) @ _rotx(roll)
    T[:3, 3] = [tx, ty, alt]
    return T


def generate_pose(oxts_dir, frame_idx):
    """Camera-convention pose of ``frame_idx`` relative to frame 0."""
    v0 = _read_oxts_line(os.path.join(oxts_dir, f"{0:010d}.txt"))
    vi = _read_oxts_line(os.path.join(oxts_dir, f"{frame_idx:010d}.txt"))
    scale = np.cos(v0[0] * np.pi / 180.0)
    T_01 = np.linalg.inv(_gps_pose(v0, scale)) @ _gps_pose(vi, scale)
    C = np.eye(4)
    C[:3, :3] = _IMU_TO_CAM
    return C @ T_01 @ np.linalg.inv(C)


def load_poses_from_oxts(oxts_dir):
    """{frame: [4x4]} poses for a whole raw drive."""
    n = len(glob(os.path.join(oxts_dir, "*.txt")))
    if n == 0:
        raise FileNotFoundError(f"Wrong path is given: [{oxts_dir}]")
    return {i: generate_pose(oxts_dir, i) for i in range(n)}
