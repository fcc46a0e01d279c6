"""Oxford (Radar) RobotCar LiDAR and radar readers.

Counterpart of ``dfvo_tpu/datasets/robotcar_lidar.py`` (the reference's
vendored SDK ``velodyne.py``, ``radar.py`` and ``build_pointcloud.py``):
Velodyne binary and raw PNG scans, their point clouds, radar scans from
polar to Cartesian, and point clouds merged over a time window. The VO
loop does not use them; they serve dataset preparation. Host numpy and cv2.
"""

import os
import re

import numpy as np

from .robotcar_sdk import _euler_to_rot, interpolate_vo_poses

# HDL-32E geometry (interleaved firing order elevations, radians)
_HDL32E_ELEVATIONS = -np.radians(
    np.array(
        [
            30.67, 9.33, 29.33, 8.0, 28.0, 6.66, 26.66, 5.33, 25.33, 4.0,
            24.0, 2.67, 22.67, 1.33, 21.33, 0.0, 20.0, -1.33, 18.67, -2.67,
            17.33, -4.0, 16.0, -5.33, 14.67, -6.67, 13.33, -8.0, 12.0,
            -9.33, 10.67, -10.67,
        ]
    )
)[:, np.newaxis]
_HDL32E_RANGE_RESOLUTION = 0.002  # m / tick
_HDL32E_MIN_RANGE = 1.0
_HDL32E_BASE_TO_FIRE = 0.090805


def load_velodyne_binary(path):
    """'<timestamp>.bin' -> [4 x N] XYZI pointcloud (not motion
    compensated; ref velodyne.py:33-51)."""
    if os.path.splitext(path)[1] != ".bin":
        raise RuntimeError(f"expected .bin velodyne file, got: {path}")
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape((4, -1))


def load_velodyne_raw(path):
    """'<timestamp>.png' raw packet image -> (ranges [32xN] m,
    intensities [32xN], angles [1xN] rad, approx timestamps [1xN])
    (ref velodyne.py:54-82)."""
    import cv2

    if os.path.splitext(path)[1] != ".png":
        raise RuntimeError(f"expected .png raw velodyne file, got: {path}")
    example = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    intensities, ranges_raw, angles_raw, ts_raw = np.array_split(
        example, [32, 96, 98], 0
    )
    ranges = (
        np.ascontiguousarray(ranges_raw.transpose())
        .view(np.uint16)
        .transpose()
        * _HDL32E_RANGE_RESOLUTION
    )
    angles = (
        np.ascontiguousarray(angles_raw.transpose())
        .view(np.uint16)
        .transpose()
        * (2.0 * np.pi)
        / 36000
    )
    timestamps = (
        np.ascontiguousarray(ts_raw.transpose()).view(np.int64).transpose()
    )
    return ranges, intensities, angles, timestamps


def velodyne_raw_to_pointcloud(ranges, intensities, angles):
    """Raw returns -> [4 x N] XYZI pointcloud (ref velodyne.py:85-110)."""
    valid = ranges > _HDL32E_MIN_RANGE
    z = np.sin(_HDL32E_ELEVATIONS) * ranges - _HDL32E_BASE_TO_FIRE
    xy = np.cos(_HDL32E_ELEVATIONS) * ranges
    x = np.sin(angles) * xy
    y = -np.cos(angles) * xy
    return np.stack(
        (
            x[valid].reshape(-1),
            y[valid].reshape(-1),
            z[valid].reshape(-1),
            intensities[valid].reshape(-1).astype(np.float32),
        ),
        0,
    )


def load_radar(path):
    """Radar scan png -> (timestamps [Ax1], azimuths [Ax1] rad, valid
    [Ax1], fft_data [AxRx1] in [0,1], resolution m/px)
    (ref radar.py:20-43)."""
    import cv2

    radar_resolution = np.array([0.0432], np.float32)
    encoder_size = 5600
    raw = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    timestamps = raw[:, :8].copy().view(np.int64)
    azimuths = (
        raw[:, 8:10].copy().view(np.uint16) / float(encoder_size) * 2 * np.pi
    ).astype(np.float32)
    valid = raw[:, 10:11] == 255
    fft_data = raw[:, 11:].astype(np.float32)[:, :, np.newaxis] / 255.0
    return timestamps, azimuths, valid, fft_data, radar_resolution


def radar_polar_to_cartesian(
    azimuths,
    fft_data,
    radar_resolution,
    cart_resolution,
    cart_pixel_width,
    interpolate_crossover=True,
):
    """Polar radar scan -> square cartesian image (ref radar.py:45-110)."""
    import cv2

    if (cart_pixel_width % 2) == 0:
        cart_min_range = (cart_pixel_width / 2 - 0.5) * cart_resolution
    else:
        cart_min_range = cart_pixel_width // 2 * cart_resolution
    coords = np.linspace(
        -cart_min_range, cart_min_range, cart_pixel_width, dtype=np.float32
    )
    Y, X = np.meshgrid(coords, -coords)
    sample_range = np.sqrt(Y * Y + X * X)
    sample_angle = np.arctan2(Y, X)
    sample_angle += (sample_angle < 0).astype(np.float32) * 2.0 * np.pi

    sample_u = (sample_range - radar_resolution / 2) / radar_resolution
    sample_v = (sample_angle - azimuths[0]) / (azimuths[1] - azimuths[0])
    sample_u[sample_u < 0] = 0

    if interpolate_crossover:
        fft_data = np.concatenate(
            (fft_data[-1:], fft_data, fft_data[:1]), 0
        )
        sample_v = sample_v + 1

    polar_to_cart_warp = np.stack((sample_u, sample_v), -1)
    return np.expand_dims(
        cv2.remap(
            fft_data[..., 0].astype(np.float32),
            polar_to_cart_warp[..., 0].astype(np.float32),
            polar_to_cart_warp[..., 1].astype(np.float32),
            cv2.INTER_LINEAR,
        ),
        -1,
    )


def build_pointcloud(
    lidar_dir, poses_file, extrinsics_dir, start_time, end_time, origin_time=-1
):
    """Combine LiDAR scans in a time window into one pointcloud in the
    frame of ``origin_time`` (ref build_pointcloud.py:24-110, simplified to
    the VO-interpolated pose path).

    Returns:
        (pointcloud [4 x N] homogeneous, reflectance [N] or None).
    """
    if origin_time < 0:
        origin_time = start_time
    lidar = re.search(
        r"(lms_front|lms_rear|ldmrs|velodyne_left|velodyne_right)",
        lidar_dir,
    ).group(0)
    timestamps_path = os.path.join(
        os.path.dirname(lidar_dir), f"{lidar}.timestamps"
    )
    timestamps = [
        int(line.split(" ")[0])
        for line in open(timestamps_path)
        if start_time <= int(line.split(" ")[0]) <= end_time
    ]
    if not timestamps:
        raise ValueError("no LiDAR scans in the requested time window")

    # extrinsics: lidar -> vehicle
    with open(os.path.join(extrinsics_dir, f"{lidar}.txt")) as f:
        vals = [float(v) for v in f.readline().split(" ")]
    G_vehicle_lidar = np.eye(4)
    G_vehicle_lidar[:3, :3] = _euler_to_rot(*vals[3:6])
    G_vehicle_lidar[:3, 3] = vals[:3]

    poses = interpolate_vo_poses(poses_file, timestamps, origin_time)

    pointcloud = np.array([[0.0], [0.0], [0.0], [0.0]])
    reflectance = np.empty((0,))
    for i, ts in enumerate(timestamps):
        if "velodyne" in lidar:
            scan_path = os.path.join(lidar_dir, f"{ts}.bin")
            if os.path.isfile(scan_path):
                ptcld = load_velodyne_binary(scan_path)
            else:
                ranges, intens, angles, _ = load_velodyne_raw(
                    os.path.join(lidar_dir, f"{ts}.png")
                )
                ptcld = velodyne_raw_to_pointcloud(ranges, intens, angles)
            refl = ptcld[3]
            scan = np.concatenate(
                [ptcld[:3], np.ones((1, ptcld.shape[1]))], 0
            )
        else:
            scan_file = os.path.join(lidar_dir, f"{ts}.bin")
            scan = np.fromfile(scan_file, np.double).reshape(
                (-1, 3)
            ).transpose()
            refl = (
                scan[2] if lidar.startswith("lms") else np.empty(0)
            )
            if lidar.startswith("lms"):
                scan[2] = np.zeros((1, scan.shape[1]))
            scan = np.concatenate(
                [scan, np.ones((1, scan.shape[1]))], 0
            )
        scan = np.dot(
            np.dot(poses[i], G_vehicle_lidar), scan
        )
        pointcloud = np.hstack([pointcloud, scan])
        reflectance = np.concatenate([reflectance, refl])
    return pointcloud[:, 1:], reflectance
