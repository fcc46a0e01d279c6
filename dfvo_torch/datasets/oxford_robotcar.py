"""Oxford RobotCar loader.

Counterpart of ``dfvo_tpu/datasets/oxford_robotcar.py``: frames undistorted
beforehand (``python -m dfvo_torch.tools.undistort_robotcar``) in
``<seq>/undistorted_stereo/centre`` named ``{timestamp:016d}``, the bottom
20 % cropped away (the vehicle's bonnet), the centre camera's intrinsics
from the SDK's model file with the principal point shifted and rescaled,
and GT poses interpolated from ``vo/vo.csv`` at ``stereo.timestamps``.
"""

import os
from glob import glob

import numpy as np

from ..utils.io import convert_SE3_to_arr, read_image, save_traj
from .dataset import Dataset
from .robotcar_sdk import interpolate_vo_poses

# RobotCar's VO frame -> the camera convention (x right, y down, z forward)
_T_PERM = np.array(
    [
        [0, 1, 0, 0],
        [0, 0, 1, 0],
        [1, 0, 0, 0],
        [0, 0, 0, 1],
    ],
    dtype=np.float64,
)


class OxfordRobotCar(Dataset):
    def __init__(self, cfg):
        self.time_offset = 0
        self.y_crop = [0.0, 0.8]
        self.x_crop = [0.0, 1.0]
        super().__init__(cfg)

    def get_intrinsics_param(self):
        ref_height, ref_width = 960, 1280
        intrinsic_txt = os.path.join(self.cfg.directory.img_seq_dir, "robotcar-dataset-sdk",
                                     "models", "stereo_narrow_left.txt")
        fx, fy, cx, cy = np.loadtxt(intrinsic_txt)[0][:4]
        K = np.eye(3)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        crop_h = int(ref_height * (self.y_crop[1] - self.y_crop[0]))
        crop_w = int(ref_width * (self.x_crop[1] - self.x_crop[0]))
        K[0, 2] -= int(ref_width * self.x_crop[0])
        K[1, 2] -= int(ref_height * self.y_crop[0])
        K[0] *= self.cfg.image.width / crop_w
        K[1] *= self.cfg.image.height / crop_h
        return [K[0, 2], K[1, 2], K[0, 0], K[1, 1]]

    def get_data_dir(self):
        img = os.path.join(self.cfg.directory.img_seq_dir, self.cfg.seq, "undistorted_stereo",
                           "centre")
        return {"img": img, "depth": None, "depth_src": None}

    def _timestamps(self, root):
        path = os.path.join(root, self.cfg.seq, "stereo.timestamps")
        return np.loadtxt(path)[:, 0].astype(np.int64)

    def synchronize_timestamps(self):
        timestamps = self._timestamps(self.cfg.directory.img_seq_dir)
        n = len(glob(os.path.join(self.data_dir["img"], f"*.{self.cfg.image.ext}")))
        self.rgb_d_pose_pair = {timestamps[i]: {"depth": i, "pose": i}
                                for i in range(self.time_offset, n)}

    def get_timestamp(self, img_id):
        return sorted(self.rgb_d_pose_pair)[img_id]

    def get_image(self, timestamp):
        path = os.path.join(self.data_dir["img"], f"{timestamp:016d}.{self.cfg.image.ext}")
        return read_image(path, self.cfg.image.height, self.cfg.image.width,
                          [self.y_crop, self.x_crop])

    def get_depth(self, timestamp):
        raise NotImplementedError("RobotCar provides no depth data")

    def get_gt_poses(self):
        timestamps = list(self._timestamps(self.cfg.directory.gt_pose_dir))
        vo_path = os.path.join(self.cfg.directory.gt_pose_dir, self.cfg.seq, "vo", "vo.csv")
        poses = interpolate_vo_poses(vo_path, timestamps, timestamps[self.time_offset])
        inv_perm = np.linalg.inv(_T_PERM)
        return {i - self.time_offset: _T_PERM @ np.asarray(poses[i]) @ inv_perm
                for i in range(self.time_offset, len(poses))}

    def save_result_traj(self, traj_txt, poses):
        save_traj(traj_txt, convert_SE3_to_arr(poses), format="kitti")
