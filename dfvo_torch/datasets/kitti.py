"""KITTI odometry and raw loaders.

Counterpart of ``dfvo_tpu/datasets/kitti.py``: integer frame ids, the
odometry split's ``calib.txt`` and GT pose files, the raw recordings'
``calib_cam_to_cam.txt`` and OXTS poses, and KITTI-format trajectories.
"""

import os
from glob import glob

from ..utils.io import (
    convert_SE3_to_arr,
    load_kitti_odom_intrinsics,
    load_kitti_raw_intrinsics,
    load_poses_from_txt,
    read_depth,
    read_image,
    save_traj,
)
from .dataset import Dataset
from .oxts import load_poses_from_oxts


class KITTI(Dataset):
    """What the two KITTI layouts share."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stereo_baseline = 0.54

    def synchronize_timestamps(self):
        pattern = os.path.join(self.data_dir["img"], f"*.{self.cfg.image.ext}")
        self.rgb_d_pose_pair = {i: {"depth": i, "pose": i}
                                for i in range(len(glob(pattern)))}

    def get_timestamp(self, img_id):
        return img_id

    def save_result_traj(self, traj_txt, poses):
        save_traj(traj_txt, convert_SE3_to_arr(poses), format="kitti")

    def _depth_dir(self, gt_dir):
        src = self.cfg.depth.depth_src
        if src == "gt":
            return gt_dir
        if src is None:
            return None
        raise ValueError(f"Wrong depth src [{src}] is given.")

    def get_image(self, timestamp):
        return read_image(self.get_image_path(timestamp), self.cfg.image.height,
                          self.cfg.image.width)


class KittiOdom(KITTI):
    """KITTI odometry split (sequences 00-21, ``calib.txt`` intrinsics)."""

    def _seq_dir(self):
        return os.path.join(self.cfg.directory.img_seq_dir, self.cfg.seq)

    def get_intrinsics_param(self):
        return load_kitti_odom_intrinsics(
            os.path.join(self._seq_dir(), "calib.txt"),
            self.cfg.image.height, self.cfg.image.width,
        )[2]

    def get_data_dir(self):
        return {
            "img": os.path.join(self._seq_dir(), "image_2"),
            "depth_src": self.cfg.depth.depth_src,
            "depth": self._depth_dir(
                os.path.join(str(self.cfg.directory.depth_dir), "gt", self.cfg.seq)),
        }

    def get_gt_poses(self):
        return load_poses_from_txt(
            os.path.join(self.cfg.directory.gt_pose_dir, f"{self.cfg.seq}.txt"))

    def get_image_path(self, timestamp):
        return os.path.join(self.data_dir["img"], f"{timestamp:06d}.{self.cfg.image.ext}")

    def get_depth(self, timestamp):
        img_id = self.rgb_d_pose_pair[timestamp]["depth"]
        if self.data_dir["depth_src"] == "gt":
            img_name, scale_factor = f"{img_id:010d}.png", 500
        else:
            img_name, scale_factor = f"depth/{img_id:06d}.png", 1000
        return read_depth(os.path.join(self.data_dir["depth"], img_name), scale_factor,
                          [self.cfg.image.height, self.cfg.image.width])


class KittiRaw(KITTI):
    """KITTI raw recordings (drive directories, OXTS GPS/IMU poses)."""

    def get_intrinsics_param(self):
        date_dir = os.path.join(self.cfg.directory.img_seq_dir, self.cfg.seq[:10])
        return load_kitti_raw_intrinsics(
            os.path.join(date_dir, "calib_cam_to_cam.txt"),
            self.cfg.image.height, self.cfg.image.width,
        )[2]

    def get_data_dir(self):
        seq_dir = os.path.join(self.cfg.directory.img_seq_dir, self.cfg.seq[:10], self.cfg.seq)
        return {
            "img": os.path.join(seq_dir, "image_02/data"),
            "depth_src": self.cfg.depth.depth_src,
            "depth": self._depth_dir(
                os.path.join(str(self.cfg.directory.depth_dir), self.cfg.seq)),
        }

    def get_gt_poses(self):
        return load_poses_from_oxts(os.path.join(
            self.cfg.directory.gt_pose_dir, self.cfg.seq[:10], self.cfg.seq, "oxts/data"))

    def get_image_path(self, timestamp):
        return os.path.join(self.data_dir["img"], f"{timestamp:010d}.{self.cfg.image.ext}")

    def get_depth(self, timestamp):
        img_id = self.rgb_d_pose_pair[timestamp]["depth"]
        return read_depth(os.path.join(self.data_dir["depth"], f"{img_id:010d}.png"), 500,
                          [self.cfg.image.height, self.cfg.image.width])
