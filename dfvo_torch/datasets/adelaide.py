"""Adelaide driving sequences: the loader for a dataset of one's own.

Counterpart of ``dfvo_tpu/datasets/adelaide.py``: ``%06d`` frames, the
camera matrix in ``cam.txt`` at the capture size, no ground truth.
"""

import os
from glob import glob

import numpy as np

from ..utils.io import convert_SE3_to_arr, read_image, save_traj
from .dataset import Dataset

# capture sizes per camera (h, w)
_RAW_SIZE = {"adelaide1": (256, 832), "adelaide2": (512, 1664)}


class Adelaide(Dataset):
    def _seq_dir(self):
        return os.path.join(self.cfg.directory.img_seq_dir, self.cfg.seq)

    def get_intrinsics_param(self):
        raw_h, raw_w = _RAW_SIZE[self.cfg.dataset]
        K = np.loadtxt(os.path.join(self._seq_dir(), "cam.txt")).copy()
        K[0] *= self.cfg.image.width / raw_w
        K[1] *= self.cfg.image.height / raw_h
        return [K[0, 2], K[1, 2], K[0, 0], K[1, 1]]

    def get_data_dir(self):
        return {"img": self._seq_dir(), "depth": None, "depth_src": None}

    def synchronize_timestamps(self):
        n = len(glob(os.path.join(self.data_dir["img"], f"*.{self.cfg.image.ext}")))
        self.rgb_d_pose_pair = {i: {"depth": i, "pose": i} for i in range(n)}

    def get_gt_poses(self):
        return {0: np.eye(4)}

    def get_timestamp(self, img_id):
        return img_id

    def get_image(self, timestamp):
        path = os.path.join(self.data_dir["img"], f"{timestamp:06d}.{self.cfg.image.ext}")
        return read_image(path, self.cfg.image.height, self.cfg.image.width)

    def get_depth(self, timestamp):
        raise NotImplementedError("Adelaide has no depth data")

    def save_result_traj(self, traj_txt, poses):
        save_traj(traj_txt, convert_SE3_to_arr(poses), format="kitti")
