"""TUM RGB-D loader.

Counterpart of ``dfvo_tpu/datasets/tum.py``: RGB, depth and pose lists
associated within 0.02 s, per-sequence intrinsics rescaled from 480x640, GT
poses re-based to the first synchronised frame, ``depth_src: gt`` depths
(16-bit PNGs at 5000 per metre) and TUM-format trajectories.

The trajectory writer stamps the pose of frame id i with the i-th
synchronised timestamp. The JAX package stamps the k-th pose of the dict
with the k-th timestamp, which differs once ``frame_step`` > 1: there the
pose of frame 5k would carry the stamp of frame k.
"""

import os

import numpy as np

from ..evaluation.tum_tool import associate, read_file_list
from ..utils.io import load_poses_from_txt_tum, read_depth, read_image, save_traj
from .dataset import Dataset

TUM_INTRINSICS = {
    "tum-1": [318.6, 255.3, 517.3, 516.5],  # fr1
    "tum-2": [325.1, 249.7, 520.9, 521.0],  # fr2
    "tum-3": [320.1, 247.6, 535.4, 539.2],  # fr3
}
TUM_RAW_SIZE = (480.0, 640.0)  # (h, w)


class TUM(Dataset):
    """TUM RGB-D sequences: ``rgb.txt``, ``depth.txt`` and the pose list
    (``pose_file_name``) in the sequence directory."""

    pose_file_name = "groundtruth.txt"

    def __init__(self, cfg):
        super().__init__(cfg)
        if self.cfg.directory.gt_pose_dir is not None:
            self.update_gt_pose()

    def get_intrinsics_param(self):
        cx, cy, fx, fy = TUM_INTRINSICS[self.cfg.dataset]
        raw_h, raw_w = TUM_RAW_SIZE
        sy = self.cfg.image.height / raw_h
        sx = self.cfg.image.width / raw_w
        return [cx * sx, cy * sy, fx * sx, fy * sy]

    def get_data_dir(self):
        seq_dir = os.path.join(self.cfg.directory.img_seq_dir, self.cfg.seq)
        data_dir = {"img": os.path.join(seq_dir, "rgb"), "depth_src": self.cfg.depth.depth_src}
        if data_dir["depth_src"] == "gt":
            data_dir["depth"] = os.path.join(str(self.cfg.directory.depth_dir), self.cfg.seq,
                                             "depth")
        elif data_dir["depth_src"] is None:
            data_dir["depth"] = None
        else:
            raise ValueError(f"Wrong depth src [{data_dir['depth_src']}] is given.")
        return data_dir

    def synchronize_timestamps(self):
        """Associate RGB with depth and with pose stamps (0.02 s apart at
        most); frames lacking either are dropped."""
        base = os.path.join(self.data_dir["img"], "..")
        rgb_list = read_file_list(os.path.join(base, "rgb.txt"))
        depth_list = read_file_list(os.path.join(base, "depth.txt"))
        pose_list = read_file_list(os.path.join(base, self.pose_file_name))

        pairs = {t: {} for t in rgb_list}
        for rgb_t, d_t in associate(rgb_list, depth_list, 0, 0.02):
            pairs[rgb_t]["depth"] = d_t
        for rgb_t, p_t in associate(rgb_list, pose_list, 0, 0.02):
            pairs[rgb_t]["pose"] = p_t
        self.rgb_d_pose_pair = {t: v for t, v in pairs.items() if "depth" in v and "pose" in v}

    def update_gt_pose(self):
        """GT poses by synchronised frame index, re-based to the first."""
        stamps = sorted(self.rgb_d_pose_pair)
        inv0 = np.linalg.inv(self.gt_poses[self.rgb_d_pose_pair[stamps[0]]["pose"]])
        self.gt_poses = {i: inv0 @ self.gt_poses[self.rgb_d_pose_pair[t]["pose"]]
                         for i, t in enumerate(stamps)}

    def get_gt_poses(self):
        return load_poses_from_txt_tum(
            os.path.join(self.cfg.directory.gt_pose_dir, self.cfg.seq, self.pose_file_name))

    def get_timestamp(self, img_id):
        return sorted(self.rgb_d_pose_pair)[img_id]

    def image_name(self, timestamp):
        return f"{timestamp:.6f}"

    def get_image(self, timestamp):
        path = os.path.join(self.data_dir["img"],
                            f"{self.image_name(timestamp)}.{self.cfg.image.ext}")
        return read_image(path, self.cfg.image.height, self.cfg.image.width)

    def get_depth(self, timestamp):
        d_t = self.rgb_d_pose_pair[timestamp]["depth"]
        if self.data_dir["depth_src"] != "gt":
            raise ValueError("Proper depth loader should be defined.")
        return read_depth(os.path.join(self.data_dir["depth"], f"{self.image_name(d_t)}.png"),
                          5000, [self.cfg.image.height, self.cfg.image.width])

    def save_result_traj(self, traj_txt, poses):
        """{frame id: SE3} -> TUM lines, each stamped with its own frame's
        synchronised timestamp."""
        stamps = sorted(self.rgb_d_pose_pair)
        save_traj(traj_txt, {stamps[i]: poses[i].pose for i in poses}, format="tum")
