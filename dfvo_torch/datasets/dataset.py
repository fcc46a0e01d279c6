"""Abstract dataset loader.

Counterpart of ``dfvo_tpu/datasets/dataset.py``: a loader provides the
intrinsics, the data directories, the frame/depth/pose timestamp pairing,
the GT poses and the trajectory writer in the dataset's own format. Frames
are decoded on the host; uint8 arrays go to the device step.
"""

import numpy as np

from ..geometry.camera import Intrinsics


class Dataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.cam_intrinsics = Intrinsics(self.get_intrinsics_param())
        self.data_dir = self.get_data_dir()
        self.synchronize_timestamps()
        if self.cfg.directory.gt_pose_dir is not None:
            self.gt_poses = self.get_gt_poses()
        else:
            self.gt_poses = {0: np.eye(4)}

    def __len__(self):
        return len(self.rgb_d_pose_pair)

    # -- interface ---------------------------------------------------------
    def get_intrinsics_param(self):
        """-> [cx, cy, fx, fy] at the configured image size."""
        raise NotImplementedError

    def synchronize_timestamps(self):
        """Populate self.rgb_d_pose_pair: {rgb_ts: {'depth': ts, 'pose': ts}}."""
        raise NotImplementedError

    def get_data_dir(self):
        """-> {'img': dir, 'depth': dir or None, 'depth_src': 'gt' or None}."""
        raise NotImplementedError

    def get_gt_poses(self):
        """-> {frame: [4x4] array}."""
        raise NotImplementedError

    def get_timestamp(self, img_id):
        raise NotImplementedError

    def get_image(self, timestamp):
        """-> [H x W x 3] RGB uint8 array at the configured size."""
        raise NotImplementedError

    def get_depth(self, timestamp):
        """-> [H x W] depth array."""
        raise NotImplementedError

    def save_result_traj(self, traj_txt, poses):
        """Save a {frame: SE3} trajectory in the dataset's eval format."""
        raise NotImplementedError
