"""Trajectory evaluation: KITTI odometry and the TUM RGB-D toolkit."""

from .kitti_odometry import KittiEvalOdom, umeyama_alignment
from .tum_tool import (
    align_horn,
    associate,
    compute_ate,
    dump_pose_seq_TUM,
    euler2mat,
    euler2quat,
    mat2euler,
    pose_vec_to_mat,
    read_file_list,
)

__all__ = [
    "KittiEvalOdom", "umeyama_alignment", "align_horn", "associate", "compute_ate",
    "dump_pose_seq_TUM", "euler2mat", "euler2quat", "mat2euler", "pose_vec_to_mat",
    "read_file_list",
]
