"""Trajectory evaluation."""

from .kitti_odometry import KittiEvalOdom, umeyama_alignment

__all__ = ["KittiEvalOdom", "umeyama_alignment"]
