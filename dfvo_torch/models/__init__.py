from .liteflownet import LiteFlowNet
from .monodepth2 import Monodepth2Depth, Monodepth2Pose, disp_to_depth

__all__ = ["LiteFlowNet", "Monodepth2Depth", "Monodepth2Pose", "disp_to_depth"]
