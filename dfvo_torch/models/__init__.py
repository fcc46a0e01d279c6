from .hd3 import HD3Net
from .liteflownet import LiteFlowNet
from .monodepth2 import Monodepth2Depth, Monodepth2Pose, disp_to_depth

__all__ = ["HD3Net", "LiteFlowNet", "Monodepth2Depth", "Monodepth2Pose", "disp_to_depth"]
