from .e_tracker import compute_pose_2d2d, find_scale_from_depth
from .pnp_tracker import compute_pose_3d2d
