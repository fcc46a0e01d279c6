from .essential import (
    cheirality_count,
    decompose_essential,
    essential_from_sample,
    find_essential_ransac,
    recover_pose,
    sampson_error,
    two_view_depths,
)
from .gric import calc_gric, fundamental_residual, homography_residual
from .homography import find_homography_ransac, homography_transfer_error
from .pnp import solve_pnp_ransac
from .ransac import sample_indices, sample_points
from .scale import scale_ransac_1d
