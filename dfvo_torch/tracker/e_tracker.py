"""Essential-matrix tracker: 2D-2D pose and depth-ratio scale recovery.

Counterpart of ``dfvo_tpu/tracker/e_tracker.py`` (the reference's
E_tracker.py):

* H-vs-E model selection: a homography is fitted once, and each of the
  ``repeats`` RANSAC runs votes on validity with the best unpolished model
  of its own slice of one shared hypothesis pool;
* cheirality acceptance: more than 10 % of the keypoints in front of both
  cameras;
* scale from triangulated-vs-CNN depth ratios by 1-D RANSAC, -1 when 10 or
  fewer ratios are valid.
"""

import torch

from ..solvers.essential import find_essential_ransac, recover_pose, two_view_depths
from ..solvers.gric import calc_gric, fundamental_residual, homography_residual
from ..solvers.homography import find_homography_ransac
from ..solvers.linalg import batch_matrix
from ..solvers.scale import scale_ransac_1d
from ..utils.precision import highp

@highp
def compute_pose_2d2d(
    rng,
    kp_cur,
    kp_ref,
    valid_mask,
    K,
    K_inv,
    reproj_thre=0.2,
    repeats=5,
    num_hypotheses=256,
    validity_method="GRIC",
    validity_thre=0.0,
):
    """Pose (cur -> ref) from 2D-2D correspondences with model selection.

    Args:
        rng: PRNG key, or [... x 2] key words per frame (solvers/ransac.py).
        kp_cur, kp_ref: [... x N x 2] pixel correspondences, with optional
            leading frame axes (the JAX package vmaps over frames).
        valid_mask: [... x N] bool.
        K, K_inv: [3 x 3] intrinsics, or [... x 3 x 3] per frame.
        reproj_thre: RANSAC inlier threshold (pixels).
        repeats: RANSAC runs voting on validity (static).
        num_hypotheses: hypotheses per run (static).
        validity_method: 'GRIC' (vote H_gric > E_gric), 'flow' (mean flow
            above ``validity_thre``, then a cheirality vote), 'homo_ratio'
            (H/(H+E) inlier share below ``validity_thre``); any other
            value ('none') votes valid, as in the JAX package.
        validity_thre: cfg.e_tracker.validity.thre (flow / homo_ratio).

    Returns:
        dict with ``R`` [... x 3 x 3], ``t`` [... x 3] (unit, or zero when
        rejected), ``valid`` ([...] bool: majority vote and cheirality),
        ``inliers`` [... x N], ``inlier_cnt``.
    """
    n_valid = torch.sum(valid_mask, dim=-1)
    nf = n_valid.to(kp_cur.dtype)

    if validity_method == "GRIC":
        h_out = find_homography_ransac(rng, kp_cur, kp_ref, valid_mask, threshold=1.0,
                                       num_hypotheses=num_hypotheses)
        h_res = homography_residual(h_out["H"], kp_cur, kp_ref, mask=valid_mask)
        h_gric = calc_gric(h_res, 0.8, nf, "HMat", mask=valid_mask)
    elif validity_method == "homo_ratio":
        h_out = find_homography_ransac(rng, kp_cur, kp_ref, valid_mask, threshold=0.2,
                                       num_hypotheses=num_hypotheses)

    e_out = find_essential_ransac(
        rng, kp_cur, kp_ref, K, K_inv, valid_mask, threshold=reproj_thre,
        num_hypotheses=repeats * num_hypotheses, vote_slices=repeats,
    )

    # one validity vote per repeat slice, batched over the slices
    per_slice = (..., None)
    if validity_method == "GRIC":
        Kb = batch_matrix(K_inv, e_out["slice_Es"])
        F = Kb.mT @ e_out["slice_Es"] @ Kb
        e_res = fundamental_residual(F, kp_cur[..., None, :, :], kp_ref[..., None, :, :],
                                     mask=valid_mask[..., None, :])
        e_grics = calc_gric(e_res, 0.8, nf[per_slice], "EMat", mask=valid_mask[..., None, :])
        # the reference skips GRIC for 10 or fewer keypoints
        votes = (h_gric[per_slice] > e_grics) & (n_valid[per_slice] > 10)
    elif validity_method == "flow":
        flow_mag = torch.linalg.vector_norm(kp_ref - kp_cur, dim=-1)
        avg_flow = torch.sum(flow_mag * valid_mask, dim=-1) / torch.clamp(nf, min=1.0)
        _, _, cheirs = recover_pose(e_out["slice_Es"], kp_cur[..., None, :, :],
                                    kp_ref[..., None, :, :], K_inv,
                                    valid_mask[..., None, :].expand(
                                        valid_mask.shape[:-1] + (repeats, -1)))
        votes = (cheirs > n_valid[per_slice] * 0.1) & (avg_flow[per_slice] > validity_thre)
    elif validity_method == "homo_ratio":
        h_cnt = h_out["inlier_cnt"].to(kp_cur.dtype)[per_slice]
        ratios = h_cnt / torch.clamp(h_cnt + e_out["slice_cnts"].to(kp_cur.dtype), min=1.0)
        votes = ratios < validity_thre
    else:
        votes = torch.ones(valid_mask.shape[:-1] + (repeats,), dtype=torch.bool,
                           device=kp_cur.device)

    major_valid = torch.sum(votes, dim=-1) > repeats / 2
    accept = major_valid & (e_out["cheirality_cnt"] > n_valid * 0.1)
    eye = torch.eye(3, dtype=kp_cur.dtype, device=kp_cur.device)
    return {
        "R": torch.where(accept[..., None, None], e_out["R"], eye),
        "t": torch.where(accept[..., None], e_out["t"], torch.zeros_like(e_out["t"])),
        "valid": accept,
        "inliers": e_out["inliers"],
        "inlier_cnt": e_out["inlier_cnt"],
    }


@highp
def find_scale_from_depth(
    rng,
    kp_ref,
    kp_cur,
    valid_mask,
    T_ref_to_cur,
    depth_cur,
    K_inv,
    ransac_thre=0.1,
    max_trials=100,
    min_samples=3,
):
    """Metric scale of a unit-translation pose from triangulated depths
    against the CNN depth of the current view.

    Args:
        rng: PRNG key, or [... x 2] key words per frame.
        kp_ref, kp_cur: [... x N x 2] pixel correspondences (view 1 = ref,
            view 2 = cur), with optional leading frame axes.
        valid_mask: [... x N] bool.
        T_ref_to_cur: [... x 4 x 4] relative pose with unit translation.
        depth_cur: [... x H x W] preprocessed CNN depth of the current view
            (zeros = invalid).
        K_inv: [3 x 3] inverse intrinsics, or [... x 3 x 3] per frame.

    Returns:
        dict with ``scale`` (-1 when 10 or fewer ratios are valid) and
        ``valid_cnt``.
    """
    h, w = depth_cur.shape[-2:]

    def norm_h(kp):
        ph = torch.cat([kp, torch.ones_like(kp[..., :1])], dim=-1)
        return ph @ batch_matrix(K_inv, ph).mT

    _, z_cur = two_view_depths(T_ref_to_cur[..., :3, :3], T_ref_to_cur[..., :3, 3],
                               norm_h(kp_ref), norm_h(kp_cur))

    # CNN depth at the current keypoints' integer pixels (floor)
    xi = torch.floor(kp_cur[..., 0]).long()
    yi = torch.floor(kp_cur[..., 1]).long()
    in_bounds = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
    d_cnn = torch.gather(depth_cur.flatten(-2), -1, flat)

    ok = valid_mask & in_bounds & (z_cur > 0) & (d_cnn > 0)
    ratios = torch.where(ok, z_cur / torch.clamp(d_cnn, min=1e-12), torch.zeros_like(z_cur))
    valid_cnt = torch.sum(ok, dim=-1)
    fit = scale_ransac_1d(rng, ratios, ok, threshold=ransac_thre,
                          num_hypotheses=max_trials, min_samples=min_samples)
    scale = torch.where(valid_cnt > 10, fit["scale"], torch.full_like(fit["scale"], -1.0))
    return {"scale": scale, "valid_cnt": valid_cnt}
