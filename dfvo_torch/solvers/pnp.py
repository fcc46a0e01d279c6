"""Batched RANSAC PnP (3D-2D pose) with Gauss-Newton refinement.

Counterpart of ``dfvo_tpu/solvers/pnp.py`` (the reference's
``cv2.solvePnPRansac``). Three minimal solvers per sample feed one scoring
pass: a 6-point projection-matrix DLT (general scenes), a plane-homography
decomposition (coplanar scenes) and Grunert P3P on the first three points
(low inlier ratios). The winner is polished by Gauss-Newton on its inlier
set and kept only if that does not lower its score.

Convention: x ~ K (R X + t), (R, t) map object-frame (reference-view)
points into the image (current) camera, as ``cv2.solvePnP``.
"""

import torch
import torch.nn.functional as F

from ..geometry.lie import skew, so3_exp
from ..utils.precision import highp
from .homography import homography_from_sample
from .linalg import (batch_entry, batch_matrix, det3, nearest_rotation, nullspace_vector,
                     smallest_eigvec_3x3, spd_solve_small)
from .p3p import p3p_solutions
from .ransac import pick, sample_points


@highp
def pnp_from_sample(X, x_norm, weights=None, iters=6):
    """DLT estimate of [R|t] from object points [... x N x 3] (N >= 6) and
    normalised image points [... x N x 2], optionally weighted.

    Returns:
        (R [... x 3 x 3], t [... x 3]).
    """
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    u = x_norm[..., 0:1]
    v = x_norm[..., 1:2]
    zero4 = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero4, -u * Xh], dim=-1)
    r2 = torch.cat([zero4, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    M = nullspace_vector(A, iters=iters).reshape(A.shape[:-2] + (3, 4))
    # projective sign so that det(M[:, :3]) > 0 (a proper rotation)
    M = M * torch.sign(det3(M[..., :3]))[..., None, None]
    R, scale = nearest_rotation(M[..., :3])
    return R, M[..., 3] / torch.clamp(scale, min=1e-12)[..., None]


@highp
def pnp_from_sample_planar(X, x_norm):
    """Pose of (near-)coplanar samples from the plane -> image homography:
    fit the sample's plane, express the points in an in-plane basis,
    estimate the homography and decompose it (Zhang's pose from a
    homography).

    Args:
        X: [... x N x 3] object points (N >= 4).
        x_norm: [... x N x 2] normalised image coordinates.

    Returns:
        (R [... x 3 x 3], t [... x 3]).
    """
    m = torch.mean(X, dim=-2)
    Xc = X - m[..., None, :]
    normal = smallest_eigvec_3x3(Xc.transpose(-1, -2) @ Xc)
    a = F.one_hot(torch.argmin(torch.abs(normal), dim=-1), 3).to(X.dtype)
    e1 = torch.linalg.cross(normal, a, dim=-1)
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=1e-30)
    e2 = torch.linalg.cross(normal, e1, dim=-1)
    B = torch.stack([e1, e2, normal], dim=-1)  # world -> plane basis (columns)
    w = Xc @ B

    ones = torch.ones_like(w[..., :1])
    H = homography_from_sample(torch.cat([w[..., :2], ones], dim=-1),
                               torch.cat([x_norm, ones], dim=-1))
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 2.0 / torch.clamp(torch.linalg.vector_norm(h1, dim=-1)
                            + torch.linalg.vector_norm(h2, dim=-1), min=1e-12)
    r1 = h1 * lam[..., None]
    r2 = h2 * lam[..., None]
    t_p = h3 * lam[..., None]
    # cheirality of the plane centroid (w = 0 maps to t_p)
    sign = torch.where(t_p[..., 2:3] < 0, -1.0, 1.0)
    r1, r2, t_p = r1 * sign, r2 * sign, t_p * sign
    R_p, _ = nearest_rotation(
        torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1))
    # X_cam = R_p B^T (X - m) + t_p
    R = R_p @ B.transpose(-1, -2)
    return R, t_p - (R @ m[..., None])[..., 0]


@highp
def _reproj_err_sq(R, t, X, x_pix, K):
    """Squared pixel reprojection errors [... x N] of object points
    [... x N x 3] under poses (R [... x 3 x 3], t [... x 3]; the points'
    leading axes broadcast against R's) and intrinsics [3 x 3] or with the
    points' leading frame axes; points behind the camera get +inf."""
    X0, X1, X2 = X[..., 0], X[..., 1], X[..., 2]
    r = [[R[..., a, b, None] for b in range(3)] for a in range(3)]
    tb = [t[..., a, None] for a in range(3)]
    px = r[0][0] * X0 + r[0][1] * X1 + r[0][2] * X2 + tb[0]
    py = r[1][0] * X0 + r[1][1] * X1 + r[1][2] * X2 + tb[1]
    z = r[2][0] * X0 + r[2][1] * X1 + r[2][2] * X2 + tb[2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    fx, s, cx, fy, cy = (batch_entry(K, i, j, px) for i, j in
                         ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2)))
    u = fx * (px / zs) + s * (py / zs) + cx
    v = fy * (py / zs) + cy
    err = (u - x_pix[..., 0]) ** 2 + (v - x_pix[..., 1]) ** 2
    return torch.where(z > 0, err, torch.full_like(err, float("inf")))


@highp
def _gauss_newton_refine(R, t, X, x_pix, K, weight, iters=10):
    """Fixed-iteration Gauss-Newton on SE(3) (left-multiplicative update)
    minimising the weighted pixel reprojection error."""
    zero = torch.zeros_like(X[..., 0])
    fx, fy = batch_entry(K, 0, 0, zero), batch_entry(K, 1, 1, zero)
    cx, cy = batch_entry(K, 0, 2, zero), batch_entry(K, 1, 2, zero)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        P = X @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp(P[..., 2], min=1e-6)
        u = fx * P[..., 0] / z + cx
        v = fy * P[..., 1] / z + cy
        r = torch.stack([u - x_pix[..., 0], v - x_pix[..., 1]], dim=-1)
        du = torch.stack([fx / z, zero, -fx * P[..., 0] / z ** 2], dim=-1)
        dv = torch.stack([zero, fy / z, -fy * P[..., 1] / z ** 2], dim=-1)
        J_p = torch.stack([du, dv], dim=-2)  # [... x N x 2 x 3]
        dP = torch.cat([-skew(P), eye.expand(P.shape[:-1] + (3, 3))], dim=-1)  # [... x N x 3 x 6]
        J = J_p @ dP  # [... x N x 2 x 6]
        Jw = J * weight[..., None, None]
        H = torch.einsum("...nki,...nkj->...ij", Jw, J) + 1e-6 * torch.eye(
            6, dtype=R.dtype, device=R.device)
        b = torch.einsum("...nki,...nk->...i", Jw, r)
        delta = -spd_solve_small(H, b)
        dR = so3_exp(delta[..., :3])
        R, t = dR @ R, (dR @ t[..., None])[..., 0] + delta[..., 3:]
    return R, t


@highp
def solve_pnp_ransac(
    rng,
    X,
    x_pix,
    K,
    K_inv,
    valid_mask,
    reproj_threshold=1.0,
    num_hypotheses=256,
    refine_iters=10,
):
    """Batched RANSAC PnP.

    Args:
        rng: PRNG key, or [... x 2] key words per frame (solvers/ransac.py).
        X: [... x N x 3] object (reference-view) points, with optional
            leading frame axes.
        x_pix: [... x N x 2] observed pixels in the current view.
        K, K_inv: [3 x 3] intrinsics, or [... x 3 x 3] per frame.
        valid_mask: [... x N] bool.
        reproj_threshold: inlier threshold (pixels).
        num_hypotheses: 6-point samples (static).
        refine_iters: Gauss-Newton iterations on the winner (static).

    Returns:
        dict with ``R`` [... x 3 x 3], ``t`` [... x 3], ``inliers``
        [... x N], ``inlier_cnt``, ``ok`` (more than 4 inliers).
    """
    nb = valid_mask.dim() - 1
    x_h = torch.cat([x_pix, torch.ones_like(x_pix[..., :1])], dim=-1)
    x_norm = (x_h @ batch_matrix(K_inv, x_h).mT)[..., :2]
    samp = sample_points(rng, torch.cat([X, x_norm], dim=-1), valid_mask,
                         num_hypotheses, 6)
    Xs, xs = samp[..., :3], samp[..., 3:]
    thr2 = reproj_threshold ** 2
    vmask = valid_mask.to(X.dtype)
    r_norm = thr2 * (torch.sum(valid_mask, dim=-1).to(torch.float32) + 1.0)

    def fscore(errs, inl, vm, rn):
        rsum = torch.sum(torch.clamp(errs, max=thr2) * vm, dim=-1)
        return torch.sum(inl, dim=-1).to(torch.float32) - rsum / rn

    # the three minimal solvers on every sample; P3P gives four poses each
    Rd, td = pnp_from_sample(Xs, xs)
    Rp, tp = pnp_from_sample_planar(Xs, xs)
    R3, t3, ok3 = p3p_solutions(Xs[..., :3, :], xs[..., :3, :])
    lead = valid_mask.shape[:-1]
    Rs = torch.cat([Rd, Rp, R3.reshape(lead + (-1, 3, 3))], dim=-3)
    ts = torch.cat([td, tp, t3.reshape(lead + (-1, 3))], dim=-2)
    cand_ok = torch.cat([torch.ones(lead + (2 * num_hypotheses,), dtype=torch.bool,
                                    device=X.device), ok3.reshape(lead + (-1,))], dim=-1)
    errs = _reproj_err_sq(Rs, ts, X[..., None, :, :], x_pix[..., None, :, :], K)
    inliers = (errs < thr2) & valid_mask[..., None, :]
    scores = torch.where(cand_ok, fscore(errs, inliers, vmask[..., None, :], r_norm[..., None]),
                         torch.full_like(r_norm[..., None], -1.0))

    best = torch.argmax(scores, dim=-1)
    R0, t0, inl_best = pick(Rs, best, nb), pick(ts, best, nb), pick(inliers, best, nb)
    R1, t1 = _gauss_newton_refine(R0, t0, X, x_pix, K, inl_best.to(X.dtype),
                                  iters=refine_iters)
    refined_err = _reproj_err_sq(R1, t1, X, x_pix, K)
    refined_inl = (refined_err < thr2) & valid_mask
    refined_cnt = torch.sum(refined_inl, dim=-1)

    use_ref = fscore(refined_err, refined_inl, vmask, r_norm) >= pick(scores, best, nb)
    cnt = torch.where(use_ref, refined_cnt, torch.sum(inl_best, dim=-1))
    return {
        "R": torch.where(use_ref[..., None, None], R1, R0),
        "t": torch.where(use_ref[..., None], t1, t0),
        "inliers": torch.where(use_ref[..., None], refined_inl, inl_best),
        "inlier_cnt": cnt,
        "ok": cnt > 4,
    }
