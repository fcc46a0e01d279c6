"""Batched essential-matrix estimation with pose recovery.

Counterpart of ``dfvo_tpu/solvers/essential.py`` (the DF-VO reference's
``cv2.findEssentialMat`` + ``cv2.recoverPose``): 8-point DLT hypotheses,
all scored at once by the Sampson distance with an MSAC residual
tiebreak, then a multi-start local optimisation of the best few (guarded
DLT refits, cheirality vote, guarded Gauss-Newton on (R, t)).

Conventions: ``kp1`` are pixels in the current view, ``kp2`` in the
reference view; the recovered (R, t) satisfy x2 ~ R x1 + t. Functions take
leading batch dimensions where the JAX package vmaps (hypotheses, starts,
vote slices).
"""

import torch

from ..geometry.lie import skew, so3_exp
from ..utils.precision import highp
from .linalg import batch_matrix, essential_uv_closed, nullspace_vector, spd_solve_small
from .ransac import pick, sample_points


def _homogeneous(kp):
    return torch.cat([kp, torch.ones_like(kp[..., :1])], dim=-1)


def _normalize(kp, K_inv):
    """Pixels [... x 2] -> homogeneous normalised camera coordinates;
    ``K_inv`` is [3 x 3] or has the keypoints' leading frame axes."""
    ph = _homogeneous(kp)
    return ph @ batch_matrix(K_inv, ph).mT


def _project_to_essential(E):
    """Project 3x3 matrices onto the essential manifold (singular values
    1, 1, 0) with the closed-form SVD frames."""
    U, V, _ = essential_uv_closed(E)
    return (U[..., :, :1] @ V[..., :, :1].transpose(-1, -2)
            + U[..., :, 1:2] @ V[..., :, 1:2].transpose(-1, -2))


@highp
def essential_from_sample(x1, x2, weights=None, project=True, iters=10):
    """DLT estimate of E from normalised correspondences [... x N x 3]
    (rows kron(x2, x1), so that x2^T E x1 = 0), optionally weighted
    ([... x N]) and projected onto the essential manifold.

    Returns:
        [... x 3 x 3] essential matrices (up to scale).
    """
    A = (x2[..., :, None] * x1[..., None, :]).reshape(x1.shape[:-1] + (9,))
    if weights is not None:
        A = A * weights[..., None]
    E = nullspace_vector(A, iters=iters).reshape(A.shape[:-2] + (3, 3))
    return _project_to_essential(E) if project else E


@highp
def sampson_error(F, p1, p2):
    """Squared Sampson distances [... x N] of homogeneous pixel
    correspondences p1, p2 [... x N x 3] under fundamental matrices
    F [... x 3 x 3] (p2^T F p1 = 0; the points' leading axes broadcast
    against F's), written component-wise as in the JAX package."""
    x1, y1, z1 = p1[..., 0], p1[..., 1], p1[..., 2]
    x2, y2, z2 = p2[..., 0], p2[..., 1], p2[..., 2]
    f = [[F[..., i, j, None] for j in range(3)] for i in range(3)]
    fx0 = f[0][0] * x1 + f[0][1] * y1 + f[0][2] * z1
    fx1 = f[1][0] * x1 + f[1][1] * y1 + f[1][2] * z1
    fx2 = f[2][0] * x1 + f[2][1] * y1 + f[2][2] * z1
    ftx0 = f[0][0] * x2 + f[1][0] * y2 + f[2][0] * z2
    ftx1 = f[0][1] * x2 + f[1][1] * y2 + f[2][1] * z2
    num = (x2 * fx0 + y2 * fx1 + z2 * fx2) ** 2
    den = fx0 ** 2 + fx1 ** 2 + ftx0 ** 2 + ftx1 ** 2
    return num / torch.clamp(den, min=1e-12)


@highp
def decompose_essential(E):
    """E [... x 3 x 3] -> the four (R, t) candidates: Rs [... x 4 x 3 x 3]
    and unit ts [... x 4 x 3] (Hartley & Zisserman 9.6.2)."""
    U, V, _ = essential_uv_closed(E)
    Vt = V.transpose(-1, -2)
    u1, u2, u3 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    # U W and U W^T with W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    R1 = torch.stack([u2, -u1, u3], dim=-1) @ Vt
    R2 = torch.stack([-u2, u1, u3], dim=-1) @ Vt
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([u3, -u3, u3, -u3], dim=-2)
    return Rs, ts


@highp
def two_view_depths(R, t, x1, x2):
    """Closed-form depths of correspondences under (R, t): from
    z2 x2 = z1 R x1 + t, z1 = -(x2 x t).(x2 x R x1) / |x2 x R x1|^2 and
    z2 = (z1 R x1 + t)_z.

    Args:
        R: [... x 3 x 3], t: [... x 3].
        x1, x2: [... x N x 3] homogeneous normalised coordinates (their
            leading axes broadcast against R's).

    Returns:
        (z1, z2), each [... x N].
    """
    Rx1 = x1 @ R.transpose(-1, -2)
    c_rx = torch.linalg.cross(x2.expand_as(Rx1), Rx1, dim=-1)
    c_t = torch.linalg.cross(x2.expand_as(Rx1), t[..., None, :].expand_as(Rx1), dim=-1)
    denom = torch.sum(c_rx * c_rx, dim=-1)
    z1 = -torch.sum(c_t * c_rx, dim=-1) / torch.clamp(denom, min=1e-18)
    z2 = z1 * Rx1[..., 2] + t[..., None, 2]
    return z1, z2


@highp
def cheirality_count(R, t, x1, x2, mask, max_depth=50.0):
    """Correspondences in front of both cameras and nearer than
    ``max_depth`` baseline units, per pose: [...]."""
    z1, z2 = two_view_depths(R, t, x1, x2)
    ok = (z1 > 0) & (z1 < max_depth) & (z2 > 0) & (z2 < max_depth) & mask
    return torch.sum(ok, dim=-1)


@highp
def recover_pose(E, kp1, kp2, K_inv, inlier_mask):
    """The (R, t) candidate of each E [... x 3 x 3] with the most inliers
    ([... x N] mask) in front of both cameras, for pixel correspondences
    [... x N x 2] whose leading axes broadcast against E's.

    Returns:
        (R [... x 3 x 3], t [... x 3], cheirality count [...]).
    """
    x1 = _normalize(kp1, K_inv)[..., None, :, :]  # against the 4 candidates
    x2 = _normalize(kp2, K_inv)[..., None, :, :]
    Rs, ts = decompose_essential(E)
    counts = cheirality_count(Rs, ts, x1, x2, inlier_mask[..., None, :])
    best = torch.argmax(counts, dim=-1, keepdim=True)
    R = torch.gather(Rs, -3, best[..., None, None].expand(best.shape + (3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None].expand(best.shape + (3,)))[..., 0, :]
    return R, t, torch.gather(counts, -1, best)[..., 0]


def _tangent_basis(t):
    """Orthonormal basis (b1, b2) of the plane normal to t [... x 3]."""
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    a = torch.where((torch.abs(t[..., 0]) < 0.9)[..., None], eye[0], eye[1])
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    return b1, torch.linalg.cross(t, b1, dim=-1)


def _epipolar_terms(E, x1, x2):
    """(E x1 [... x N x 3], E^T x2 [... x N x 3], x2^T E x1 [... x N])."""
    Ex1 = x1 @ E.transpose(-1, -2)
    Etx2 = x2 @ E
    return Ex1, Etx2, torch.sum(x2 * Ex1, dim=-1)


@highp
def _gn_polish_pose(R0, t0, x1, x2, weights, iters=5):
    """Gauss-Newton on the essential manifold, batched over starts: five
    degrees of freedom (a left rotation update and the translation
    direction in a 2-D tangent basis, re-normalised each step) minimising
    the weighted Sampson residual in normalised coordinates.

    The Jacobian at zero update is the JAX package's ``jacfwd`` in closed
    form: dR = [e_k]x R, and d(t/|t|) = b_j/|t| - t (t.b_j)/|t|^3.

    Args:
        R0: [... x S x 3 x 3], t0: [... x S x 3] (unit).
        x1, x2: [... x 1 x N x 3] normalised coordinates.
        weights: [... x S x N].
    """
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
    gens = skew(eye)  # [3 x 3 x 3]: [e_k]x
    R, t = R0, t0
    for _ in range(iters):
        b1, b2 = _tangent_basis(t)
        tnorm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        tn = t / tnorm
        E = skew(tn) @ R
        Ex1, Etx2, num = _epipolar_terms(E, x1, x2)
        den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
               + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
        g = torch.sqrt(torch.clamp(den, min=1e-18))
        r = num / g * weights

        # dE for the five parameters: [S x 5 x 3 x 3]
        dE_rot = skew(tn)[..., None, :, :] @ gens @ R[..., None, :, :]
        dtn = [b / tnorm - t * (torch.sum(t * b, dim=-1, keepdim=True) / tnorm ** 3)
               for b in (b1, b2)]
        dE_t = skew(torch.stack(dtn, dim=-2)) @ R[..., None, :, :]
        dE = torch.cat([dE_rot, dE_t], dim=-3)
        dEx1, dEtx2, dnum = _epipolar_terms(dE, x1[..., None, :, :],
                                            x2[..., None, :, :])  # [S x 5 x N (x 3)]
        dden = 2.0 * (Ex1[..., None, :, 0] * dEx1[..., 0] + Ex1[..., None, :, 1] * dEx1[..., 1]
                      + Etx2[..., None, :, 0] * dEtx2[..., 0]
                      + Etx2[..., None, :, 1] * dEtx2[..., 1])
        dg = torch.where((den > 1e-18)[..., None, :], dden / (2.0 * g[..., None, :]),
                         torch.zeros_like(dden))
        J = ((dnum / g[..., None, :] - num[..., None, :] * dg / (g * g)[..., None, :])
             * weights[..., None, :]).transpose(-1, -2)  # [S x N x 5]

        H = J.transpose(-1, -2) @ J + 1e-8 * torch.eye(5, dtype=x1.dtype, device=x1.device)
        delta = -spd_solve_small(H, (J.transpose(-1, -2) @ r[..., None])[..., 0])
        R = so3_exp(delta[..., :3]) @ R
        tn = t + b1 * delta[..., 3:4] + b2 * delta[..., 4:5]
        t = tn / torch.linalg.vector_norm(tn, dim=-1, keepdim=True)
    return R, t


@highp
def find_essential_ransac(
    rng,
    kp1,
    kp2,
    K,
    K_inv,
    valid_mask,
    threshold=0.2,
    num_hypotheses=256,
    num_starts=8,
    vote_slices=1,
):
    """Batched RANSAC essential-matrix estimation with pose recovery.

    1. solve ``num_hypotheses`` 8-point DLT samples at once;
    2. score every model against every point (Sampson distance, inlier
       count with a truncated-residual tiebreak worth less than one
       inlier);
    3. refine the top ``num_starts`` models (a stable descending sort, so
       ties go to the lower index as with ``lax.top_k``): two guarded DLT
       refits on the inlier set, the cheirality vote, two guarded
       Gauss-Newton polishes of (R, t);
    4. return the start with the best final score.

    Args:
        rng: PRNG key (two uint32 words), or [... x 2] key words per frame.
        kp1, kp2: [... x N x 2] pixel correspondences (cur, ref), with
            optional leading frame axes.
        K, K_inv: [3 x 3] intrinsics and inverse, or [... x 3 x 3] with
            the keypoints' leading frame axes (one camera per sequence).
        valid_mask: [... x N] bool.
        threshold: inlier threshold in pixels on the Sampson distance.
        num_hypotheses, num_starts, vote_slices: static sizes; the best
            unpolished model of each of ``vote_slices`` disjoint hypothesis
            subsets is returned as ``slice_Es`` for the tracker's votes.

    Returns:
        dict with ``E``, ``R`` [... x 3 x 3], ``t`` [... x 3] (unit),
        ``inliers`` [... x N], ``inlier_cnt``, ``cheirality_cnt``,
        ``slice_Es`` [... x S x 3 x 3], ``slice_cnts`` [... x S].
    """
    nb = valid_mask.dim() - 1
    x1 = _normalize(kp1, K_inv)
    x2 = _normalize(kp2, K_inv)
    # the points against a model axis
    x1m, x2m = x1[..., None, :, :], x2[..., None, :, :]
    p1 = _homogeneous(kp1)[..., None, :, :]
    p2 = _homogeneous(kp2)[..., None, :, :]
    thr2 = threshold ** 2
    vmask = valid_mask.to(x1.dtype)[..., None, :]
    vm = valid_mask[..., None, :]
    r_norm = thr2 * (torch.sum(valid_mask, dim=-1).to(torch.float32) + 1.0)[..., None]

    def score(E):
        """(inlier masks, combined scores) of models E [... x S x 3 x 3]."""
        Kb = batch_matrix(K_inv, E)
        err = sampson_error(Kb.mT @ E @ Kb, p1, p2)
        mask = (err < thr2) & vm
        rsum = torch.sum(torch.clamp(err, max=thr2) * vmask, dim=-1)
        return mask, torch.sum(mask, dim=-1).to(torch.float32) - rsum / r_norm

    samp = sample_points(rng, torch.cat([x1, x2], dim=-1), valid_mask,
                         num_hypotheses, 8)
    Es = essential_from_sample(samp[..., :3], samp[..., 3:], project=False, iters=6)
    inliers, fscores = score(Es)
    counts = torch.sum(inliers, dim=-1)
    top = torch.sort(fscores, descending=True, stable=True).indices[..., :num_starts]

    # multi-start polish, batched over the starts
    best_E, best_inl = pick(Es, top, nb), pick(inliers, top, nb)
    best_fs = torch.gather(fscores, -1, top)
    cur = best_inl
    for _ in range(2):
        E = essential_from_sample(x1m, x2m, weights=cur.to(x1.dtype))
        cur, fs = score(E)
        better = fs >= best_fs
        best_E = torch.where(better[..., None, None], E, best_E)
        best_fs = torch.where(better, fs, best_fs)
        best_inl = torch.where(better[..., None], cur, best_inl)
    R, t, _ = recover_pose(best_E, kp1[..., None, :, :], kp2[..., None, :, :], K_inv,
                           best_inl)
    best_R, best_t = R, t
    cur = best_inl
    for _ in range(2):
        R, t = _gn_polish_pose(R, t, x1m, x2m, cur.to(x1.dtype))
        cur, fs = score(skew(t) @ R)
        better = fs >= best_fs
        best_R = torch.where(better[..., None, None], R, best_R)
        best_t = torch.where(better[..., None], t, best_t)
        best_fs = torch.where(better, fs, best_fs)
        best_inl = torch.where(better[..., None], cur, best_inl)

    j = torch.argmax(best_fs, dim=-1)
    R, t, inl = pick(best_R, j, nb), pick(best_t, j, nb), pick(best_inl, j, nb)
    per_slice = num_hypotheses // vote_slices
    slice_best = (torch.argmax(fscores.reshape(fscores.shape[:-1] + (vote_slices, -1)), dim=-1)
                  + torch.arange(vote_slices, device=x1.device) * per_slice)
    return {
        "E": skew(t) @ R,
        "R": R,
        "t": t,
        "inliers": inl,
        "inlier_cnt": torch.sum(inl, dim=-1),
        "cheirality_cnt": cheirality_count(R, t, x1, x2, valid_mask),
        "slice_Es": pick(Es, slice_best, nb),
        "slice_cnts": torch.gather(counts, -1, slice_best),
    }
