"""Small-matrix linear algebra for the solver stack, in closed or unrolled
form.

Counterpart of ``dfvo_tpu/solvers/linalg.py``. The RANSAC solvers need
nullspace directions, small SPD inverses, 3x3 inverses, polar factors and
the SVD frames of near-essential matrices; the JAX package computes them
with unrolled Cholesky factorisations, shift-inverted power iteration,
adjugates, Newton polar iteration and a Cardano eigendecomposition, and
so does this module. Library solvers (``torch.linalg.svd``/``eigh``/``inv``)
would drift from the reference, and on the card they synchronise and
launch more for the small batches of a frame.

Every function takes any leading batch dimensions. The JAX package's
structure-of-arrays variants (``*_soa``) lay hypotheses along TPU lanes;
they compute the same values as the array forms here and are not carried
over.
"""

import math

import torch
import torch.nn.functional as F

from ..utils.precision import highp


def batch_matrix(M, like):
    """``M`` [... x r x c] viewed to broadcast against ``like``
    [... x extra x a x b] whose leading axes are M's: one axis of size 1
    for each of like's extra axes (per-sequence intrinsics against a
    hypothesis or start axis). A plain [r x c] matrix is returned as it
    is."""
    if M.dim() == 2:
        return M
    return M.reshape(M.shape[:-2] + (1,) * (like.dim() - M.dim()) + M.shape[-2:])


def batch_entry(M, i, j, like):
    """Entry (i, j) of ``M`` [... x r x c], shaped to broadcast against
    ``like`` [... x extra] whose leading axes are M's; a 0-d tensor for a
    plain [r x c] matrix."""
    e = M[..., i, j]
    if M.dim() == 2:
        return e
    return e.reshape(e.shape + (1,) * (like.dim() - e.dim()))


def det3(M):
    """Determinant of [... x 3 x 3] matrices by cofactor expansion."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def cholesky_unrolled(M):
    """Cholesky factor L (M = L L^T) of small SPD [... x n x n] matrices,
    column by column; the pivots are clamped at 1e-30 as in the JAX
    package."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        row = L[..., j, :j]
        d = torch.sqrt(torch.clamp(M[..., j, j] - torch.sum(row * row, dim=-1),
                                   min=1e-30))
        L[..., j, j] = d
        if j + 1 < n:
            s = M[..., j + 1:, j] - torch.sum(L[..., j + 1:, :j] * row[..., None, :],
                                              dim=-1)
            L[..., j + 1:, j] = s * (1.0 / d)[..., None]
    return L


def tril_inverse_unrolled(L):
    """Inverse of small lower-triangular [... x n x n] matrices by forward
    substitution on the identity, row by row."""
    n = L.shape[-1]
    X = torch.zeros_like(L)
    for i in range(n):
        inv_d = 1.0 / L[..., i, i]
        if i > 0:
            s = torch.sum(L[..., i, :i, None] * X[..., :i, :], dim=-2)
            X[..., i, :] = -s * inv_d[..., None]
        X[..., i, i] = inv_d
    return X


def spd_inverse_small(M):
    """Inverse of small SPD matrices: M^-1 = L^-T L^-1."""
    Li = tril_inverse_unrolled(cholesky_unrolled(M))
    return Li.transpose(-1, -2) @ Li


def spd_solve_small(M, b):
    """Solve M x = b for small SPD M ([... x n x n], [... x n])."""
    return (spd_inverse_small(M) @ b[..., None])[..., 0]


@highp
def spd_smallest_eigvec(M, iters=8, shift=1e-6):
    """Unit eigenvector of the smallest eigenvalue of small SPD
    [... x n x n] matrices by shift-inverted power iteration from the
    all-ones vector (``iters`` static; the shift is relative to the mean
    diagonal)."""
    n = M.shape[-1]
    mean_diag = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    Minv = spd_inverse_small(M + shift * mean_diag * eye)
    v = torch.full(M.shape[:-1], 1.0 / math.sqrt(n), dtype=M.dtype, device=M.device)
    for _ in range(iters):
        y = (Minv @ v[..., None])[..., 0]
        v = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                            min=1e-30)
    return v


@highp
def nullspace_vector(A, iters=10, shift=1e-6):
    """Unit vector minimising |A v| for design matrices [... x m x n]: the
    smallest eigenvector of A^T A (see :func:`spd_smallest_eigvec`)."""
    return spd_smallest_eigvec(A.transpose(-1, -2) @ A, iters=iters, shift=shift)


@highp
def inv_3x3(M):
    """Inverse of [... x 3 x 3] matrices by the adjugate, with the
    determinant guarded at 1e-30."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        dim=-1,
    ).reshape(A.shape + (3, 3))
    return adj * inv_det[..., None, None]


@highp
def nearest_rotation(M, iters=5):
    """Orthogonal polar factor of [... x 3 x 3] matrices by Newton
    iteration X <- (X + X^-T) / 2, and the mean singular value
    tr(R^T M) / 3. For det(M) < 0 the limit is a reflection; callers flip
    the sign first."""
    norm = torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True) / 3.0)
    X = M / torch.clamp(norm, min=1e-30)
    for _ in range(iters):
        X = 0.5 * (X + inv_3x3(X).transpose(-1, -2))
    scale = torch.sum(X * M, dim=(-2, -1)) / 3.0
    return X, scale


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.linalg.vector_norm(a, dim=-1)


def _unit_or(w, n, thre, fallback):
    """w / n where n > thre, else ``fallback`` (n is [...], w [... x 3])."""
    return torch.where((n > thre)[..., None],
                       w / torch.clamp(n, min=1e-30)[..., None], fallback)


def _axis(idx, like):
    """Rows of the 3x3 identity at integer indices ``idx``."""
    return F.one_hot(idx, 3).to(like.dtype)


def _projector_col(C, la, lb):
    """The column of (C - la I)(C - lb I) with the largest norm."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    P = (C - la[..., None, None] * eye) @ (C - lb[..., None, None] * eye)
    best = torch.argmax(torch.linalg.vector_norm(P, dim=-2), dim=-1)
    return torch.gather(P, -1, best[..., None, None].expand(P.shape[:-1] + (1,)))[..., 0]


def _cardano(C):
    """Eigenvalues (largest, middle, smallest) of symmetric [... x 3 x 3]
    matrices in closed form."""
    q = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    Cq = C - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(Cq * Cq, dim=(-2, -1)) / 6.0, min=1e-30))
    r = torch.clamp(det3(Cq / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lam1, 3.0 * q - lam1 - lam3, lam3


@highp
def essential_uv_closed(E):
    """Closed-form SVD frames of (near-)essential [... x 3 x 3] matrices
    from the Cardano eigendecomposition of E^T E: v3 from a projector
    product, v1 from the complementary projector made orthogonal to v3, the
    u's from E v, and the singular values evaluated on E.

    Returns:
        (U, V, s) with E ~ U diag(s) V^T and det(U) = det(V) = +1.
    """
    C = E.transpose(-1, -2) @ E
    lam1, lam2, lam3 = _cardano(C)
    z = torch.zeros_like(E[..., 0])
    fb3 = torch.cat([z[..., :2], torch.ones_like(z[..., :1])], dim=-1)

    w3 = _projector_col(C, lam1, lam2)
    v3 = _unit_or(w3, _norm(w3), 1e-20, fb3)

    w1 = _projector_col(C, lam2, lam3)
    w1 = w1 - _dot(w1, v3)[..., None] * v3
    fb1 = torch.linalg.cross(v3, _axis(torch.argmin(torch.abs(v3), dim=-1), v3), dim=-1)
    fb1 = fb1 / torch.clamp(_norm(fb1), min=1e-30)[..., None]
    v1 = _unit_or(w1, _norm(w1), 1e-12, fb1)
    v2 = torch.linalg.cross(v3, v1, dim=-1)

    Ev1 = (E @ v1[..., None])[..., 0]
    Ev2 = (E @ v2[..., None])[..., 0]
    s1 = _norm(Ev1)
    u1 = Ev1 / torch.clamp(s1, min=1e-30)[..., None]
    Ev2o = Ev2 - _dot(Ev2, u1)[..., None] * u1
    fbu = torch.linalg.cross(u1, _axis(torch.argmin(torch.abs(u1), dim=-1), u1), dim=-1)
    fbu = fbu / torch.clamp(_norm(fbu), min=1e-30)[..., None]
    u2 = _unit_or(Ev2o, _norm(Ev2o), 1e-12, fbu)
    u3 = torch.linalg.cross(u1, u2, dim=-1)

    U = torch.stack([u1, u2, u3], dim=-1)
    V = torch.stack([v1, v2, v3], dim=-1)
    s3 = _dot((E @ v3[..., None])[..., 0], u3)
    s = torch.stack([s1, _dot(Ev2, u2), s3], dim=-1)
    return U, V, s


@highp
def smallest_eigvec_3x3(C):
    """Unit eigenvector of the smallest eigenvalue of symmetric
    [... x 3 x 3] matrices (Cardano eigenvalues and a projector column);
    (0, 0, 1) when C is a multiple of the identity."""
    lam1, lam2, _ = _cardano(C)
    v = _projector_col(C, lam1, lam2)
    z = torch.zeros_like(v[..., :1])
    fallback = torch.cat([z, z, torch.ones_like(z)], dim=-1)
    return _unit_or(v, _norm(v), 1e-20, fallback)
