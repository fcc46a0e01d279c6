"""Batched P3P minimal solver (Grunert's quartic, closed form).

Counterpart of ``dfvo_tpu/solvers/p3p.py``: the 3-point lane of the PnP
RANSAC. Quartic roots by Ferrari's factorisation (resolvent cubic by
Cardano or the trigonometric formula) with Newton polishing, Grunert's
distance ratios from the law of cosines, and absolute orientation of the
triple by aligning orthonormal triads. Degenerate samples give invalid or
garbage poses that lose the RANSAC vote.
"""

import torch


def _cbrt(x):
    """Real cube root."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _real_cubic_root(B, C, D):
    """Largest real root of u^3 + B u^2 + C u + D (elementwise)."""
    p = C - B * B / 3.0
    q = D - B * C / 3.0 + 2.0 * B ** 3 / 27.0
    disc = -4.0 * p ** 3 - 27.0 * q * q
    # three real roots: y = 2 sqrt(-p/3) cos(phi/3), largest at k = 0
    pm = torch.clamp(p, max=-1e-12)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    y_tri = m * torch.cos(torch.arccos(arg) / 3.0)
    # one real root (Cardano)
    s = torch.sqrt(torch.clamp(q * q / 4.0 + p ** 3 / 27.0, min=0.0))
    y_car = _cbrt(-q / 2.0 + s) + _cbrt(-q / 2.0 - s)
    return torch.where(disc >= 0.0, y_tri, y_car) - B / 3.0


def solve_quartic(c4, c3, c2, c1, c0):
    """Real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 (Ferrari),
    elementwise over equal-shaped coefficient tensors.

    Returns:
        (roots [... x 4], valid [... x 4] bool); invalid slots hold finite
        garbage.
    """
    scale = torch.where(torch.abs(c4) < 1e-12, torch.full_like(c4, 1e-12), c4)
    b = c3 / scale
    c = c2 / scale
    d = c1 / scale
    e = c0 / scale

    # depressed quartic t^4 + p t^2 + q t + r, x = t - b/4
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b ** 3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b ** 4 / 256.0

    # resolvent cubic in u = alpha^2: u^3 + 2p u^2 + (p^2 - 4r) u - q^2 = 0
    u = torch.clamp(_real_cubic_root(2.0 * p, p * p - 4.0 * r, -q * q), min=0.0)
    alpha = torch.sqrt(u)

    # factorisation (t^2 + alpha t + beta)(t^2 - alpha t + gamma)
    safe_a = torch.clamp(alpha, min=1e-12)
    beta = (p + u - q / safe_a) / 2.0
    gamma = (p + u + q / safe_a) / 2.0
    d1 = u - 4.0 * beta
    d2 = u - 4.0 * gamma
    s1 = torch.sqrt(torch.clamp(d1, min=0.0))
    s2 = torch.sqrt(torch.clamp(d2, min=0.0))
    roots_f = torch.stack([(-alpha + s1) / 2.0, (-alpha - s1) / 2.0,
                           (alpha + s2) / 2.0, (alpha - s2) / 2.0], dim=-1)
    valid_f = torch.stack([d1 >= 0.0, d1 >= 0.0, d2 >= 0.0, d2 >= 0.0], dim=-1)

    # biquadratic when alpha ~ 0 (q ~ 0): t^2 = (-p +- sqrt(p^2 - 4r)) / 2
    db = p * p - 4.0 * r
    sb = torch.sqrt(torch.clamp(db, min=0.0))
    t1 = (-p + sb) / 2.0
    t2 = (-p - sb) / 2.0
    r1 = torch.sqrt(torch.clamp(t1, min=0.0))
    r2 = torch.sqrt(torch.clamp(t2, min=0.0))
    roots_b = torch.stack([r1, -r1, r2, -r2], dim=-1)
    ok1 = (db >= 0) & (t1 >= 0)
    ok2 = (db >= 0) & (t2 >= 0)
    valid_b = torch.stack([ok1, ok1, ok2, ok2], dim=-1)

    use_biquad = (alpha < 1e-6)[..., None]
    roots = torch.where(use_biquad, roots_b, roots_f) - (b / 4.0)[..., None]
    valid = torch.where(use_biquad, valid_b, valid_f)

    # three Newton steps on the original quartic restore the digits the
    # resolvent cubic loses in float32
    c4, c3, c2, c1, c0 = (x[..., None] for x in (c4, c3, c2, c1, c0))
    for _ in range(3):
        fval = (((c4 * roots + c3) * roots + c2) * roots + c1) * roots + c0
        fder = ((4.0 * c4 * roots + 3.0 * c3) * roots + 2.0 * c2) * roots + c1
        safe = torch.where(torch.abs(fder) < 1e-20, torch.full_like(fder, 1e-20), fder)
        roots = roots - fval / safe
    return roots, valid


def _triad(d1, d2):
    """Orthonormal frames [... x 3 x 3] (columns e1, e2, e3) from two
    spanning vectors [... x 3]."""
    e1 = d1 / torch.clamp(torch.linalg.vector_norm(d1, dim=-1, keepdim=True), min=1e-12)
    n = torch.linalg.cross(d1, d2, dim=-1)
    e3 = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    e2 = torch.linalg.cross(e3, e1, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def p3p_solutions(X, x_norm):
    """Up to four camera poses from three 3D-2D correspondences.

    Args:
        X: [... x 3 x 3] object points (rows).
        x_norm: [... x 3 x 2] normalised image coordinates.

    Returns:
        (Rs [... x 4 x 3 x 3], ts [... x 4 x 3], valid [... x 4]) with the
        cv2.solvePnP convention x ~ K (R X + t).
    """
    f = torch.cat([x_norm, torch.ones_like(x_norm[..., :1])], dim=-1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)  # bearings

    X0, X1, X2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    f0, f1, f2 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    a2 = torch.sum((X1 - X2) ** 2, dim=-1)
    b2 = torch.sum((X0 - X2) ** 2, dim=-1)
    c2 = torch.sum((X0 - X1) ** 2, dim=-1)
    ca = torch.sum(f1 * f2, dim=-1)
    cb = torch.sum(f0 * f2, dim=-1)
    cg = torch.sum(f0 * f1, dim=-1)

    b2s = torch.clamp(b2, min=1e-12)
    K1 = a2 / b2s
    K2 = c2 / b2s

    # Grunert's quartic in v = s3/s1 (coefficients as in the JAX package)
    A4 = K1 ** 2 - 2 * K1 * K2 - 2 * K1 + K2 ** 2 - 4 * K2 * ca ** 2 + 2 * K2 + 1
    A3 = (
        -4 * K1 ** 2 * cb
        + 8 * K1 * K2 * cb
        + 4 * K1 * ca * cg
        + 4 * K1 * cb
        - 4 * K2 ** 2 * cb
        + 8 * K2 * ca ** 2 * cb
        + 4 * K2 * ca * cg
        - 4 * K2 * cb
        - 4 * ca * cg
    )
    A2 = (
        4 * K1 ** 2 * cb ** 2
        + 2 * K1 ** 2
        - 8 * K1 * K2 * cb ** 2
        - 4 * K1 * K2
        - 8 * K1 * ca * cb * cg
        - 4 * K1 * cg ** 2
        + 4 * K2 ** 2 * cb ** 2
        + 2 * K2 ** 2
        - 4 * K2 * ca ** 2
        - 8 * K2 * ca * cb * cg
        + 4 * ca ** 2
        + 4 * cg ** 2
        - 2
    )
    A1 = (
        -4 * K1 ** 2 * cb
        + 8 * K1 * K2 * cb
        + 4 * K1 * ca * cg
        + 8 * K1 * cb * cg ** 2
        - 4 * K1 * cb
        - 4 * K2 ** 2 * cb
        + 4 * K2 * ca * cg
        + 4 * K2 * cb
        - 4 * ca * cg
    )
    A0 = K1 ** 2 - 2 * K1 * K2 - 4 * K1 * cg ** 2 + 2 * K1 + K2 ** 2 - 2 * K2 + 1

    v, v_ok = solve_quartic(A4, A3, A2, A1, A0)  # [... x 4]
    ca, cb, cg, K1, K2, b2s = (x[..., None] for x in (ca, cb, cg, K1, K2, b2s))

    # u = s2/s1 from the second ratio equation: the branch that better
    # satisfies the first
    Db = 1.0 + v * v - 2.0 * v * cb
    rad = cg * cg - 1.0 + K2 * Db
    sq = torch.sqrt(torch.clamp(rad, min=0.0))
    u_a, u_b = cg + sq, cg - sq

    def e1_res(u):
        return torch.abs(u * u + v * v - 2 * u * v * ca - K1 * Db)

    u = torch.where(e1_res(u_a) <= e1_res(u_b), u_a, u_b)

    # joint Newton on the ratio system (well conditioned where the quartic
    # coefficients cancel)
    for _ in range(4):
        Dbv = 1.0 + v * v - 2.0 * v * cb
        e1 = u * u + v * v - 2 * u * v * ca - K1 * Dbv
        e2 = 1.0 + u * u - 2 * u * cg - K2 * Dbv
        j11 = 2 * u - 2 * v * ca
        j12 = 2 * v - 2 * u * ca - K1 * (2 * v - 2 * cb)
        j21 = 2 * u - 2 * cg
        j22 = -K2 * (2 * v - 2 * cb)
        det = j11 * j22 - j12 * j21
        safe = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
        du = (e1 * j22 - e2 * j12) / safe
        dv = (j11 * e2 - j21 * e1) / safe
        u, v = u - du, v - dv
    Db = 1.0 + v * v - 2.0 * v * cb
    s1 = torch.sqrt(b2s / torch.clamp(Db, min=1e-12))
    ok = (v > 0) & (u > 0) & (Db > 1e-12) & (rad >= 0)

    s = torch.stack([s1, u * s1, v * s1], dim=-1)  # [... x 4 x 3]
    Q = s[..., :, None] * f[..., None, :, :]  # camera-frame points [... x 4 x 3 x 3]
    Mw = _triad(X1 - X0, X2 - X0)[..., None, :, :]
    Mc = _triad(Q[..., 1, :] - Q[..., 0, :], Q[..., 2, :] - Q[..., 0, :])
    R = Mc @ Mw.transpose(-1, -2)
    t = Q[..., 0, :] - (R @ X0[..., None, :, None])[..., 0]
    return R, t, ok & v_ok
