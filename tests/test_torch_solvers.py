"""Parity of the PyTorch port's solvers and trackers with the JAX package,
on the CPU in float32, from the same numpy inputs and the same PRNG key.

Tolerances:
* bit-exact (``assert_array_equal``): the hash draws, the compaction
  order, the sampled points;
* small linear algebra and closed forms: rtol 1e-5, atol 1e-6 (1e-4 where
  an iteration amplifies rounding, stated at the test);
* RANSAC estimators: the same validity flag, rotation within 0.01 deg,
  translation within 1e-3 |t| (5e-3 |t| for compute_pose_3d2d, whose
  reason is at the test), inlier masks equal on at least 99.5 % of the
  valid points.

The JAX solver calls use the shapes and static arguments of
tests/test_solvers.py and tests/test_tracker.py, so they build the same
programs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.solvers import essential as T_ess
from dfvo_torch.solvers import gric as T_gric
from dfvo_torch.solvers import homography as T_hom
from dfvo_torch.solvers import linalg as T_lin
from dfvo_torch.solvers import p3p as T_p3p
from dfvo_torch.solvers import pnp as T_pnp
from dfvo_torch.solvers import ransac as T_ran
from dfvo_torch.solvers import scale as T_scale
from dfvo_torch.tracker import e_tracker as T_et
from dfvo_torch.tracker import pnp_tracker as T_pt
from dfvo_torch.utils import prng
from dfvo_tpu.solvers import essential as J_ess
from dfvo_tpu.solvers import gric as J_gric
from dfvo_tpu.solvers import homography as J_hom
from dfvo_tpu.solvers import linalg as J_lin
from dfvo_tpu.solvers import p3p as J_p3p
from dfvo_tpu.solvers import pnp as J_pnp
from dfvo_tpu.solvers import ransac as J_ran
from dfvo_tpu.solvers import scale as J_scale
from dfvo_tpu.tracker import e_tracker as J_et
from dfvo_tpu.tracker import pnp_tracker as J_pt
from tests.test_solvers import K, K_inv, make_two_view_scene
from tests.test_tracker import scene as tracker_scene

RTOL, ATOL = 1e-5, 1e-6
Kf = K.astype(np.float32)
Kif = K_inv.astype(np.float32)


def keys(seed):
    """The same key in both packages."""
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)
                            if np.asarray(a).dtype.kind == "f" else np.asarray(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def rot_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees, from atan2 of its skew and trace parts:
    exact near zero, where arccos of the trace loses the float32 rounding
    of the inputs (~0.02 deg)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    v = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return np.degrees(np.arctan2(np.linalg.norm(v) / 2, (np.trace(M) - 1) / 2))


def assert_same_estimate(got, want, valid, key_R="R", key_t="t", key_ok=None):
    """RANSAC estimator parity (tolerances in the module docstring)."""
    if key_ok is not None:
        assert bool(got[key_ok]) == bool(want[key_ok])
    assert rot_deg(got[key_R].numpy(), want[key_R]) < 0.01
    tw = np.asarray(want[key_t], np.float64)
    assert np.linalg.norm(got[key_t].numpy() - tw) <= 1e-3 * max(np.linalg.norm(tw), 1e-6)
    agree = (got["inliers"].numpy() == np.asarray(want["inliers"]))[valid]
    assert agree.mean() >= 0.995


# ---------------------------------------------------------------------------
# ransac: bit-exact draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_draw_and_compaction_bit_exact(seed):
    rng = np.random.RandomState(seed)
    n = [37, 500, 2000][seed]
    mask = rng.rand(n) > 0.3 * (seed + 1)
    jk, tk = keys(seed + 11)
    jk = jax.random.fold_in(jk, 3)
    tk = prng.fold_in(tk, 3)
    order_j, count_j = J_ran._valid_front_order(jnp.asarray(mask))
    order_t, count_t = T_ran._valid_front_order(torch.from_numpy(mask))
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    assert int(count_t) == int(count_j)
    draws_j = J_ran._hash_draw(jk, 1280 * 8, count_j)
    draws_t = T_ran._hash_draw(tk, 1280 * 8, count_t, "cpu")
    np.testing.assert_array_equal(draws_t.numpy(), np.asarray(draws_j))


def test_mix32_bit_exact_on_extreme_words():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9,
                      123456789], np.uint32)
    want = np.asarray(J_ran._mix32(jnp.asarray(words)))
    got = T_ran._mix32(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert [T_ran._mix32(int(w)) for w in words] == want.astype(np.int64).tolist()


@pytest.mark.parametrize("case", ["mixed", "all_invalid"])
def test_sample_points_and_indices_bit_exact(case):
    rng = np.random.RandomState(0)
    pts = rng.randn(37, 5).astype(np.float32)
    mask = rng.rand(37) > 0.4 if case == "mixed" else np.zeros(37, bool)
    jk, tk = keys(3)
    want = J_ran.sample_points(jk, jnp.asarray(pts), jnp.asarray(mask), 32, 8)
    got = T_ran.sample_points(tk, torch.from_numpy(pts), torch.from_numpy(mask), 32, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx_j = J_ran.sample_indices(jk, jnp.asarray(mask), 32, 8)
    idx_t = T_ran.sample_indices(tk, torch.from_numpy(mask), 32, 8)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


# ---------------------------------------------------------------------------
# small linear algebra
# ---------------------------------------------------------------------------

def _spd(rng, b, n):
    A = rng.randn(b, n, n + 2).astype(np.float32)
    return np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [5, 9, 12])
def test_cholesky_and_inverses(n):
    M = _spd(np.random.RandomState(n), 6, n)
    L = T_lin.cholesky_unrolled(t(M))
    close(L, J_lin.cholesky_unrolled(jnp.asarray(M)), rtol=1e-4, atol=1e-5)
    close(T_lin.tril_inverse_unrolled(L),
          J_lin.tril_inverse_unrolled(J_lin.cholesky_unrolled(jnp.asarray(M))),
          rtol=1e-4, atol=1e-5)
    # the inverse of an SPD matrix with condition ~1e3: relative 1e-4
    close(T_lin.spd_inverse_small(t(M)), J_lin.spd_inverse_small(jnp.asarray(M)),
          rtol=1e-4, atol=1e-5)
    b = np.random.RandomState(1).randn(6, n).astype(np.float32)
    close(T_lin.spd_solve_small(t(M), t(b)), J_lin.spd_solve_small(jnp.asarray(M), jnp.asarray(b)),
          rtol=1e-4, atol=1e-5)


def test_nullspace_and_smallest_eigvec():
    rng = np.random.RandomState(2)
    A = rng.randn(16, 8, 9).astype(np.float32)  # 8-point design matrices
    close(T_lin.nullspace_vector(t(A), iters=6), J_lin.nullspace_vector(jnp.asarray(A), iters=6),
          rtol=1e-4, atol=1e-5)
    M = _spd(rng, 8, 4)
    close(T_lin.spd_smallest_eigvec(t(M)), J_lin.spd_smallest_eigvec(jnp.asarray(M)),
          rtol=1e-4, atol=1e-5)


def test_closed_forms_3x3():
    rng = np.random.RandomState(3)
    M = rng.randn(32, 3, 3).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    close(T_lin.det3(t(M)), J_lin.det3(jnp.asarray(M)))
    close(T_lin.inv_3x3(t(M)), J_lin.inv_3x3(jnp.asarray(M)), rtol=1e-4, atol=1e-5)
    R, s = T_lin.nearest_rotation(t(M))
    Rj, sj = J_lin.nearest_rotation(jnp.asarray(M))
    close(R, Rj, rtol=1e-4, atol=1e-5)
    close(s, sj, rtol=1e-4, atol=1e-5)
    C = np.einsum("bji,bjk->bik", M, M)
    close(T_lin.smallest_eigvec_3x3(t(C)), J_lin.smallest_eigvec_3x3(jnp.asarray(C)),
          rtol=1e-4, atol=1e-5)


def _near_essentials(rng, b):
    from dfvo_tpu.geometry.lie import skew, so3_exp

    R = np.asarray(so3_exp(jnp.asarray(rng.randn(b, 3).astype(np.float32) * 0.2)))
    tv = rng.randn(b, 3).astype(np.float32)
    tv /= np.linalg.norm(tv, axis=-1, keepdims=True)
    E = np.asarray(skew(jnp.asarray(tv))) @ R
    return (E + 1e-3 * rng.randn(b, 3, 3)).astype(np.float32)


def test_essential_frames_and_decomposition():
    E = _near_essentials(np.random.RandomState(4), 16)
    U, V, s = T_lin.essential_uv_closed(t(E))
    Uj, Vj, sj = jax.jit(jax.vmap(J_lin.essential_uv_closed))(jnp.asarray(E))
    # sigma1 = sigma2 for a true essential: the in-plane frame is
    # ill-conditioned, so compare what callers use, the projection and the
    # four decompositions, and the frames' third columns
    close(s, sj, rtol=1e-4, atol=1e-5)
    close(U[..., 2].abs(), np.abs(np.asarray(Uj)[..., 2]), rtol=1e-3, atol=1e-4)
    close(T_ess._project_to_essential(t(E)),
          jax.jit(jax.vmap(J_ess._project_to_essential))(jnp.asarray(E)),
          rtol=1e-3, atol=1e-4)
    Rs, ts = T_ess.decompose_essential(t(E))
    Rsj, tsj = jax.jit(jax.vmap(J_ess.decompose_essential))(jnp.asarray(E))
    close(Rs, Rsj, rtol=1e-3, atol=1e-4)
    close(ts, tsj, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# essential, homography, GRIC, scale
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_view():
    kp1, kp2, R, tt, inl = make_two_view_scene(np.random.RandomState(0))
    return kp1.astype(np.float32), kp2.astype(np.float32), R, tt


def test_epipolar_kernels(two_view):
    kp1, kp2, R_gt, t_gt = two_view
    x1 = np.concatenate([kp1, np.ones((len(kp1), 1), np.float32)], 1) @ Kif.T
    x2 = np.concatenate([kp2, np.ones((len(kp2), 1), np.float32)], 1) @ Kif.T
    R, tv = R_gt.astype(np.float32), (t_gt / np.linalg.norm(t_gt)).astype(np.float32)
    z = T_ess.two_view_depths(t(R), t(tv), t(x1), t(x2))
    zj = J_ess.two_view_depths(jnp.asarray(R), jnp.asarray(tv), jnp.asarray(x1), jnp.asarray(x2))
    for a, b in zip(z, zj):
        close(a, b, rtol=1e-4, atol=1e-4)
    E = np.asarray(J_ess.skew(jnp.asarray(tv))) @ R
    F = Kif.T @ E @ Kif
    p1 = np.concatenate([kp1, np.ones((len(kp1), 1), np.float32)], 1)
    p2 = np.concatenate([kp2, np.ones((len(kp2), 1), np.float32)], 1)
    close(T_ess.sampson_error(t(F), t(p1), t(p2)),
          J_ess.sampson_error(jnp.asarray(F), jnp.asarray(p1), jnp.asarray(p2)),
          rtol=1e-4, atol=1e-6)
    mask = np.ones(len(kp1), bool)
    Rr, tr, cnt = T_ess.recover_pose(t(E), t(kp1), t(kp2), t(Kif), torch.from_numpy(mask))
    Rj, tj, cj = J_ess.recover_pose(jnp.asarray(E), jnp.asarray(kp1), jnp.asarray(kp2),
                                    jnp.asarray(Kif), jnp.asarray(mask))
    assert int(cnt) == int(cj)
    close(Rr, Rj, rtol=1e-4, atol=1e-5)
    close(tr, tj, rtol=1e-4, atol=1e-5)


def test_find_essential_ransac(two_view):
    kp1, kp2, _, _ = two_view
    mask = np.ones(len(kp1), bool)
    jk, tk = keys(1)
    want = J_ess.find_essential_ransac(jk, jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(Kf),
                                       jnp.asarray(Kif), jnp.asarray(mask), threshold=0.5)
    got = T_ess.find_essential_ransac(tk, t(kp1), t(kp2), t(Kf), t(Kif),
                                      torch.from_numpy(mask), threshold=0.5)
    assert_same_estimate(got, want, mask)
    assert abs(int(got["inlier_cnt"]) - int(want["inlier_cnt"])) <= 0.005 * len(kp1)
    assert abs(int(got["cheirality_cnt"]) - int(want["cheirality_cnt"])) <= 0.005 * len(kp1)
    # the unpolished slice models are the same hypotheses
    close(got["slice_cnts"], want["slice_cnts"], atol=0)


def test_find_homography_ransac_and_gric():
    kp1, kp2, *_ = make_two_view_scene(np.random.RandomState(3), planar=True, n_outliers=30)
    kp1, kp2 = kp1.astype(np.float32), kp2.astype(np.float32)
    mask = np.ones(len(kp1), bool)
    jk, tk = keys(4)
    want = J_hom.find_homography_ransac(jk, jnp.asarray(kp1), jnp.asarray(kp2),
                                        jnp.asarray(mask), threshold=1.0)
    got = T_hom.find_homography_ransac(tk, t(kp1), t(kp2), torch.from_numpy(mask),
                                       threshold=1.0)
    Hj = np.asarray(want["H"]) / np.asarray(want["H"])[2, 2]
    H = got["H"].numpy() / got["H"].numpy()[2, 2]
    np.testing.assert_allclose(H, Hj, rtol=1e-3, atol=1e-4)
    assert (got["inliers"].numpy() == np.asarray(want["inliers"])).mean() >= 0.995

    # GRIC residuals and scores on the same model
    res = T_gric.homography_residual(t(Hj), t(kp1), t(kp2), mask=torch.from_numpy(mask))
    res_j = J_gric.homography_residual(jnp.asarray(Hj), jnp.asarray(kp1), jnp.asarray(kp2),
                                       mask=jnp.asarray(mask))
    close(res, res_j, rtol=1e-3, atol=1e-5)
    F = np.random.RandomState(5).randn(2, 3, 3).astype(np.float32)
    fres = T_gric.fundamental_residual(t(F), t(kp1), t(kp2))
    close(fres, jax.vmap(lambda f: J_gric.fundamental_residual(f, jnp.asarray(kp1),
                                                               jnp.asarray(kp2)))(jnp.asarray(F)),
          rtol=1e-4, atol=1e-6)
    for model in ("EMat", "HMat", "FMat"):
        close(T_gric.calc_gric(res, 0.8, 500.0, model),
              J_gric.calc_gric(res_j, 0.8, 500.0, model), rtol=1e-5, atol=1e-3)


def test_scale_ransac_1d():
    rng = np.random.RandomState(8)
    n = 500
    ratios = 1.0 / 3.7 + rng.randn(n) * 0.002
    out_idx = rng.choice(n, 150, replace=False)
    ratios[out_idx] = rng.uniform(0.01, 2.0, 150)
    ratios = ratios.astype(np.float32)
    mask = np.ones(n, bool)
    jk, tk = keys(9)
    want = J_scale.scale_ransac_1d(jk, jnp.asarray(ratios), jnp.asarray(mask), threshold=0.1)
    got = T_scale.scale_ransac_1d(tk, t(ratios), torch.from_numpy(mask), threshold=0.1)
    close(got["scale"], want["scale"], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))


# ---------------------------------------------------------------------------
# P3P and PnP
# ---------------------------------------------------------------------------

def test_solve_quartic():
    rng = np.random.RandomState(1)
    coefs = []
    for _ in range(16):
        true = np.sort(rng.uniform(-3, 3, 4))
        coefs.append(np.poly(true))
    c = np.asarray(coefs, np.float32).T
    roots, valid = T_p3p.solve_quartic(*[t(x) for x in c])
    roots_j, valid_j = jax.jit(jax.vmap(J_p3p.solve_quartic))(*[jnp.asarray(x) for x in c])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    close(roots, roots_j, rtol=1e-4, atol=1e-4)


def _pnp_scene(seed, n=400, n_out=60):
    rng = np.random.RandomState(seed)
    X = rng.uniform([-8, -3, 5], [8, 3, 40], size=(n, 3))
    R_gt = np.asarray(J_pnp.so3_exp(jnp.array([0.02, -0.03, 0.01], jnp.float32)), np.float64)
    t_gt = np.array([0.4, -0.2, 0.8])
    P = X @ R_gt.T + t_gt
    pix = (K @ P.T).T
    pix = pix[:, :2] / pix[:, 2:]
    pix += rng.randn(n, 2) * 0.2
    out_idx = rng.choice(n, n_out, replace=False)
    pix[out_idx] += rng.uniform(20, 100, size=(n_out, 2))
    return X.astype(np.float32), pix.astype(np.float32)


def _assert_minimal_solver_parity(R, tt, Rj, tj, X, xs):
    """Minimal-sample pose parity, the JAX package's own criterion for two
    summation orders of one solver (tests/test_solvers.py,
    test_pnp_dlt_hypotheses_soa_matches_vmap): six inverse iterations on
    an ill-conditioned minimal sample may end apart, so the bulk agrees
    within 5e-3 and every pose fits the sample as well (reprojection RMS
    within 1.5x + 1e-3)."""
    R, tt, Rj, tj = R.numpy(), tt.numpy(), np.asarray(Rj), np.asarray(tj)
    dR = np.abs(R - Rj).max(axis=(1, 2))
    dt = np.abs(tt - tj).max(axis=1) / (1.0 + np.linalg.norm(tj, axis=1))
    assert (dR < 5e-3).mean() >= 0.9, dR
    assert (dt < 5e-3).mean() >= 0.9, dt

    def reproj_rms(R, t):
        Xc = np.einsum("bij,bnj->bni", R, X) + t[:, None]
        return np.sqrt(((Xc[..., :2] / Xc[..., 2:3] - xs) ** 2).sum(-1).mean(-1))

    assert np.all(reproj_rms(R, tt) <= reproj_rms(Rj, tj) * 1.5 + 1e-3)


@pytest.mark.parametrize("planar", [False, True])
def test_minimal_pose_solvers(planar):
    rng = np.random.RandomState(5)
    X = rng.randn(32, 6, 3).astype(np.float32) * 2.0
    X[..., 2] = 8.0 if planar else X[..., 2] + 8.0
    xs = (X[..., :2] / X[..., 2:3]).astype(np.float32)
    xs += 0.01 * rng.randn(*xs.shape).astype(np.float32)
    tf, jf = ((T_pnp.pnp_from_sample_planar, J_pnp.pnp_from_sample_planar) if planar
              else (T_pnp.pnp_from_sample, J_pnp.pnp_from_sample))
    R, tt = tf(t(X), t(xs))
    Rj, tj = jax.jit(jax.vmap(jf))(jnp.asarray(X), jnp.asarray(xs))
    _assert_minimal_solver_parity(R, tt, Rj, tj, X, xs)


def test_p3p_solutions():
    rng = np.random.RandomState(5)
    X = rng.randn(32, 3, 3).astype(np.float32) * 2.0
    X[..., 2] += 8.0
    xs = (X[..., :2] / X[..., 2:3]).astype(np.float32)
    R, tt, ok = T_p3p.p3p_solutions(t(X), t(xs))
    # op by op: a root's validity is a discriminant's sign, which the
    # jitted program's reordered rounding flips for near-double roots
    Rj, tj, okj = jax.vmap(J_p3p.p3p_solutions)(jnp.asarray(X), jnp.asarray(xs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    okn = ok.numpy()
    # each valid root as a pose of its own triple
    Xr = np.repeat(X[:, None], 4, axis=1)[okn]
    xr = np.repeat(xs[:, None], 4, axis=1)[okn]
    _assert_minimal_solver_parity(R[torch.from_numpy(okn)], tt[torch.from_numpy(okn)],
                                  np.asarray(Rj)[okn], np.asarray(tj)[okn], Xr, xr)


def test_solve_pnp_ransac():
    X, pix = _pnp_scene(6)
    mask = np.ones(len(X), bool)
    jk, tk = keys(7)
    want = J_pnp.solve_pnp_ransac(jk, jnp.asarray(X), jnp.asarray(pix), jnp.asarray(Kf),
                                  jnp.asarray(Kif), jnp.asarray(mask), reproj_threshold=1.0)
    got = T_pnp.solve_pnp_ransac(tk, t(X), t(pix), t(Kf), t(Kif), torch.from_numpy(mask),
                                 reproj_threshold=1.0)
    assert_same_estimate(got, want, mask, key_ok="ok")


# ---------------------------------------------------------------------------
# trackers (the shapes of tests/test_tracker.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planar", [False, True])
def test_compute_pose_2d2d_gric(planar):
    rng = np.random.RandomState(1 if planar else 0)
    kp_cur, kp_ref, *_ = tracker_scene(rng, planar=planar, noise=0.1 if planar else 0.2)
    kp_cur, kp_ref = kp_cur.astype(np.float32), kp_ref.astype(np.float32)
    mask = np.ones(len(kp_cur), bool)
    jk, tk = keys(1 if planar else 0)
    want = J_et.compute_pose_2d2d(jk, jnp.asarray(kp_cur), jnp.asarray(kp_ref),
                                  jnp.asarray(mask), jnp.asarray(Kf), jnp.asarray(Kif))
    got = T_et.compute_pose_2d2d(tk, t(kp_cur), t(kp_ref), torch.from_numpy(mask),
                                 t(Kf), t(Kif))
    assert bool(got["valid"]) == bool(want["valid"]) == (not planar)
    assert_same_estimate(got, want, mask, key_ok="valid")


@pytest.mark.parametrize("method, thre", [("flow", 5.0), ("homo_ratio", 0.5), ("none", 0.0)])
def test_compute_pose_2d2d_other_validity_methods(method, thre):
    """The three other validity branches, at a small static size."""
    rng = np.random.RandomState(2)
    kp_cur, kp_ref, *_ = tracker_scene(rng, n=200)
    kp_cur, kp_ref = kp_cur.astype(np.float32), kp_ref.astype(np.float32)
    mask = np.ones(len(kp_cur), bool)
    jk, tk = keys(2)
    kw = dict(repeats=3, num_hypotheses=32, validity_method=method, validity_thre=thre)
    want = J_et.compute_pose_2d2d(jk, jnp.asarray(kp_cur), jnp.asarray(kp_ref),
                                  jnp.asarray(mask), jnp.asarray(Kf), jnp.asarray(Kif), **kw)
    got = T_et.compute_pose_2d2d(tk, t(kp_cur), t(kp_ref), torch.from_numpy(mask),
                                 t(Kf), t(Kif), **kw)
    assert_same_estimate(got, want, mask, key_ok="valid")


def test_find_scale_from_depth():
    rng = np.random.RandomState(3)
    n, H, W = 800, 192, 640
    true_scale = 2.8
    kp_cur = rng.uniform([10, 10], [W - 10, H - 10], size=(n, 2))
    depth_vals = rng.uniform(5, 40, n)
    X_cur = (K_inv @ np.concatenate([kp_cur, np.ones((n, 1))], 1).T).T * depth_vals[:, None]
    R = np.asarray(J_pnp.so3_exp(jnp.array([0.01, -0.02, 0.005], jnp.float32)), np.float64)
    t_unit = np.array([0.5, -0.1, 0.85])
    t_unit /= np.linalg.norm(t_unit)
    X_ref = X_cur @ R.T + t_unit * true_scale
    pix = (K @ X_ref.T).T
    kp_ref = pix[:, :2] / pix[:, 2:]
    depth_map = np.zeros((H, W), np.float32)
    ki = kp_cur.astype(int)
    depth_map[ki[:, 1], ki[:, 0]] = depth_vals
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t_unit
    T_ref2cur = np.linalg.inv(T).astype(np.float32)
    mask = np.ones(n, bool)
    jk, tk = keys(3)
    want = J_et.find_scale_from_depth(jk, jnp.asarray(kp_ref, jnp.float32),
                                      jnp.asarray(kp_cur, jnp.float32), jnp.asarray(mask),
                                      jnp.asarray(T_ref2cur), jnp.asarray(depth_map),
                                      jnp.asarray(Kif))
    got = T_et.find_scale_from_depth(tk, t(kp_ref), t(kp_cur), torch.from_numpy(mask),
                                     t(T_ref2cur), t(depth_map), t(Kif))
    assert int(got["valid_cnt"]) == int(want["valid_cnt"])
    assert abs(float(got["scale"]) - float(want["scale"])) <= 1e-3 * abs(float(want["scale"]))


def test_compute_pose_3d2d():
    rng = np.random.RandomState(5)
    n, H, W = 700, 192, 640
    kp_ref = rng.uniform([10, 10], [W - 10, H - 10], size=(n, 2))
    depth_vals = rng.uniform(5, 45, n).astype(np.float32)
    X_ref = (K_inv @ np.concatenate([kp_ref, np.ones((n, 1))], 1).T).T * depth_vals[:, None]
    R = np.asarray(J_pnp.so3_exp(jnp.array([0.02, 0.01, -0.015], jnp.float32)), np.float64)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [0.3, -0.05, 1.2]
    T_ref2cur = np.linalg.inv(T)
    X_cur = X_ref @ T_ref2cur[:3, :3].T + T_ref2cur[:3, 3]
    pix = (K @ X_cur.T).T
    kp_cur = (pix[:, :2] / pix[:, 2:] + rng.randn(n, 2) * 0.2).astype(np.float32)
    depth_map = np.zeros((H, W), np.float32)
    ki = kp_ref.astype(int)
    depth_map[ki[:, 1], ki[:, 0]] = depth_vals
    kp_ref_px = ki.astype(np.float32)
    mask = np.ones(n, bool)
    jk, tk = keys(5)
    want = J_pt.compute_pose_3d2d(jk, jnp.asarray(kp_ref_px), jnp.asarray(kp_cur),
                                  jnp.asarray(mask), jnp.asarray(depth_map), jnp.asarray(Kf),
                                  jnp.asarray(Kif), max_depth=50.0)
    got = T_pt.compute_pose_3d2d(tk, t(kp_ref_px), t(kp_cur), torch.from_numpy(mask),
                                 t(depth_map), t(Kf), t(Kif), max_depth=50.0)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert bool(got["ok"]) == bool(want["ok"])
    T_got, T_want = got["T"].numpy(), np.asarray(want["T"])
    assert rot_deg(T_got[:3, :3], T_want[:3, :3]) < 0.01
    # translation within 5e-3 |t|, not 1e-3: XLA's jit reorders float32
    # reductions, and on this scene the jitted and the op-by-op
    # (jax.disable_jit) runs of this JAX function keep different ones of
    # two near-equal PnP winners, 644 against 646 inliers, their
    # translations 2.7e-3 |t| apart. The port follows the program order
    # and matches the op-by-op run to 3e-7 (ROADMAP queue 3).
    tw = T_want[:3, 3].astype(np.float64)
    assert np.linalg.norm(T_got[:3, 3] - tw) <= 5e-3 * np.linalg.norm(tw)
    agree = got["inliers"].numpy() == np.asarray(want["inliers"])
    assert agree[np.asarray(want["mask"])].mean() >= 0.995
    # and within the JAX test's bounds of the ground truth
    # (tests/test_tracker.py)
    assert rot_deg(T_got[:3, :3], R) < 0.3
    assert np.linalg.norm(T_got[:3, 3] - T[:3, 3]) < 0.1
