"""Parity of the PyTorch port's geometry, PRNG, precision and oracle
modules with the JAX package, on the CPU in float32 from the same numpy
inputs.

Tolerances: the PRNG words and the numpy oracle bit for bit; the lie and
camera ops rtol 1e-5, atol 1e-6 (atol scaled to the values' magnitude for
pixel coordinates, stated at the test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.geometry import camera as T_cam
from dfvo_torch.geometry import lie as T_lie
from dfvo_torch.geometry import ops as T_ops
from dfvo_torch.synth import oracle as T_oracle
from dfvo_torch.utils import precision, prng
from dfvo_tpu.geometry import camera as J_cam
from dfvo_tpu.geometry import lie as J_lie
from dfvo_tpu.geometry import ops as J_ops
from dfvo_tpu.synth import oracle as J_oracle

RTOL, ATOL = 1e-5, 1e-6
K = np.array([[370.0, 0, 320.0], [0, 371.0, 96.0], [0, 0, 1.0]], np.float32)
K_inv = np.linalg.inv(K).astype(np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# PRNG and precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 4869, 2**31 + 5, 2**32 - 1])
def test_prng_words_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key_data(tk), np.asarray(jax.random.key_data(jk)))
    for data in (0, 1, 3, 4540, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data),
            np.asarray(jax.random.key_data(jax.random.fold_in(jk, data))))
    for num in (2, 8):
        np.testing.assert_array_equal(
            prng.split(tk, num), np.asarray(jax.random.key_data(jax.random.split(jk, num))))


def test_prng_known_words():
    assert prng.fold_in(prng.PRNGKey(4869), 3).tolist() == [3995025964, 205306554]
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)


@pytest.mark.parametrize("outside", ["legacy_tf32", "medium"])
def test_highp_turns_tf32_off_and_restores(outside):
    """highp switches cuBLAS's float32 matmuls to true float32 inside and
    leaves the caller's setting as it found it, however the caller set it
    (run in a subprocess: the settings are process-wide)."""
    import subprocess
    import sys

    setup = {"legacy_tf32": "torch.backends.cuda.matmul.allow_tf32 = True",
             "medium": "torch.set_float32_matmul_precision('medium')"}[outside]
    code = f"""
import torch
from dfvo_torch.utils import precision
{setup}
name, off = precision._tf32_setting()
matmul = torch.backends.cuda.matmul
before = getattr(matmul, name)
seen = []

@precision.highp
def probe(fail=False):
    seen.append(getattr(matmul, name))
    if fail:
        raise RuntimeError("inside")

probe()
try:
    probe(fail=True)
except RuntimeError:
    pass
assert seen == [off, off], seen
assert getattr(matmul, name) == before, (getattr(matmul, name), before)
print("ok", name, before)
"""
    repo = __file__.rsplit("/tests/", 1)[0]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=repo, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr[-2000:]


# ---------------------------------------------------------------------------
# lie
# ---------------------------------------------------------------------------

def _rotvecs(rng, n=16):
    w = rng.randn(n, 3).astype(np.float32) * 0.5
    w[0] = 0.0  # the identity
    w[1] = [1e-7, -2e-7, 0.0]  # the series branch
    return w


def test_so3_exp_log_skew():
    w = _rotvecs(np.random.RandomState(0))
    close(T_lie.skew(t(w)), J_lie.skew(jnp.asarray(w)))
    R = T_lie.so3_exp(t(w))
    close(R, J_lie.so3_exp(jnp.asarray(w)))
    close(T_lie.so3_log(R), J_lie.so3_log(jnp.asarray(R.numpy())), rtol=1e-4, atol=1e-6)


def test_make_se3_and_inverse():
    rng = np.random.RandomState(1)
    R = np.asarray(J_lie.so3_exp(jnp.asarray(_rotvecs(rng, 6))))
    tv = rng.randn(6, 3).astype(np.float32)
    T = T_lie.make_se3(t(R), t(tv))
    close(T, J_lie.make_se3(jnp.asarray(R), jnp.asarray(tv)), atol=0)
    close(T_lie.se3_inverse(T), J_lie.se3_inverse(jnp.asarray(T.numpy())))
    close(T_lie.se3_inverse(T[0]), J_lie.se3_inverse(jnp.asarray(T[0].numpy())))


# ---------------------------------------------------------------------------
# dense and sparse camera ops
# ---------------------------------------------------------------------------

def _pose(rng):
    R = np.asarray(J_lie.so3_exp(jnp.asarray(rng.randn(3).astype(np.float32) * 0.05)))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.randn(3) * 0.5
    return T


def test_dense_reprojection_ops():
    rng = np.random.RandomState(2)
    depth = rng.uniform(2.0, 40.0, (2, 24, 40)).astype(np.float32)
    T = np.stack([_pose(rng), _pose(rng)])
    pts = T_ops.backproject_depth(t(depth), t(K_inv))
    close(pts, J_ops.backproject_depth(jnp.asarray(depth), jnp.asarray(K_inv)), atol=1e-5)
    close(T_ops.transform_points(pts, t(T)),
          J_ops.transform_points(jnp.asarray(pts.numpy()), jnp.asarray(T)), atol=1e-5)
    # pixel coordinates of a few hundred: atol 1e-3 px
    close(T_ops.project_points(pts, t(K)),
          J_ops.project_points(jnp.asarray(pts.numpy()), jnp.asarray(K)), atol=1e-3)
    close(T_ops.reproject(t(depth), t(T), t(K), t(K_inv)),
          J_ops.reproject(jnp.asarray(depth), jnp.asarray(T), jnp.asarray(K),
                          jnp.asarray(K_inv)), atol=1e-3)
    close(T_ops.rigid_flow(t(depth), t(T), t(K), t(K_inv)),
          J_ops.rigid_flow(jnp.asarray(depth), jnp.asarray(T), jnp.asarray(K),
                           jnp.asarray(K_inv)), atol=1e-3)


def test_sparse_ops_and_triangulation():
    rng = np.random.RandomState(3)
    n = 64
    kp = rng.uniform([0, 0], [640, 192], (n, 2)).astype(np.float32)
    z = rng.uniform(5, 40, n).astype(np.float32)
    X = T_ops.unproject_kp(t(kp), t(z), t(K_inv))
    close(X, J_ops.unproject_kp(jnp.asarray(kp), jnp.asarray(z), jnp.asarray(K_inv)), atol=1e-5)

    T_2w = _pose(rng)
    T_1w = np.eye(4, dtype=np.float32)
    Xn = X.numpy()
    x1 = (Xn / Xn[:, 2:])[:, :2]
    X2 = Xn @ T_2w[:3, :3].T + T_2w[:3, 3]
    x2 = (X2 / X2[:, 2:])[:, :2]
    got = T_ops.triangulate_depths(t(x1), t(x2), t(T_1w), t(T_2w))
    want = J_ops.triangulate_depths(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(T_1w),
                                    jnp.asarray(T_2w))
    # eight inverse iterations on a 4x4 normal matrix: relative 1e-4
    for g, w in zip(got, want):
        close(g, w, rtol=1e-4, atol=1e-4)
    close(got[1], z, rtol=1e-3)



def test_host_camera_containers():
    rng = np.random.RandomState(4)
    T = _pose(rng).astype(np.float64)
    a, b = T_cam.SE3(T), J_cam.SE3(T)
    np.testing.assert_array_equal(a.inv_pose, b.inv_pose)
    np.testing.assert_array_equal((a @ a).pose, (b @ b).pose)
    a.t = [1.0, 2.0, 3.0]
    b.t = [1.0, 2.0, 3.0]
    np.testing.assert_array_equal(a.pose, b.pose)
    ki, kj = T_cam.Intrinsics([320.0, 96.0, 370.0, 371.0]), J_cam.Intrinsics([320.0, 96.0, 370.0, 371.0])
    np.testing.assert_array_equal(ki.mat, kj.mat)
    np.testing.assert_array_equal(ki.inv_mat, kj.inv_mat)
    np.testing.assert_array_equal(ki.scale(0.5, 0.25).mat, kj.scale(0.5, 0.25).mat)


def test_update_global_pose_matches_the_reference_rule():
    """pipeline/dfvo.py's chaining: t <- R t_new s + t, R <- R R_new."""
    from dfvo_torch.pipeline.dfvo import update_global_pose

    rng = np.random.RandomState(5)
    g0, rel = T_cam.SE3(_pose(rng)), T_cam.SE3(_pose(rng))
    got = update_global_pose(g0, rel, scale=2.0)
    want = g0.pose.copy()
    want[:3, 3] = g0.R @ rel.t[:, 0] * 2.0 + g0.t[:, 0]
    want[:3, :3] = g0.R @ rel.R
    np.testing.assert_allclose(got.pose, want, rtol=1e-12)
    np.testing.assert_array_equal(update_global_pose(g0, rel).pose, (g0 @ rel).pose)


# ---------------------------------------------------------------------------
# synthetic oracle (numpy copy)
# ---------------------------------------------------------------------------

def test_oracle_sequence_bit_exact():
    depths, flows, motions = T_oracle.make_oracle_sequence(24, 40, K, 3, seed=1, speed=2.0)
    jd, jf, jm = J_oracle.make_oracle_sequence(24, 40, K, 3, seed=1, speed=2.0)
    for a, b in zip(depths + flows + motions, jd + jf + jm):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T_oracle.smooth_field(np.random.RandomState(0), 24, 40),
                                  J_oracle.smooth_field(np.random.RandomState(0), 24, 40))
    rng_a, rng_b = np.random.RandomState(2), np.random.RandomState(2)
    for a, b in zip(T_oracle.structured_flow_diff(rng_a, 24, 40),
                    J_oracle.structured_flow_diff(rng_b, 24, 40)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(T_oracle.render_images(depths, flows), J_oracle.render_images(jd, jf)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(T_oracle.chain_motions(motions), J_oracle.chain_motions(jm)):
        np.testing.assert_array_equal(a, b)
