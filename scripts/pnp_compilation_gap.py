#!/usr/bin/env python3
"""How far apart the JAX package's own jitted and op-by-op runs of
``compute_pose_3d2d`` land, on the scene of tests/test_tracker.py::TestPnP.

    JAX_PLATFORMS=cpu python3 scripts/pnp_compilation_gap.py

XLA's jit reorders float32 reductions. Where two RANSAC hypotheses score
within rounding of each other, that can change which one wins, so the
reference is not one number to the last digit. This script prints both
runs' inlier counts and the distance between their translations, relative
to |t|: the spread that a parity test of the port against the jitted
program has to allow. It runs the JAX package only.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dfvo_tpu.geometry.lie import so3_exp  # noqa: E402
from dfvo_tpu.tracker import compute_pose_3d2d  # noqa: E402


def scene():
    """tests/test_tracker.py::TestPnP: 700 keypoints with depths, a known
    motion, 0.2 px of pixel noise."""
    H, W = 192, 640
    K = np.array([[370.0, 0, 320.0], [0, 371.0, 96.0], [0, 0, 1.0]])
    K_inv = np.linalg.inv(K)
    rng = np.random.RandomState(5)
    n = 700
    kp_ref = rng.uniform([10, 10], [W - 10, H - 10], size=(n, 2))
    depth_vals = rng.uniform(5, 45, n).astype(np.float32)
    X_ref = (K_inv @ np.concatenate([kp_ref, np.ones((n, 1))], 1).T).T * depth_vals[:, None]
    T = np.eye(4)
    T[:3, :3] = np.asarray(so3_exp(jnp.array([0.02, 0.01, -0.015], jnp.float32)), np.float64)
    T[:3, 3] = [0.3, -0.05, 1.2]
    T_ref2cur = np.linalg.inv(T)
    X_cur = X_ref @ T_ref2cur[:3, :3].T + T_ref2cur[:3, 3]
    pix = (K @ X_cur.T).T
    kp_cur = pix[:, :2] / pix[:, 2:] + rng.randn(n, 2) * 0.2
    depth_map = np.zeros((H, W), np.float32)
    ki = kp_ref.astype(int)
    depth_map[ki[:, 1], ki[:, 0]] = depth_vals
    return (jax.random.PRNGKey(5), jnp.asarray(ki.astype(np.float32)),
            jnp.asarray(kp_cur, jnp.float32), jnp.ones(n, bool), jnp.asarray(depth_map),
            jnp.asarray(K, jnp.float32), jnp.asarray(K_inv, jnp.float32))


def main():
    args = scene()
    jitted = compute_pose_3d2d(*args, max_depth=50.0)
    with jax.disable_jit():
        op_by_op = compute_pose_3d2d(*args, max_depth=50.0)
    t_j = np.asarray(jitted["T"], np.float64)[:3, 3]
    t_o = np.asarray(op_by_op["T"], np.float64)[:3, 3]
    print(f"jitted:   {int(np.sum(jitted['inliers']))} inliers, t {t_j}")
    print(f"op by op: {int(np.sum(op_by_op['inliers']))} inliers, t {t_o}")
    print(f"|t_jitted - t_op_by_op| / |t| = {np.linalg.norm(t_j - t_o) / np.linalg.norm(t_o):.3e}")


if __name__ == "__main__":
    main()
