"""The port's pose-graph optimiser against the JAX package's on the graphs
of tests/test_pose_graph.py (the drifted circle with its loop closure, and
the fixed vertex), the same graph and iteration counts so that the JAX
suite's compiled program serves the reference. Both run damped
Gauss-Newton in float32: poses within 1e-4 in translation and rotation.
"""

import numpy as np
import pytest

from dfvo_torch.geometry.pose_graph import PoseGraphOptimizer as TOpt
from dfvo_tpu.geometry.pose_graph import PoseGraphOptimizer as JOpt


def _circle(n=12, radius=5.0):
    """tests/test_pose_graph.py's circle, built as that test builds it (the
    JAX package's so3_exp in float32), so that the edges are the same bits."""
    import jax.numpy as jnp

    from dfvo_tpu.geometry.lie import so3_exp

    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        T = np.eye(4)
        T[:3, :3] = np.asarray(so3_exp(jnp.array([0, a, 0], jnp.float32)))
        T[:3, 3] = [radius * np.sin(a), 0.0, radius * (1 - np.cos(a))]
        poses.append(T)
    return poses


def _drift_graph(opt):
    rng = np.random.RandomState(0)
    gt = _circle()
    n = len(gt)
    for i in range(n):
        noisy = gt[i].copy()
        if i > 0:
            noisy[:3, 3] += rng.randn(3) * 0.3
        opt.add_vertex(i, noisy, fixed=(i == 0))
    for i in range(n - 1):
        opt.add_edge((i, i + 1), np.linalg.inv(gt[i]) @ gt[i + 1])
    opt.add_edge((n - 1, 0), np.linalg.inv(gt[n - 1]) @ gt[0])
    return gt, 20


def _fixed_graph(opt):
    T1 = np.eye(4)
    T1[0, 3] = 2.0
    opt.add_vertex(0, np.eye(4), fixed=True)
    opt.add_vertex(1, T1)
    m = np.eye(4)
    m[0, 3] = 1.0
    opt.add_edge((0, 1), m)
    return [np.eye(4), m], 10


@pytest.mark.parametrize("graph", [_drift_graph, _fixed_graph], ids=["drift", "fixed_vertex"])
def test_pose_graph_matches_jax(graph):
    t, j = TOpt(device="cpu"), JOpt()
    gt, iters = graph(t)
    graph(j)
    got = t.optimize(max_iterations=iters)
    want = j.optimize(max_iterations=iters)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0, atol=1e-4)
    # the fixed vertex stays where it was (in float32), and both reach the GT
    np.testing.assert_array_equal(t.get_pose(0), gt[0].astype(np.float32))
    errs = [np.linalg.norm(t.get_pose(i)[:3, 3] - gt[i][:3, 3]) for i in range(len(gt))]
    assert max(errs) < (1e-3 if len(gt) == 2 else 0.02), errs


def test_gauge_defaults_to_the_first_vertex():
    """With no vertex marked fixed, the first of the sorted ids holds."""
    opt = TOpt(device="cpu")
    P = np.eye(4)
    P[1, 3] = 0.5
    opt.add_vertex(3, P)
    opt.add_vertex(7, np.eye(4))
    opt.add_edge((3, 7), np.eye(4))
    opt.optimize(max_iterations=5)
    np.testing.assert_allclose(opt.get_pose(3), P, atol=1e-7)
    np.testing.assert_allclose(opt.get_pose(7), P, atol=1e-5)
