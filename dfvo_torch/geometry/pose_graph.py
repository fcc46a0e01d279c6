"""SE(3) pose-graph optimisation.

Counterpart of ``dfvo_tpu/geometry/pose_graph.py`` (the reference's g2o
optimiser, which the reference itself imports nowhere): damped
Gauss-Newton over left-multiplied se(3) tangent updates of every free
vertex, in float32, with the Jacobian of the edge residuals from
``torch.func.jacfwd``. The same ``add_vertex`` / ``add_edge`` /
``get_pose`` / ``optimize`` API.
"""

import numpy as np
import torch

from ..utils.precision import highp
from .lie import make_se3, se3_inverse, skew, so3_exp, so3_log


def _se3_log(T):
    """[...x4x4] -> [...x6] (w, v), with the first-order V^-1 = I - [w]x / 2
    (enough for the small residuals of a converging graph)."""
    w = so3_log(T[..., :3, :3])
    t = T[..., :3, 3]
    v = t - 0.5 * torch.einsum("...ij,...j->...i", skew(w), t)
    return torch.cat([w, v], dim=-1)


def _apply_delta(poses, delta):
    """Left-multiplicative tangent update: T_i <- exp(delta_i) T_i."""
    T_delta = make_se3(so3_exp(delta[..., :3]), delta[..., 3:])
    return torch.einsum("nij,njk->nik", T_delta, poses)


@highp
def _residuals(poses, edge_i, edge_j, edge_meas_inv):
    """Per-edge se(3) residual log(T_meas^-1 T_i^-1 T_j), flattened."""
    rel = torch.einsum("nij,njk->nik", se3_inverse(poses[edge_i]), poses[edge_j])
    err = torch.einsum("nij,njk->nik", edge_meas_inv, rel)
    return _se3_log(err).reshape(-1)


class PoseGraphOptimizer:
    """Vertices (4x4 poses, some fixed) and relative-pose edges; ``optimize``
    runs on ``device`` (the card by default)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._vertices = {}
        self._fixed = set()
        self._edges = []

    def add_vertex(self, vid, pose, fixed=False):
        """pose: [4x4] initial estimate."""
        self._vertices[vid] = np.asarray(pose, np.float64)
        if fixed:
            self._fixed.add(vid)

    def add_edge(self, vertices, measurement, information=None):
        """vertices: (i, j); measurement: [4x4] relative pose T_ij with
        T_j = T_i T_ij. ``information`` is accepted and unused, as in the
        JAX package."""
        i, j = vertices
        self._edges.append((i, j, np.asarray(measurement, np.float64)))

    def get_pose(self, vid):
        return self._vertices[vid]

    def optimize(self, max_iterations=20, damping=1e-6):
        """Damped Gauss-Newton over the vertices in sorted id order. The
        gauge is fixed by the ``fixed`` vertices (vertex 0 of the order when
        none is): their Jacobian columns and updates are masked to zero.
        Returns the optimised poses [N x 4 x 4] (float64) and stores them."""
        dev = self.device
        vids = sorted(self._vertices)
        index = {v: k for k, v in enumerate(vids)}
        n = len(vids)
        poses = torch.as_tensor(np.stack([self._vertices[v] for v in vids]),
                                dtype=torch.float32, device=dev)
        fixed = self._fixed or {vids[0]}
        col_mask = torch.as_tensor(np.repeat([v not in fixed for v in vids], 6),
                                   dtype=torch.float32, device=dev)
        edge_i = torch.as_tensor([index[e[0]] for e in self._edges], device=dev)
        edge_j = torch.as_tensor([index[e[1]] for e in self._edges], device=dev)
        meas_inv = torch.as_tensor(np.stack([np.linalg.inv(e[2]) for e in self._edges]),
                                   dtype=torch.float32, device=dev)
        eye = torch.eye(n * 6, dtype=torch.float32, device=dev)
        delta0 = torch.zeros(n * 6, dtype=torch.float32, device=dev)

        for _ in range(max_iterations):
            def r_of_delta(delta, poses=poses):
                return _residuals(_apply_delta(poses, delta.reshape(n, 6)), edge_i, edge_j,
                                  meas_inv)

            J = torch.func.jacfwd(r_of_delta)(delta0) * col_mask[None, :]
            r = r_of_delta(delta0)
            H = J.T @ J + damping * eye
            delta = -torch.linalg.solve(H, J.T @ r) * col_mask
            poses = _apply_delta(poses, delta.reshape(n, 6))

        poses_opt = poses.cpu().numpy().astype(np.float64)
        for v in vids:
            self._vertices[v] = poses_opt[index[v]]
        return poses_opt
