"""KITTI odometry evaluation.

Counterpart of ``dfvo_tpu/evaluation/kitti_odometry.py``: the KITTI
protocol (segment errors over 100-800 m starting every 10th frame),
ATE/RPE, scale/6dof/7dof Umeyama alignment, error and trajectory plots
(matplotlib, imported by the plot functions only), and the result.txt
summary. A pose file scores the same under either package.
"""

import os
from glob import glob

import numpy as np

from ..utils.io import load_poses_from_txt


def scale_lse_solver(X, Y):
    """Least-squares scale s minimizing ||s·X - Y||."""
    return np.sum(X * Y) / np.sum(X**2)


def umeyama_alignment(x, y, with_scale=False):
    """Umeyama 1991 Sim(3)/SE(3) alignment of point sets.

    Args:
        x, y: [m x n] points (m = dimension); solves y ≈ c·R·x + t.
        with_scale: solve the similarity (7dof) instead of rigid (6dof).

    Returns:
        (R [mxm], t [m], c scalar).
    """
    if x.shape != y.shape:
        raise ValueError("x.shape not equal to y.shape")
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = 1.0 / n * (np.linalg.norm(x - mean_x[:, None]) ** 2)
    cov_xy = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov_xy)
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[m - 1, m - 1] = -1
    r = u @ s @ v
    c = 1 / sigma_x * np.trace(np.diag(d) @ s) if with_scale else 1.0
    t = mean_y - c * (r @ mean_x)
    return r, t, c


class KittiEvalOdom:
    """KITTI odometry evaluation (segment lengths 100..800 m)."""

    def __init__(self):
        self.lengths = [100, 200, 300, 400, 500, 600, 700, 800]
        self.num_lengths = len(self.lengths)
        self.step_size = 10

    # -- protocol pieces ----------------------------------------------------
    def load_poses_from_txt(self, file_name):
        return load_poses_from_txt(file_name)

    def trajectory_distances(self, poses):
        """Cumulative traveled distance per (sorted) frame."""
        keys = sorted(poses.keys())
        dist = [0.0]
        for i in range(len(keys) - 1):
            d = poses[keys[i]][:3, 3] - poses[keys[i + 1]][:3, 3]
            dist.append(dist[i] + float(np.linalg.norm(d)))
        return dist

    @staticmethod
    def rotation_error(pose_error):
        d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
        return float(np.arccos(np.clip(d, -1.0, 1.0)))

    @staticmethod
    def translation_error(pose_error):
        return float(np.linalg.norm(pose_error[:3, 3]))

    def last_frame_from_segment_length(self, dist, first_frame, length):
        for i in range(first_frame, len(dist)):
            if dist[i] > dist[first_frame] + length:
                return i
        return -1

    def calc_sequence_errors(self, poses_gt, poses_result):
        """[[first_frame, r_err/m, t_err/m, length, speed], ...] following
        the KITTI protocol."""
        err = []
        dist = self.trajectory_distances(poses_gt)
        for first_frame in range(0, len(poses_gt), self.step_size):
            for length in self.lengths:
                last_frame = self.last_frame_from_segment_length(
                    dist, first_frame, length
                )
                if (
                    last_frame == -1
                    or last_frame not in poses_result
                    or first_frame not in poses_result
                ):
                    continue
                delta_gt = (
                    np.linalg.inv(poses_gt[first_frame]) @ poses_gt[last_frame]
                )
                delta_res = (
                    np.linalg.inv(poses_result[first_frame])
                    @ poses_result[last_frame]
                )
                pose_error = np.linalg.inv(delta_res) @ delta_gt
                r_err = self.rotation_error(pose_error)
                t_err = self.translation_error(pose_error)
                num_frames = last_frame - first_frame + 1.0
                speed = length / (0.1 * num_frames)
                err.append([first_frame, r_err / length, t_err / length, length, speed])
        return err

    def compute_overall_err(self, seq_err):
        if not seq_err:
            return 0.0, 0.0
        arr = np.asarray(seq_err)
        return float(arr[:, 2].mean()), float(arr[:, 1].mean())

    def compute_segment_error(self, seq_errs):
        segment_errs = {length: [] for length in self.lengths}
        for err in seq_errs:
            segment_errs[err[3]].append([err[2], err[1]])
        return {
            length: (
                [float(np.mean([e[0] for e in v])), float(np.mean([e[1] for e in v]))]
                if v
                else []
            )
            for length, v in segment_errs.items()
        }

    def compute_ATE(self, gt, pred):
        errors = [
            np.linalg.norm(gt[i][:3, 3] - pred[i][:3, 3]) for i in pred
        ]
        return float(np.sqrt(np.mean(np.asarray(errors) ** 2)))

    def compute_RPE(self, gt, pred):
        rpe = {"trans": [], "rot": []}
        keys = list(pred.keys())
        for cnt in range(len(keys) - 1):
            gt_rel = np.linalg.inv(gt[keys[cnt]]) @ gt[keys[cnt + 1]]
            pred_rel = np.linalg.inv(pred[keys[cnt]]) @ pred[keys[cnt + 1]]
            rel_err = np.linalg.inv(gt_rel) @ pred_rel
            rpe["trans"].append(self.translation_error(rel_err))
            rpe["rot"].append(self.rotation_error(rel_err))
        return rpe

    def scale_optimization(self, gt, pred):
        xyz_pred = np.asarray([pred[i][:3, 3] for i in pred])
        xyz_ref = np.asarray([gt[i][:3, 3] for i in pred])
        scale = scale_lse_solver(xyz_pred, xyz_ref)
        out = {i: pred[i].copy() for i in pred}
        for i in out:
            out[i][:3, 3] *= scale
        return out

    def compute_trajectory_length(self, gt):
        keys = sorted(gt.keys())
        return float(
            sum(
                np.linalg.norm(gt[keys[i]][:3, 3] - gt[keys[i + 1]][:3, 3])
                for i in range(len(keys) - 1)
            )
        )

    # -- alignment + evaluation --------------------------------------------
    def align_poses(self, poses_gt, poses_result, alignment):
        """First-frame alignment + optional scale/6dof/7dof optimization.
        Works on copies and returns them."""
        poses_result = {i: p.copy() for i, p in poses_result.items()}
        poses_gt = {i: p.copy() for i, p in poses_gt.items()}
        idx_0 = sorted(poses_result.keys())[0]
        pred_0 = poses_result[idx_0]
        gt_0 = poses_gt[idx_0]
        for cnt in poses_result:
            poses_result[cnt] = np.linalg.inv(pred_0) @ poses_result[cnt]
            poses_gt[cnt] = np.linalg.inv(gt_0) @ poses_gt[cnt]

        if alignment == "scale":
            poses_result = self.scale_optimization(poses_gt, poses_result)
        elif alignment in ("scale_7dof", "7dof", "6dof"):
            xyz_gt = np.asarray(
                [poses_gt[cnt][:3, 3] for cnt in poses_result]
            ).T
            xyz_result = np.asarray(
                [poses_result[cnt][:3, 3] for cnt in poses_result]
            ).T
            r, t, scale = umeyama_alignment(
                xyz_result, xyz_gt, alignment != "6dof"
            )
            align_T = np.eye(4)
            align_T[:3, :3] = r
            align_T[:3, 3] = t
            for cnt in poses_result:
                poses_result[cnt][:3, 3] *= scale
                if alignment in ("7dof", "6dof"):
                    poses_result[cnt] = align_T @ poses_result[cnt]
        return poses_gt, poses_result

    def eval_seq(self, poses_gt, poses_result, alignment=None):
        """Evaluate one sequence; returns a metrics dict."""
        poses_gt, poses_result = self.align_poses(
            poses_gt, poses_result, alignment
        )
        seq_err = self.calc_sequence_errors(poses_gt, poses_result)
        ave_t_err, ave_r_err = self.compute_overall_err(seq_err)
        ate = self.compute_ATE(poses_gt, poses_result)
        rpe_errors = self.compute_RPE(poses_gt, poses_result)
        return {
            "t_err_percent": ave_t_err * 100,
            "r_err_deg_per_100m": ave_r_err / np.pi * 180 * 100,
            "ate": ate,
            "rpe_m": float(np.mean(rpe_errors["trans"])) if rpe_errors["trans"] else 0.0,
            "rpe_deg": float(np.mean(rpe_errors["rot"])) * 180 / np.pi
            if rpe_errors["rot"]
            else 0.0,
            "seq_len": self.compute_trajectory_length(poses_gt),
            "seq_err": seq_err,
            "segment_errs": self.compute_segment_error(seq_err),
            "poses_gt_aligned": poses_gt,
            "poses_result_aligned": poses_result,
        }

    def plot_trajectory(self, poses_gt, poses_result, seq, out_dir):
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        for label, poses, style in (
            ("Ground Truth", poses_gt, "k-"),
            ("Ours", poses_result, "b-"),
        ):
            xyz = np.asarray([poses[i][:3, 3] for i in sorted(poses.keys())])
            ax.plot(xyz[:, 0], xyz[:, 2], style, label=label)
        ax.set_xlabel("x (m)")
        ax.set_ylabel("z (m)")
        ax.legend()
        ax.set_aspect("equal", adjustable="datalim")
        os.makedirs(out_dir, exist_ok=True)
        fig.savefig(
            os.path.join(out_dir, f"sequence_{seq}.pdf"), bbox_inches="tight"
        )
        plt.close(fig)

    def plot_error(self, avg_segment_errs, seq, out_dir):
        """Per-segment-length translation/rotation error plots."""
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        lengths = [l for l in self.lengths if avg_segment_errs.get(l)]
        if not lengths:
            return
        for name, idx, scale, unit in (
            ("trans", 0, 100.0, "Translation Error (%)"),
            ("rot", 1, 180.0 / np.pi * 100.0, "Rotation Error (deg/100m)"),
        ):
            fig, ax = plt.subplots(figsize=(5, 4))
            ys = [avg_segment_errs[l][idx] * scale for l in lengths]
            ax.plot(lengths, ys, "bs-", label="Ours")
            ax.set_xlabel("Path Length (m)")
            ax.set_ylabel(unit)
            ax.legend()
            fig.savefig(
                os.path.join(out_dir, f"{name}_err_{seq}.pdf"),
                bbox_inches="tight",
            )
            plt.close(fig)

    def eval(self, gt_dir, result_dir, alignment=None, seqs=None):
        """Evaluate sequences in ``result_dir`` against ``gt_dir``; writes
        errors/, result.txt and, with matplotlib, plot_path/ and
        plot_error/."""
        error_dir = os.path.join(result_dir, "errors")
        plot_path_dir = os.path.join(result_dir, "plot_path")
        plot_error_dir = os.path.join(result_dir, "plot_error")
        os.makedirs(error_dir, exist_ok=True)
        os.makedirs(plot_path_dir, exist_ok=True)

        if seqs is None:
            seqs = [
                os.path.basename(p)[:-4]
                for p in sorted(glob(os.path.join(result_dir, "*.txt")))
                if "result" not in os.path.basename(p)
            ]

        try:
            import matplotlib  # noqa: F401
            plots = True
        except ImportError:
            plots = False
            print("matplotlib is not installed: no plots")

        summary = {}
        result_lines = []
        for seq in seqs:
            poses_result = self.load_poses_from_txt(
                os.path.join(result_dir, f"{seq}.txt")
            )
            poses_gt = self.load_poses_from_txt(
                os.path.join(gt_dir, f"{seq}.txt")
            )
            m = self.eval_seq(poses_gt, poses_result, alignment)
            summary[seq] = m

            with open(os.path.join(error_dir, f"{seq}.txt"), "w") as f:
                for e in m["seq_err"]:
                    f.write(" ".join(str(v) for v in e) + "\n")
            if plots:
                self.plot_trajectory(
                    m["poses_gt_aligned"], m["poses_result_aligned"], seq,
                    plot_path_dir,
                )
                self.plot_error(m["segment_errs"], seq, plot_error_dir)

            print(f"Sequence: {seq}")
            print(f"Seq. Length (m): {m['seq_len']:.1f}")
            print(f"Translational error (%): {m['t_err_percent']:.3f}")
            print(f"Rotational error (deg/100m): {m['r_err_deg_per_100m']:.3f}")
            print(f"ATE (m): {m['ate']:.3f}")
            print(f"RPE (m): {m['rpe_m']:.3f}  RPE (deg): {m['rpe_deg']:.3f}")
            result_lines += [
                f"Sequence: \t {seq} \n",
                f"Trans. err. (%): \t {m['t_err_percent']:.3f} \n",
                f"Rot. err. (deg/100m): \t {m['r_err_deg_per_100m']:.3f} \n",
                f"ATE (m): \t {m['ate']:.3f} \n",
                f"RPE (m): \t {m['rpe_m']:.3f} \n",
                f"RPE (deg): \t {m['rpe_deg']:.3f} \n\n",
            ]

        with open(os.path.join(result_dir, "result.txt"), "w") as f:
            f.writelines(result_lines)
        return summary
