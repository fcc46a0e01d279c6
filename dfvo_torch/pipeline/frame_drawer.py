"""Offline frame visualization: one composite image per frame.

Counterpart of ``dfvo_tpu/pipeline/frame_drawer.py``, drawn with cv2 on the
host: the trajectory map on the left half; temporal and side-by-side
keypoint matches; depth and forward flow; backward flow or rigid-flow
difference and the forward-backward flow difference. The trajectory map
zooms out when a point leaves it. Frames go to ``<result_dir>/img/`` as
JPEGs and the map to ``map.png``; there is no interactive window. The
device outputs arrive as numpy arrays (``DFVO`` downloads them once per
frame, and only when the drawer is on).
"""

import os

import cv2
import numpy as np

from ..flowlib import flow_to_image
from ..utils.io import mkdir_if_not_exists

# jet-style tiles use cv2.COLORMAP_JET on a clipped [0, vmax] range


def draw_match_temporal(img1, kp1, img2, kp2, n):
    """Matches as motion lines laid over the current image (per-match
    colors from a fixed seed)."""
    out = np.ascontiguousarray(img2[..., ::-1])  # RGB -> BGR copy
    if len(kp1) == 0:
        return out
    kp_list = np.linspace(0, min(len(kp1), len(kp2)) - 1, n, dtype=int)
    rng = np.random.RandomState(0)  # deterministic colors, headless runs
    for i in kp_list:
        p1 = tuple(np.round(kp1[i]).astype(int))
        p2 = tuple(np.round(kp2[i]).astype(int))
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        cv2.line(out, p1, p2, color, 2)
    return out


def draw_match_side(img1, kp1, img2, kp2, n, inliers=None):
    """Side-by-side matches (cv2.drawMatches); with an inlier mask,
    inliers green and outliers red blended 50/50. Without keypoints (a
    frame whose flow passes no consistency check) the two images alone;
    the JAX package's drawer raises an IndexError there."""
    img1 = np.ascontiguousarray(img1[..., ::-1])
    img2 = np.ascontiguousarray(img2[..., ::-1])
    n_kp = min(len(kp1), len(kp2))
    kp_list = np.linspace(0, n_kp - 1, n, dtype=int) if n_kp else np.zeros(0, int)
    cv_kp1 = [cv2.KeyPoint(float(pt[0]), float(pt[1]), 1.0) for pt in kp1[kp_list]]
    cv_kp2 = [cv2.KeyPoint(float(pt[0]), float(pt[1]), 1.0) for pt in kp2[kp_list]]
    matches = [
        cv2.DMatch(_imgIdx=0, _queryIdx=i, _trainIdx=i, _distance=0)
        for i in range(len(cv_kp1))
    ]
    if inliers is not None:
        inl = np.asarray(inliers).astype(bool)[kp_list]
        img_in = cv2.drawMatches(
            img1, cv_kp1, img2, cv_kp2, matches, None,
            matchColor=(0, 255, 0), matchesMask=inl.astype(int).tolist(),
            flags=2,
        )
        img_out = cv2.drawMatches(
            img1, cv_kp1, img2, cv_kp2, matches, None,
            matchColor=(0, 0, 255), matchesMask=(~inl).astype(int).tolist(),
            flags=2,
        )
        return cv2.addWeighted(img_in, 0.5, img_out, 0.5, 0)
    return cv2.drawMatches(img1, cv_kp1, img2, cv_kp2, matches, None)


def _jet_tile(values, vmax):
    v = np.clip(np.asarray(values, np.float32) / max(vmax, 1e-12), 0, 1)
    return cv2.applyColorMap((v * 255).astype(np.uint8), cv2.COLORMAP_JET)


class FrameDrawer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.vis_cfg = cfg.visualization
        h = self.vis_cfg.window_h
        w = self.vis_cfg.window_w
        self.h, self.w = h, w
        self.img = np.zeros((h, w, 3), np.uint8)

        # the tile grid, in quarters of (h, w)
        q = lambda a, b: (int(h / 4 * a), int(w / 4 * b))
        self.layout = {
            "traj": (q(0, 0), q(4, 2)),
            "match_temp": (q(0, 2), q(1, 4)),
            "match_side": (q(1, 2), q(2, 4)),
            "depth": (q(2, 2), q(3, 3)),
            "flow1": (q(2, 3), q(3, 4)),
            "flow2": (q(3, 2), q(4, 3)),
            "rigid_flow_diff": (q(3, 2), q(4, 3)),  # shares the flow2 slot
            "opt_flow_diff": (q(3, 3), q(4, 4)),
        }

        # trajectory state
        self.text_y = 0.9
        self.traj_scale = float(self.vis_cfg.trajectory.vis_scale or 1)
        self.mono_scale = float(self.vis_cfg.trajectory.mono_scale or 1)
        self.draw_scale = 1.0  # shrinks on auto-rezoom
        traj_tl, traj_br = self.layout["traj"]
        self.traj_map_h = int(self.h * self.text_y)
        self.traj_w = traj_br[1] - traj_tl[1]
        self.traj_y0 = int((traj_br[0] * self.text_y - traj_tl[0]) / 2)
        self.traj_x0 = int(self.traj_w / 2)

        self.save_dir = os.path.join(cfg.directory.result_dir, "img")
        if self.vis_cfg.save_img:
            mkdir_if_not_exists(self.save_dir)

    # ------------------------------------------------------------------
    def _set_tile(self, name, tile):
        (y0, x0), (y1, x1) = self.layout[name]
        self.img[y0:y1, x0:x1] = cv2.resize(tile, (x1 - x0, y1 - y0))

    def _traj_map(self):
        (y0, x0), (_, x1) = self.layout["traj"]
        return self.img[y0 : self.traj_map_h, x0:x1]

    def _draw_traj_circle(self, x, z, scale, color):
        traj_map = self._traj_map()
        dx = int(round(x * scale)) + self.traj_x0
        dy = -int(round(z * scale)) + self.traj_y0
        cv2.circle(
            traj_map, (dx, dy), 1, color, max(1, int(10 * self.draw_scale))
        )

    def draw_traj(self, vo):
        """Trajectory map with auto-rezoom: when the new point leaves the
        canvas, the accumulated map is shrunk by 0.9 about the origin and
        the scale is updated."""
        traj_map = self._traj_map()
        th, tw, _ = traj_map.shape
        latest_id = vo.cur_data["id"]
        pose = vo.global_poses[latest_id].pose
        x, y, z = (pose[:3, 3] * self.mono_scale).tolist()

        pred_scale = self.draw_scale * self.traj_scale
        draw_x = int(x * pred_scale) + self.traj_x0
        draw_y = -int(z * pred_scale) + self.traj_y0

        if not (0 <= draw_x < tw and 0 <= draw_y < th):
            # shrink the accumulated map and recenter about the origin
            scale = 0.9
            zoom = cv2.resize(traj_map, (int(tw * scale), int(th * scale)))
            zh, zw, _ = zoom.shape
            traj_map[...] = 0
            ty0 = int(self.traj_y0 - zh / 2)
            tx0 = int(self.traj_x0 - zw / 2)
            # clip paste region to the canvas
            sy0, sx0 = max(-ty0, 0), max(-tx0, 0)
            ty0, tx0 = max(ty0, 0), max(tx0, 0)
            paste = zoom[sy0:, sx0:][: th - ty0, : tw - tx0]
            traj_map[ty0 : ty0 + paste.shape[0], tx0 : tx0 + paste.shape[1]] = paste
            self.draw_scale *= scale
            pred_scale = self.draw_scale * self.traj_scale

        self._draw_traj_circle(x, z, pred_scale, (0, 255, 0))
        if (
            self.vis_cfg.trajectory.vis_gt_traj
            and latest_id in vo.dataset.gt_poses
        ):
            gt_t = vo.dataset.gt_poses[latest_id][:3, 3]
            self._draw_traj_circle(
                gt_t[0], gt_t[2], self.traj_scale * self.draw_scale, (0, 0, 255)
            )
        # origin marker
        cv2.circle(
            self.img, (self.traj_x0, self.traj_y0), 1, (255, 255, 255), 10
        )

        # text block
        (ty, tx), (by, bx) = self.layout["traj"]
        traj = self.img[ty:by, tx:bx]
        th_full, tw_full, _ = traj.shape
        cv2.rectangle(
            traj, (0, int(th_full * self.text_y)), (tw_full, th_full),
            (0, 0, 0), -1,
        )
        font = cv2.FONT_HERSHEY_PLAIN
        cv2.putText(
            traj, f"Coordinates: x={x:.2f} y={y:.2f} z={z:.2f}",
            (int(tw_full * 0.01), int(th_full * 0.92)), font, 1,
            (255, 255, 255), 1, 8,
        )
        cv2.putText(
            traj, f"Tracking mode: {getattr(vo, 'tracking_mode', 'n/a')}",
            (int(tw_full * 0.01), int(th_full * 0.96)), font, 1,
            (255, 255, 255), 1, 8,
        )
        cv2.putText(
            traj, f"seq: {vo.cfg.seq}  frame: {latest_id}",
            (int(tw_full * 0.01), int(th_full * 0.99)), font, 1,
            (255, 255, 255), 1, 8,
        )

    # ------------------------------------------------------------------
    def draw_frame(self, vo, out):
        """Compose and save the visualization for the current frame.

        Args:
            vo: the DFVO instance (for poses, images, dataset GT).
            out: the frame step's outputs as numpy arrays.
        """
        if self.vis_cfg.trajectory.vis_traj:
            self.draw_traj(vo)

        img_cur = vo.cur_data["img"]
        img_ref = vo.ref_data.get("img", img_cur)

        kp_ref = np.asarray(out["kp_ref"])
        kp_cur = np.asarray(out["kp_cur"])
        valid = np.asarray(out["kp_valid"])
        sel = np.where(valid)[0]
        kp_ref_v, kp_cur_v = kp_ref[sel], kp_cur[sel]
        inliers_v = np.asarray(out.get("inliers", valid))[sel]
        n_vis = int(self.vis_cfg.kp_match.kp_num)

        if self.vis_cfg.kp_match.vis_temp.enable:
            self._set_tile(
                "match_temp",
                draw_match_temporal(img_ref, kp_ref_v, img_cur, kp_cur_v, n_vis),
            )
        if self.vis_cfg.kp_match.vis_side.enable:
            inl = (
                inliers_v
                if self.vis_cfg.kp_match.vis_side.inlier_plot
                else None
            )
            self._set_tile(
                "match_side",
                draw_match_side(img_ref, kp_ref_v, img_cur, kp_cur_v, n_vis, inl),
            )

        # depth (magma inverse depth)
        if self.vis_cfg.depth.depth_disp is not None:
            depth = np.asarray(out["depth_cur"])
            disp = np.zeros_like(depth)
            disp[depth > 0] = 1.0 / depth[depth > 0]
            if disp.max() > 0:
                disp_vis = (disp / disp.max() * 255).astype(np.uint8)
            else:
                disp_vis = disp.astype(np.uint8)
            self._set_tile("depth", cv2.applyColorMap(disp_vis, cv2.COLORMAP_MAGMA))

        # flows (middlebury colors)
        if self.vis_cfg.flow.vis_forward_flow and "flow_fwd" in out:
            self._set_tile(
                "flow1",
                cv2.cvtColor(
                    flow_to_image(np.asarray(out["flow_fwd"])), cv2.COLOR_RGB2BGR
                ),
            )
        vis_rigid = self.vis_cfg.flow.vis_rigid_diff and "rigid_flow_diff" in out
        if (
            self.vis_cfg.flow.vis_backward_flow
            and "flow_bwd" in out
            and not vis_rigid  # rigid diff shares the flow2 slot
        ):
            self._set_tile(
                "flow2",
                cv2.cvtColor(
                    flow_to_image(np.asarray(out["flow_bwd"])), cv2.COLOR_RGB2BGR
                ),
            )

        # optical-rigid flow consistency, vmax = rigid thre
        if vis_rigid:
            vmax = float(
                vo.cfg.kp_selection.rigid_flow_kp.get("rigid_flow_thre", 5.0)
            )
            self._set_tile(
                "rigid_flow_diff", _jet_tile(out["rigid_flow_diff"], vmax)
            )

        # forward-backward flow consistency: vmax 0.1 for flow_ratio
        # scoring, else 1
        if self.vis_cfg.flow.vis_flow_diff and "flow_diff" in out:
            if (
                vo.cfg.kp_selection.local_bestN.enable
                and vo.cfg.kp_selection.local_bestN.score_method == "flow_ratio"
            ):
                vmax = 0.1
            else:
                vmax = 1.0
            self._set_tile("opt_flow_diff", _jet_tile(out["flow_diff"], vmax))

        if self.vis_cfg.save_img:
            cv2.imwrite(
                os.path.join(self.save_dir, f"{vo.cur_data['id']:06d}.jpg"),
                self.img,
            )

    def save_traj_map(self, path):
        (y0, x0), (_, x1) = self.layout["traj"]
        cv2.imwrite(path, self.img[y0 : self.traj_map_h, x0:x1])
