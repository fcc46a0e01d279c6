"""DF-VO's frame loop: the ``DFVO`` class and its per-frame step.

Counterpart of ``dfvo_tpu/pipeline/dfvo.py``, in both of its executions:
the default frame execution and, with ``tpu.execution: scan``, the chunked
one of ``pipeline/scan_runner.py`` (:meth:`DFVO._main_scan`). The step
functions are its ``depth_only`` closure (the first frame's depth), its
``full_step`` closure (here :func:`frame_step`: uint8 images ->
``DeepFrontend.infer`` -> ``tracking_step``) and the pose chaining of
``DFVO.update_global_pose``. :class:`DFVO` runs them over a
dataset: frames decoded ahead by a prefetcher, the scale and the previous
motion carried on the device, the global trajectory chained on the host,
the optional drawer, and the trajectory file.

Per tracked frame the loop reads the device twice: the PnP decision inside
``tracking_step`` and the relative pose (only the pose with
``tracking_method: deep_pose``, which skips the tracking step). The drawer, when it is on, adds
one batched download of what it draws (the tracking mode included). The
scan execution reads the device twice per chunk: the chunk's decision
tensors and its poses. Online finetuning (``online_finetune.enable``,
``pipeline/finetune.py``) adds no read to either: after each tracked frame,
or after each chunk, it updates the float32 masters on the device from the
pose still on the device, and refreshes the inference copy there.

``DFVO.save_state`` checkpoints the mid-sequence state of the frame
execution (the JAX package's fields, ``utils/checkpoint.py``); a fresh
instance that ``load_state``s it resumes with
``main(start_frame=ref_id + 1)``.
"""

import os

import numpy as np
import torch

from ..datasets import datasets as dataset_registry
from ..geometry.camera import SE3
from ..utils import prng
from ..utils.device import upload
from ..utils.io import mkdir_if_not_exists
from ..utils.timer import Timer
from .frontend import DeepFrontend
from .tracking import TrackingConfig, tracking_step

_MODE_NAMES = {0: "Const.", 1: "Ess. Mat.", 2: "PnP", 3: "DeepPose"}
# the frame step's outputs that the drawer reads
_DRAWN = ("mode", "kp_ref", "kp_cur", "kp_valid", "inliers", "depth_cur", "flow_fwd",
          "flow_bwd", "flow_diff", "rigid_flow_diff")
PROGRESS_EVERY = 100  # frames between progress lines


def _to_unit_float(img_u8):
    return img_u8.to(torch.float32) / 255.0


@torch.no_grad()
def depth_only(frontend, variables, img_u8):
    """Raw depth [H x W] of one uint8 frame [H x W x 3] (the first frame's
    reference depth), or [S x H x W] of S frames [S x H x W x 3] (the
    first frames of S sequences)."""
    single = img_u8.dim() == 3
    depth = frontend._depth(variables, _to_unit_float(img_u8[None] if single else img_u8)
                            .to(frontend.dtype))
    return depth[0] if single else depth


@torch.no_grad()
def frame_step(frontend, tcfg, variables, img_cur_u8, img_ref_u8, depth_ref_raw,
               prev_motion, rng, K, K_inv, prev_scale, gt_depth_cur=None):
    """One frame pair through the networks and the tracking step.

    Args:
        frontend: DeepFrontend.
        tcfg: TrackingConfig.
        variables: prepared network variables.
        img_cur_u8, img_ref_u8: [H x W x 3] uint8 frames on the device.
        depth_ref_raw: [H x W] raw depth of the reference frame.
        prev_motion: [4 x 4] previous relative pose.
        rng: the frame's key, ``fold_in(PRNGKey(cfg.seed), img_id)``.
        K, K_inv: [3 x 3] float32 intrinsics on the device.
        prev_scale: previous frame's scale (0-d tensor or number).
        gt_depth_cur: optional [H x W] depth that replaces the depth CNN.

    Returns:
        dict with ``pose``, ``mode``, ``scale``, ``depth_cur_raw``, the
        flows, keypoints, inliers, ``rigid_flow_diff`` and ``depth_cur``.
        With ``tracking_method: deep_pose`` the pose is the pose CNN's
        (mode 3), with scale 1 and no keypoints.
    """
    fo = frontend.infer(variables, _to_unit_float(img_cur_u8), _to_unit_float(img_ref_u8),
                        depth_cur=gt_depth_cur)
    if tcfg.tracking_method == "deep_pose":
        return _deep_pose_out(fo)
    tr = tracking_step(rng, fo["flow_fwd"], fo["flow_diff"], fo["depth_cur"], depth_ref_raw,
                       prev_motion, K, K_inv, tcfg, prev_scale=prev_scale,
                       deep_pose=fo.get("deep_pose"))
    return {
        "pose": tr["pose"],
        "mode": tr["mode"],
        "scale": tr["scale"],
        "depth_cur_raw": fo["depth_cur"],
        "flow_fwd": fo["flow_fwd"],
        "flow_bwd": fo["flow_bwd"],
        "flow_diff": fo["flow_diff"],
        "kp_ref": tr["kp_ref"],
        "kp_cur": tr["kp_cur"],
        "kp_valid": tr["kp_valid"],
        "inliers": tr["inliers"],
        "rigid_flow_diff": tr["rigid_flow_diff"],
        "depth_cur": tr["depth_cur"],
    }


def _deep_pose_out(fo):
    """The frame step's outputs of pure pose-CNN tracking: the pose CNN's
    pose, mode 3, scale 1, one invalid keypoint."""
    dev = fo["flow_fwd"].device
    none = torch.zeros(1, dtype=torch.bool, device=dev)
    return {
        "pose": fo["deep_pose"],
        "mode": torch.full((), 3, dtype=torch.long, device=dev),
        "scale": torch.ones((), dtype=torch.float32, device=dev),
        "depth_cur_raw": fo["depth_cur"],
        "flow_fwd": fo["flow_fwd"],
        "flow_bwd": fo["flow_bwd"],
        "flow_diff": fo["flow_diff"],
        "kp_ref": torch.zeros((1, 2), dtype=torch.float32, device=dev),
        "kp_cur": torch.zeros((1, 2), dtype=torch.float32, device=dev),
        "kp_valid": none,
        "inliers": none,
        "rigid_flow_diff": torch.zeros_like(fo["flow_diff"]),
        "depth_cur": fo["depth_cur"],
    }


def update_global_pose(ref_pose, new_pose, scale=1.0):
    """Chain a relative pose (cur -> ref, geometry.camera.SE3) onto the
    reference frame's global pose: t <- R t_new * scale + t,
    R <- R R_new. Returns a new SE3."""
    pose = ref_pose.copy()
    pose.t = pose.R @ new_pose.t * scale + pose.t
    pose.R = pose.R @ new_pose.R
    return pose


def next_prev_scale(scale, prev_scale):
    """The scale carried to the next frame: this frame's when positive."""
    return torch.where(scale > 0, scale, prev_scale)


def _check_execution(cfg):
    """Raise for an unknown execution, and for the options that the scan
    execution refuses in both packages."""
    execution = str(cfg.tpu.get("execution", "frame"))
    if execution not in ("frame", "scan"):
        raise ValueError(f"tpu.execution must be 'frame' or 'scan', got {execution!r}")
    if execution == "scan":
        unsupported = [what for on, what in (
            (str(cfg.tracking_method) == "deep_pose", "tracking_method: deep_pose"),
            (cfg.depth.get("depth_src") == "gt", "depth_src: gt"),
            (bool(cfg.deep_pose.enable), "deep_pose.enable"),
        ) if on]
        if unsupported:
            raise ValueError(
                "tpu.execution: scan does not support " + ", ".join(unsupported)
                + " (these need per-frame host state; use tpu.execution: frame)")


def _resolve_device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("DFVO runs on a CUDA device by default and none is "
                               "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class DFVO:
    """The per-frame DF-VO loop over one sequence.

    Args:
        cfg: the merged configuration (``utils.ConfigLoader``).
        device: torch device of the networks and the tracking step; None
            means ``cuda`` and raises when no GPU is present.
    """

    def __init__(self, cfg, device=None):
        self.device = _resolve_device(device)
        _check_execution(cfg)
        self.cfg = cfg
        self.tracking_stage = 0
        self.global_poses = {0: SE3()}
        self.ref_data = {}
        self.cur_data = {}
        self.setup()

    def setup(self):
        self.timers = Timer()
        self.dataset = dataset_registry[self.cfg.dataset](self.cfg)
        self.tracking_method = self.cfg.tracking_method
        self.tcfg = TrackingConfig.from_cfg(self.cfg)
        # depth_src: gt feeds the dataset's depths and skips the depth CNN
        self.use_gt_depth = getattr(self.dataset, "data_dir", {}).get("depth_src") == "gt"

        self.frontend = DeepFrontend(self.cfg, self.device)
        self.variables = self.frontend.load_variables(
            torch.Generator().manual_seed(int(self.cfg.seed)))
        # inference copy on the device in the network dtype
        self.infer_variables = self.frontend.prepare_variables(self.variables)

        K = self.dataset.cam_intrinsics
        self.K = torch.as_tensor(K.mat, dtype=torch.float32, device=self.device)
        self.K_inv = torch.as_tensor(K.inv_mat, dtype=torch.float32, device=self.device)
        # the scale carried to the next frame stays on the device
        self.prev_scale = torch.ones((), dtype=torch.float32, device=self.device)

        self.drawer = None
        if self.cfg.visualization.enable:
            from .frame_drawer import FrameDrawer

            self.drawer = FrameDrawer(self.cfg)

        # online finetuning: float32 masters and the Adam state on the device
        self.finetuner = None
        if self.cfg.online_finetune.enable:
            from .finetune import OnlineFinetuner

            self.finetuner = OnlineFinetuner(self.frontend, self.cfg)
            self.variables = {net: {k: v.to(self.device) for k, v in sd.items()}
                              for net, sd in self.variables.items()}
            self.infer_variables = self.frontend.prepare_variables(self.variables)
            self.opt_state = self.finetuner.init_state(self.variables, K.mat, K.inv_mat)
            self.finetune_cnt = 0

    def _upload(self, arr, dtype=None):
        """A host array on the device without a host synchronisation."""
        return upload(arr, self.device, dtype)

    def _download(self, out, keys):
        """Several device tensors on the host after one synchronisation."""
        if self.device.type != "cuda":
            return {k: out[k].numpy() for k in keys}
        host = {k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=True)
                for k in keys}
        for k in keys:
            host[k].copy_(out[k], non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def update_global_pose(self, new_pose, scale=1.0):
        """Chain the relative pose onto the current frame's pose (which
        starts as the reference frame's global pose)."""
        self.cur_data["pose"] = update_global_pose(self.cur_data["pose"], new_pose, scale)
        self.global_poses[self.cur_data["id"]] = self.cur_data["pose"].copy()

    # ------------------------------------------------------------------
    def run_frame(self, img_id, img=None):
        """Process one frame; returns the tracking mode's name ("n/a" when
        the drawer is off, since reading it would cost a host read).

        ``img`` may come from the prefetcher; otherwise the dataset loads
        it.
        """
        self.cur_data["id"] = img_id
        self.cur_data["timestamp"] = self.dataset.get_timestamp(img_id)

        with self.timers.scope("data_loading", "DF-VO"):
            if img is None:
                img = self.dataset.get_image(self.cur_data["timestamp"])
            self.cur_data["img"] = img
            img_dev = self._upload(img)
            gt_depth_dev = None
            if self.use_gt_depth:
                gt_depth_dev = self._upload(
                    self.dataset.get_depth(self.cur_data["timestamp"]), torch.float32)

        mode = "None"
        if self.tracking_stage == 0:
            # first frame: the global pose, and the depth the next frame's
            # PnP fallback needs
            if self.cfg.directory.gt_pose_dir is not None:
                self.cur_data["pose"] = SE3(self.dataset.gt_poses[min(self.dataset.gt_poses)])
            else:
                self.cur_data["pose"] = SE3()
            self.ref_data["motion"] = torch.eye(4, dtype=torch.float32, device=self.device)
            if self.use_gt_depth:
                self.cur_data["raw_depth_dev"] = gt_depth_dev
            else:
                with self.timers.scope("depth_cnn", "DF-VO"):
                    self.cur_data["raw_depth_dev"] = depth_only(
                        self.frontend, self.infer_variables, img_dev)
        else:
            with self.timers.scope("vo_step", "DF-VO"):
                out = frame_step(
                    self.frontend, self.tcfg, self.infer_variables, img_dev,
                    self.ref_data["img_dev"], self.ref_data["raw_depth_dev"],
                    self.ref_data["motion"], prng.fold_in(prng.PRNGKey(self.cfg.seed), img_id),
                    self.K, self.K_inv, self.prev_scale, gt_depth_cur=gt_depth_dev)
                pose_rel = SE3(out["pose"].to("cpu", torch.float64).numpy())
            self.prev_scale = next_prev_scale(out["scale"], self.prev_scale)
            drawn = None
            mode = "n/a"
            if self.drawer is not None:
                drawn = self._download(out, _DRAWN)
                mode = _MODE_NAMES[int(drawn["mode"])]
            self.tracking_mode = mode  # shown in the drawer's text block
            self.cur_data["pose"] = self.global_poses[self.ref_data["id"]].copy()
            self.update_global_pose(pose_rel, 1.0)
            # the next step's constant-motion model, kept on the device
            self.ref_data["motion"] = out["pose"]
            self.cur_data["raw_depth_dev"] = out["depth_cur_raw"]
            self.cur_data["vo_out"] = out
            if self._finetunes():
                with self.timers.scope("finetune", "DF-VO"):
                    self.variables, self.opt_state, _ = self.finetuner.update(
                        self.variables, self.opt_state, _to_unit_float(self.ref_data["img_dev"]),
                        _to_unit_float(img_dev), out["pose"])
                    self.infer_variables = self.frontend.prepare_variables(self.variables)
                self.finetune_cnt += 1
            if drawn is not None:
                with self.timers.scope("visualization", "DF-VO"):
                    self.drawer.draw_frame(self, drawn)

        # roll cur -> ref
        self.ref_data = {
            "id": self.cur_data["id"],
            "img": self.cur_data["img"],
            "img_dev": img_dev,
            "raw_depth_dev": self.cur_data["raw_depth_dev"],
            "motion": self.ref_data["motion"],
        }
        self.tracking_stage += 1
        return mode

    def _finetunes(self):
        """Whether the next frame pair gets a finetuning update."""
        return self.finetuner is not None and (
            self.finetuner.num_frames is None or self.finetune_cnt < self.finetuner.num_frames)

    def _frame_ids(self, start_frame, num_frames):
        end = len(self.dataset)
        if num_frames is not None:
            end = min(end, start_frame + num_frames)
        return list(range(start_frame, end, self.cfg.frame_step))

    def _prefetcher(self, frame_ids):
        """A prefetcher decoding ``frame_ids`` ahead of the tracker (None
        when the dataset loads its own images)."""
        from ..utils.native_loader import make_prefetcher

        self.loader = "dataset"
        if not (hasattr(self.dataset, "get_image_path") and frame_ids):
            return None
        paths = [self.dataset.get_image_path(self.dataset.get_timestamp(i)) for i in frame_ids]
        prefetcher = make_prefetcher(paths, self.cfg.image.height, self.cfg.image.width)
        self.loader = prefetcher.name
        return prefetcher

    def main(self, start_frame=0, num_frames=None):
        """Run the sequence from ``start_frame`` (``num_frames`` of it, or
        to its end), then save the results. ``tpu.execution`` selects the
        loop: ``frame`` (one step per frame) or ``scan`` (chunks of
        ``tpu.scan_chunk`` frames, :meth:`_main_scan`)."""
        if str(self.cfg.tpu.get("execution", "frame")) == "scan":
            return self._main_scan(start_frame, num_frames)
        print("==> Start DF-VO")
        print(f"==> Running sequence: {self.cfg.seq}")
        frame_ids = self._frame_ids(start_frame, num_frames)
        prefetcher = self._prefetcher(frame_ids)
        try:
            for n, img_id in enumerate(frame_ids, 1):
                self.timers.start("DF-VO")
                img = prefetcher.next()[1] if prefetcher is not None else None
                self.run_frame(img_id, img=img)
                self.timers.end("DF-VO")
                if n % PROGRESS_EVERY == 0 or n == len(frame_ids):
                    print(f"==> frame {n}/{len(frame_ids)}, "
                          f"{1.0 / max(self.timers.get_mean('DF-VO'), 1e-9):.2f} frames/s")
        finally:
            if prefetcher is not None:
                prefetcher.close()
        print("=> Finish!")
        return self.save_results()

    def _main_scan(self, start_frame=0, num_frames=None):
        """The chunked loop: T = ``tpu.scan_chunk`` frames per
        ``chunk_step`` (one batched network call and one batched tracking
        pass), uploaded from pinned memory with their keys, and one
        [T x 4 x 4] pose download per chunk, chained on the host. The last
        chunk is padded with its last frame, whose key it repeats. As in
        the JAX package, the trajectory starts at the GT's first pose when
        a GT is configured (the frame execution starts at the identity),
        and the drawer draws the trajectory map only. With online
        finetuning, one update per frame pair runs after each chunk, over
        the previous chunk's last frame and this chunk, from the poses on
        the device; the next chunk's inference uses the updated weights, so
        a chunk's own inference runs on the weights of the chunk before."""
        from .scan_runner import ScanRunner

        print("==> Start DF-VO (scan execution)")
        print(f"==> Running sequence: {self.cfg.seq}")
        runner = ScanRunner(self.cfg, frontend=self.frontend)
        chunk = runner.chunk
        if self.finetuner is not None:
            chunk_update = self.finetuner.make_chunk_update_fn()
        frame_ids = self._frame_ids(start_frame, num_frames)
        if not frame_ids:
            print("=> Finish!")
            return self.save_results()
        prefetcher = self._prefetcher(frame_ids)

        def load(i):
            if prefetcher is not None:
                return prefetcher.next()[1]
            return self.dataset.get_image(self.dataset.get_timestamp(i))

        try:
            first = frame_ids[0]
            if self.cfg.directory.gt_pose_dir is not None:
                pose0 = SE3(self.dataset.gt_poses[min(self.dataset.gt_poses)])
            else:
                pose0 = SE3()
            self.global_poses = {first: pose0.copy()}
            self.cur_data["id"] = first
            img0 = load(first)
            with self.timers.scope("depth_cnn", "DF-VO"):
                carry = runner.initial_carry(self.infer_variables, self._upload(img0))

            rest = frame_ids[1:]
            h, w = self.cfg.image.height, self.cfg.image.width
            for c0 in range(0, len(rest), chunk):
                self.timers.start("DF-VO")
                ids = rest[c0 : c0 + chunk]
                with self.timers.scope("data_loading", "DF-VO"):
                    imgs = np.empty((chunk, h, w, 3), np.uint8)
                    for j, i in enumerate(ids):
                        imgs[j] = load(i)
                    imgs[len(ids):] = imgs[len(ids) - 1]  # a fixed chunk shape
                    # keys fold the true frame ids, so both executions draw
                    # the same RANSAC samples
                    id_pad = ids + [ids[-1]] * (chunk - len(ids))
                    keys = prng.step_keys(self.cfg.seed, id_pad).astype(np.int64)
                    imgs_dev, keys_dev = self._upload(imgs), self._upload(keys)
                prev_img = carry[0]  # the previous chunk's last frame, on the device
                with self.timers.scope("vo_step", "DF-VO"):
                    poses, _, carry = runner._chunk_step(
                        self.infer_variables, imgs_dev, carry, keys_dev, self.K, self.K_inv)
                    rel = poses.to("cpu", torch.float64).numpy()[: len(ids)]
                if self._finetunes():
                    with self.timers.scope("finetune", "DF-VO"):
                        n_active = len(ids)
                        if self.finetuner.num_frames is not None:
                            n_active = min(n_active,
                                           self.finetuner.num_frames - self.finetune_cnt)
                        self.variables, self.opt_state, _ = chunk_update(
                            self.variables, self.opt_state,
                            torch.cat([prev_img[None], imgs_dev], dim=0), poses, n_active)
                        self.infer_variables = self.frontend.prepare_variables(self.variables)
                    self.finetune_cnt += n_active
                prev = self.global_poses[frame_ids[c0]].pose
                for j, i in enumerate(ids):
                    prev = prev @ rel[j]
                    self.global_poses[i] = SE3(prev)
                if self.drawer is not None:
                    with self.timers.scope("visualization", "DF-VO"):
                        for i in ids:
                            self.cur_data["id"] = i
                            self.drawer.draw_traj(self)
                self.timers.end("DF-VO")
                done = c0 + len(ids) + 1
                if done // PROGRESS_EVERY > (c0 + 1) // PROGRESS_EVERY or done == len(frame_ids):
                    print(f"==> frame {done}/{len(frame_ids)}, {done - 1} tracked")
        finally:
            if prefetcher is not None:
                prefetcher.close()
        self.tracking_stage = len(frame_ids)
        print("=> Finish!")
        return self.save_results()

    def save_state(self, path):
        """Checkpoint the mid-sequence VO state in the directory ``path``
        (``utils/checkpoint.py`` ``save_variables``): the network variables
        (finetuned ones included) and, as ``train_state``, the trajectory
        so far (``global_poses`` [n x 4 x 4] float32 and ``pose_ids``), the
        frame cursor (``tracking_stage``), ``prev_scale``, and the
        reference frame (``ref_id``, ``ref_motion``, ``ref_raw_depth``,
        ``ref_img`` uint8): the fields of the JAX package's ``save_state``.
        As there, the Adam moments are not saved, and a scan run leaves no
        reference frame to save (KeyError). Returns the absolute path."""
        from ..utils.checkpoint import save_variables

        ids = sorted(self.global_poses)
        ref = self.ref_data
        state = {
            "global_poses": torch.as_tensor(
                np.stack([self.global_poses[k].pose for k in ids]), dtype=torch.float32),
            "pose_ids": torch.as_tensor(ids, dtype=torch.int64),
            "tracking_stage": torch.tensor(self.tracking_stage, dtype=torch.int64),
            "prev_scale": torch.as_tensor(self.prev_scale, dtype=torch.float32).reshape(()),
            "ref_id": torch.tensor(ref.get("id", 0), dtype=torch.int64),
            "ref_motion": ref["motion"].to(torch.float32),
            "ref_raw_depth": ref["raw_depth_dev"].to(torch.float32),
            "ref_img": ref["img_dev"].to(torch.uint8),
        }
        return save_variables(path, self.variables, train_state=state)

    def load_state(self, path):
        """Resume from :meth:`save_state`: the variables, the trajectory,
        the scale and the reference frame, on this instance's device.
        Continue with ``main(start_frame=ref_id + 1)`` (frame execution).
        Returns ``ref_id``."""
        from ..utils.checkpoint import restore_variables

        payload = restore_variables(path)
        variables = payload["variables"]
        if self.finetuner is not None:  # the float32 masters live on the device
            variables = {net: {k: v.to(self.device) for k, v in sd.items()}
                         for net, sd in variables.items()}
        self.variables = variables
        self.infer_variables = self.frontend.prepare_variables(self.variables)
        vo = payload["train_state"]
        self.global_poses = {int(i): SE3(p.numpy().astype(np.float64))
                             for i, p in zip(vo["pose_ids"], vo["global_poses"])}
        self.tracking_stage = int(vo["tracking_stage"])
        self.prev_scale = self._upload(vo["prev_scale"], torch.float32)
        ref_id = int(vo["ref_id"])
        self.ref_data = {
            "id": ref_id,
            "img": vo["ref_img"].numpy(),
            "img_dev": self._upload(vo["ref_img"]),
            "raw_depth_dev": self._upload(vo["ref_raw_depth"], torch.float32),
            "motion": self._upload(vo["ref_motion"], torch.float32),
        }
        return ref_id

    def save_results(self):
        """Write ``<seq>.txt`` (and ``map.png`` with the drawer, and the
        finetuned variables in ``finetuned_model/`` with
        ``online_finetune.save_model``) to the result directory, print the
        timers; returns {scope: mean s}."""
        result_dir = self.cfg.directory.result_dir
        mkdir_if_not_exists(result_dir)
        print(f"The result is saved in [{result_dir}].")
        if self.drawer is not None:
            self.drawer.save_traj_map(os.path.join(result_dir, "map.png"))
        self.dataset.save_result_traj(os.path.join(result_dir, f"{self.cfg.seq}.txt"),
                                      self.global_poses)
        if self.finetuner is not None and self.cfg.online_finetune.save_model:
            from ..utils.checkpoint import save_variables

            ckpt_dir = os.path.join(result_dir, "finetuned_model")
            save_variables(ckpt_dir, self.variables, self.opt_state)
            print(f"Finetuned model is saved in [{ckpt_dir}].")
        return self.timers.time_analysis()
