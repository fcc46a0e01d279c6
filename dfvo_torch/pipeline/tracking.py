"""The tracking step: keypoints -> E-tracker -> scale -> PnP fallback.

Counterpart of ``dfvo_tpu/pipeline/tracking.py``: the reference's per-frame
``DFVO.tracking()`` decision tree on the device of its inputs.

* no good keypoints            -> constant-motion model
* E valid and scale recovered  -> E pose with metric translation
* |t| = 0 or scale = -1        -> PnP pose

The JAX package pays for the PnP fallback only on frames that need it
(``lax.cond``). Here the step reads that decision on the host once per
call: ``need_pnp`` is the step's one host synchronisation (none with
``force_e_path`` or ``defer_pnp``).

Every function takes leading frame axes where the JAX package ``vmap``s
over a chunk's frames: :func:`tracking_step_chunk` is the scan runner's
``jax.vmap`` of the deferred step, one kernel per op for the whole chunk,
and :func:`pnp_fallback` runs over the frames that the chunk sends it.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: iterative scale, iterative keypoints and depth consistency (item 9)
and the ``bestN`` and ``sampled`` keypoint selectors (item 7).
"""

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..geometry.lie import make_se3, se3_inverse
from ..geometry.ops import rigid_flow
from ..matching.kp_selection import KPSelectionSpec, local_bestN
from ..tracker.e_tracker import compute_pose_2d2d, find_scale_from_depth
from ..tracker.pnp_tracker import compute_pose_3d2d
from ..utils import prng

TRACK_MODE_CONST = 0
TRACK_MODE_ESSENTIAL = 1
TRACK_MODE_PNP = 2

_ITEM7 = "ROADMAP queue 1 item 7, 'The rest of matching'"
_ITEM9 = "ROADMAP queue 1 item 9, 'Deep pose and the optional keypoint filters'"


@dataclass(frozen=True)
class TrackingConfig:
    """Static tracking configuration distilled from the YAML option surface
    (options/examples/default_configuration.yml); the fields and defaults
    of the JAX package's TrackingConfig."""

    tracking_method: str = "hybrid"  # hybrid | PnP | deep_pose
    # image / kp selection
    height: int = 192
    width: int = 640
    kp_method: str = "local_bestN"  # local_bestN | bestN | sampled
    num_kp: int = 2000
    kp_rows: int = 10
    kp_cols: int = 10
    flow_diff_thre: float = 0.1
    kp_score_method: str = "flow"
    flow_crop: tuple = ((0.0, 1.0), (0.0, 1.0))
    # depth consistency kp filter (needs the pose CNN)
    depth_consistency: bool = False
    depth_consistency_thre: float = 0.05
    # depth preprocessing
    depth_crop: tuple = ((0.3, 1.0), (0.0, 1.0))
    min_depth: float = 0.0
    max_depth: float = 50.0
    # e-tracker
    e_reproj_thre: float = 0.2
    e_repeat: int = 5
    e_iterative_kp: bool = False
    e_iter_score_method: str = "opt_flow"
    validity_method: str = "GRIC"
    validity_thre: float = 0.0
    # rigid-flow kp selection
    rigid_rows: int = 10
    rigid_cols: int = 10
    rigid_num_kp: int = 2000
    rigid_flow_thre: float = 5.0
    optical_flow_thre: float = 0.1
    # scale recovery
    scale_method: str = "simple"  # simple | iterative
    scale_ransac_thre: float = 0.1
    scale_max_trials: int = 100
    scale_min_samples: int = 3
    scale_iterative_kp: bool = False
    scale_iter_score_method: str = "rigid_flow"
    # scale spike guard (tpu.scale_jump_guard; 0 = off): a scale that jumps
    # more than this factor from the previous frame's fails, and the PnP
    # fallback takes the frame
    scale_jump_guard: float = 5.0
    # pnp
    pnp_reproj_thre: float = 1.0
    pnp_repeat: int = 5
    pnp_iter: int = 100  # hypotheses per repeat
    pnp_iterative_kp: bool = False
    pnp_iter_score_method: str = "rigid_flow"
    # ransac batching
    num_hypotheses: int = 256
    # no PnP branch: an E failure falls back to constant motion
    force_e_path: bool = False
    # batch mode of the scan runner: no PnP in the step; it returns the
    # placeholder pose prev_motion and need_pnp, and the chunk runs one
    # batched fallback for the frames that need it
    defer_pnp: bool = False
    # compute the pose-induced rigid-flow-diff map (drawer tile)
    want_rigid_flow_diff: bool = True

    @classmethod
    def from_cfg(cls, cfg):
        dcrop = cfg.crop.depth_crop
        fcrop = cfg.crop.flow_crop
        kp_cfg = cfg.kp_selection
        if kp_cfg.local_bestN.enable:
            kp_method = "local_bestN"
            num_kp = kp_cfg.local_bestN.num_bestN
        elif kp_cfg.bestN.enable:
            kp_method = "bestN"
            num_kp = kp_cfg.bestN.num_bestN
        elif kp_cfg.sampled_kp.enable:
            kp_method = "sampled"
            num_kp = kp_cfg.sampled_kp.num_kp
        else:
            raise ValueError("no keypoint selection method enabled")
        cls._check_kp_src(cfg, kp_method)
        method = str(cfg.tracking_method)
        if method not in ("hybrid", "PnP", "deep_pose"):
            raise ValueError(
                "tracking_method must be one of [hybrid, PnP, deep_pose], "
                f"got {method!r}"
            )
        if method == "PnP" and bool(cfg.tpu.get("force_e_path", False)):
            raise ValueError("tpu.force_e_path contradicts tracking_method: PnP")
        return cls(
            tracking_method=method,
            height=cfg.image.height,
            width=cfg.image.width,
            kp_method=kp_method,
            num_kp=num_kp,
            kp_rows=kp_cfg.local_bestN.num_row,
            kp_cols=kp_cfg.local_bestN.num_col,
            flow_diff_thre=kp_cfg.local_bestN.thre,
            kp_score_method=kp_cfg.local_bestN.score_method,
            flow_crop=((fcrop[0][0], fcrop[0][1]), (fcrop[1][0], fcrop[1][1])),
            depth_consistency=bool(kp_cfg.depth_consistency.enable),
            depth_consistency_thre=kp_cfg.depth_consistency.thre,
            depth_crop=((dcrop[0][0], dcrop[0][1]), (dcrop[1][0], dcrop[1][1])),
            min_depth=cfg.depth.min_depth,
            max_depth=cfg.depth.max_depth,
            e_reproj_thre=cfg.e_tracker.ransac.reproj_thre,
            e_repeat=cfg.e_tracker.ransac.repeat,
            e_iterative_kp=bool(cfg.e_tracker.iterative_kp.enable),
            e_iter_score_method=cfg.e_tracker.iterative_kp.score_method,
            validity_method=cfg.e_tracker.validity.method,
            validity_thre=float(cfg.e_tracker.validity.thre or 0.0),
            rigid_rows=kp_cfg.rigid_flow_kp.num_row,
            rigid_cols=kp_cfg.rigid_flow_kp.num_col,
            rigid_num_kp=kp_cfg.rigid_flow_kp.num_bestN,
            rigid_flow_thre=kp_cfg.rigid_flow_kp.rigid_flow_thre,
            optical_flow_thre=kp_cfg.rigid_flow_kp.optical_flow_thre,
            scale_method=cfg.scale_recovery.method,
            scale_ransac_thre=cfg.scale_recovery.ransac.thre,
            # batched trials are cheap: oversample the reference's
            # max_trials so a true-scale consensus that is a ~20 % minority
            # mode still wins
            scale_max_trials=max(
                int(cfg.scale_recovery.ransac.max_trials),
                int(cfg.tpu.get("scale_ransac_hypotheses", 1024) or 0),
            ),
            scale_min_samples=cfg.scale_recovery.ransac.min_samples,
            scale_iterative_kp=bool(cfg.scale_recovery.iterative_kp.enable),
            scale_iter_score_method=cfg.scale_recovery.iterative_kp.score_method,
            scale_jump_guard=float(cfg.tpu.get("scale_jump_guard", 5.0) or 0.0),
            pnp_reproj_thre=cfg.pnp_tracker.ransac.reproj_thre,
            pnp_repeat=cfg.pnp_tracker.ransac.repeat,
            pnp_iter=cfg.pnp_tracker.ransac.iter,
            pnp_iterative_kp=bool(cfg.pnp_tracker.iterative_kp.enable),
            pnp_iter_score_method=cfg.pnp_tracker.iterative_kp.score_method,
            num_hypotheses=cfg.tpu.ransac_hypotheses,
            force_e_path=bool(cfg.tpu.get("force_e_path", False)),
            want_rigid_flow_diff=bool(
                cfg.visualization.enable and cfg.visualization.flow.vis_rigid_diff
            ),
        )

    @staticmethod
    def _check_kp_src(cfg, kp_method):
        """Validate each stage's ``kp_src`` against the statically folded
        keypoint routing: the enabled selector's set ('kp_best', or
        'kp_list' for sampled_kp) feeds every stage, and iterative
        refinements use the rigid-flow set ('kp_depth'). A per-stage mix
        raises instead of being ignored."""
        primary = "kp_list" if kp_method == "sampled" else "kp_best"
        for stage in ("e_tracker", "scale_recovery", "pnp_tracker"):
            stage_cfg = cfg.get(stage) or {}
            src = stage_cfg.get("kp_src") or primary
            if src != primary:
                raise ValueError(
                    f"{stage}.kp_src: {src!r} is not supported with the "
                    f"{kp_method!r} keypoint selector (which provides "
                    f"{primary!r}); per-stage kp_src mixing is folded "
                    "statically in this build"
                )
            it_cfg = stage_cfg.get("iterative_kp") or {}
            it_src = it_cfg.get("kp_src") or "kp_depth"
            if it_cfg.get("enable") and it_src != "kp_depth":
                raise ValueError(
                    f"{stage}.iterative_kp.kp_src: {it_src!r} is not "
                    "supported; iterative refinement uses the rigid-flow "
                    "keypoints ('kp_depth')"
                )


def _check_ported(tcfg):
    """Raise for the options of the JAX tracking step not ported yet."""
    unported = (
        (tcfg.scale_method == "iterative", "scale_recovery.method: iterative", _ITEM9),
        (tcfg.e_iterative_kp, "e_tracker.iterative_kp", _ITEM9),
        (tcfg.pnp_iterative_kp, "pnp_tracker.iterative_kp", _ITEM9),
        (tcfg.depth_consistency, "kp_selection.depth_consistency", _ITEM9),
        (tcfg.kp_method in ("bestN", "sampled"), f"kp_selection.{tcfg.kp_method}", _ITEM7),
    )
    for on, what, item in unported:
        if on:
            raise NotImplementedError(f"{what} is not ported yet ({item})")
    if tcfg.scale_method != "simple":
        raise ValueError(f"unknown scale method: {tcfg.scale_method}")


def preprocess_depth_device(depth, crop, depth_range):
    """Crop and range clipping of depth maps [... x H x W] (zeros
    outside)."""
    min_depth, max_depth = depth_range
    h, w = depth.shape[-2:]
    y0, y1 = int(h * crop[0][0]), int(h * crop[0][1])
    x0, x1 = int(w * crop[1][0]), int(w * crop[1][1])
    ys = torch.arange(h, device=depth.device)[:, None]
    xs = torch.arange(w, device=depth.device)[None, :]
    region = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    keep = region & (depth < max_depth) & (depth > min_depth)
    return torch.where(keep, depth, torch.zeros_like(depth))


@functools.lru_cache(maxsize=None)
def _kp_spec(h, w, rows, cols, num_kp):
    """One KPSelectionSpec per geometry, so its cell table reaches each
    device once."""
    return KPSelectionSpec(h, w, rows, cols, num_kp)


def _select_keypoints(tcfg, flow_fwd, flow_diff):
    """The configured keypoint selector (local_bestN)."""
    if tcfg.kp_method != "local_bestN":
        raise NotImplementedError(
            f"kp_selection.{tcfg.kp_method} is not ported yet ({_ITEM7})")
    spec = _kp_spec(tcfg.height, tcfg.width, tcfg.kp_rows, tcfg.kp_cols, tcfg.num_kp)
    return local_bestN(spec, flow_fwd, flow_diff, tcfg.flow_diff_thre,
                       score_method=tcfg.kp_score_method)


def _scalar(x, like):
    """``x`` as a 0-d float32 tensor on ``like``'s device, without a
    host-to-device copy for a Python number."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _split_keys(rng):
    """The eight stage keys of a step: ``split(rng, 8)`` of a host key, or
    the frames' split keys [... x 8 x 2] as given (a device tensor,
    ``prng.chunk_keys``)."""
    return rng if isinstance(rng, torch.Tensor) else prng.split(rng, 8)


def pnp_fallback(rng, kp_ref, kp_cur, valid, depth_ref, flow_fwd, flow_diff,
                 depth_ref_raw, K, K_inv, tcfg):
    """The PnP fallback branch; its key is key 5 of ``split(rng, 8)``, as
    in ``tracking_step``. Over leading frame axes, ``rng`` holds each
    frame's split keys [... x 8 x 2]."""
    if tcfg.pnp_iterative_kp:
        raise NotImplementedError(f"pnp_tracker.iterative_kp is not ported yet ({_ITEM9})")
    keys = _split_keys(rng)
    return compute_pose_3d2d(
        keys[..., 5, :], kp_ref, kp_cur, valid, depth_ref, K, K_inv,
        min_depth=tcfg.min_depth, max_depth=tcfg.max_depth,
        reproj_thre=tcfg.pnp_reproj_thre, repeats=tcfg.pnp_repeat,
        num_hypotheses=tcfg.pnp_iter,
    )


@torch.no_grad()
def tracking_step(rng, flow_fwd, flow_diff, depth_cur_raw, depth_ref_raw, prev_motion,
                  K, K_inv, tcfg, prev_scale=1.0, deep_pose=None):
    """One evaluation of the tracking decision tree.

    Args:
        rng: PRNG key (two uint32 words, utils/prng.py), or each frame's
            split keys [... x 8 x 2] as an int64 device tensor.
        flow_fwd: [... x H x W x 2] flow ref -> cur, with optional leading
            frame axes.
        flow_diff: [... x H x W] forward-backward flow inconsistency.
        depth_cur_raw, depth_ref_raw: [... x H x W] raw CNN depths.
        prev_motion: [... x 4 x 4] previous relative pose (constant-motion
            model).
        K, K_inv: [3 x 3] intrinsics, float32, on the inputs' device.
        tcfg: TrackingConfig.
        prev_scale: previous frame's scale (number or 0-d tensor).
        deep_pose: the pose CNN's prediction (not ported: must be None).

    Returns:
        dict with ``pose`` [... x 4 x 4] relative pose (cur -> ref),
        ``mode`` (0 const / 1 essential / 2 pnp), ``good_kp_found``,
        ``scale``, keypoints, inliers, the maps the drawer reads, and
        ``need_pnp`` and ``depth_ref`` for a deferred fallback.
    """
    _check_ported(tcfg)
    if deep_pose is not None:
        raise NotImplementedError(f"the deep pose input is not ported yet ({_ITEM9})")
    depth_range = (tcfg.min_depth, tcfg.max_depth)
    depth_cur = preprocess_depth_device(depth_cur_raw, tcfg.depth_crop, depth_range)
    depth_ref = preprocess_depth_device(depth_ref_raw, tcfg.depth_crop, depth_range)

    kp = _select_keypoints(tcfg, flow_fwd, flow_diff)
    kp_ref, kp_cur, valid = kp["kp1"], kp["kp2"], kp["valid"]
    keys = _split_keys(rng)
    eye4 = torch.eye(4, dtype=torch.float32, device=flow_fwd.device)

    if tcfg.tracking_method == "PnP":
        # PnP every frame: E_pose stays identity, so every good-kp frame
        # takes the PnP branch
        lead = valid.shape[:-1]
        e_out = {"inliers": torch.zeros_like(valid)}
        scale = torch.full(lead, -1.0, device=flow_fwd.device)
        e_success = torch.zeros(lead, dtype=torch.bool, device=flow_fwd.device)
        return _finish_tracking_step(
            rng, tcfg, kp, e_out, e_success, eye4, scale, prev_motion, depth_ref,
            depth_cur, depth_ref_raw, flow_fwd, flow_diff, K, K_inv)

    e_out = compute_pose_2d2d(
        keys[..., 0, :], kp_cur, kp_ref, valid, K, K_inv,
        reproj_thre=tcfg.e_reproj_thre, repeats=tcfg.e_repeat,
        num_hypotheses=tcfg.num_hypotheses, validity_method=tcfg.validity_method,
        validity_thre=tcfg.validity_thre,
    )
    T_e = make_se3(e_out["R"], e_out["t"])  # cur -> ref, unit translation
    scale = find_scale_from_depth(
        keys[..., 1, :], kp_ref, kp_cur, valid, se3_inverse(T_e), depth_cur, K_inv,
        ransac_thre=tcfg.scale_ransac_thre, max_trials=tcfg.scale_max_trials,
        min_samples=tcfg.scale_min_samples,
    )["scale"]
    minus_one = torch.full_like(scale, -1.0)
    scale = torch.where(e_out["valid"], scale, minus_one)

    if tcfg.scale_jump_guard > 0:
        # a physically impossible jump means the depth-ratio consensus was
        # captured by outliers: fail the scale so PnP takes the frame
        ps = _scalar(prev_scale, scale)
        g = tcfg.scale_jump_guard
        spike = (ps > 0) & (scale > 0) & ((scale > ps * g) | (scale * g < ps))
        scale = torch.where(spike, minus_one, scale)

    e_success = e_out["valid"] & (scale != -1.0)
    pose_e = T_e.clone()
    pose_e[..., :3, 3] = pose_e[..., :3, 3] * scale[..., None]
    return _finish_tracking_step(
        rng, tcfg, kp, e_out, e_success, pose_e, scale, prev_motion, depth_ref,
        depth_cur, depth_ref_raw, flow_fwd, flow_diff, K, K_inv)


def _finish_tracking_step(rng, tcfg, kp, e_out, e_success, pose_e, scale, prev_motion,
                          depth_ref, depth_cur, depth_ref_raw, flow_fwd, flow_diff,
                          K, K_inv):
    """Decision-tree tail of the hybrid and PnP-only trackers: the PnP
    dispatch, constant-motion substitution, and the output dict."""
    kp_ref, kp_cur, valid = kp["kp1"], kp["kp2"], kp["valid"]
    good = kp["good_kp_found"]
    need_pnp = good & ~e_success
    placeholder = tcfg.force_e_path or tcfg.defer_pnp
    skip = {"T": prev_motion if placeholder else torch.eye(4, dtype=pose_e.dtype,
                                                           device=pose_e.device),
            "inliers": torch.zeros_like(valid)}
    if tcfg.force_e_path:
        need_pnp = torch.zeros_like(need_pnp)
        pnp_out = skip
    elif tcfg.defer_pnp:  # the chunk runs the fallback (scan_runner.py)
        pnp_out = skip
    elif bool(need_pnp.any()):  # the step's one host synchronisation
        pnp_out = pnp_fallback(rng, kp_ref, kp_cur, valid, depth_ref, flow_fwd, flow_diff,
                               depth_ref_raw, K, K_inv, tcfg)
    else:
        pnp_out = skip

    pose = torch.where(e_success[..., None, None], pose_e, pnp_out["T"])
    pose = torch.where(good[..., None, None], pose, prev_motion)
    fallback_mode = TRACK_MODE_CONST if tcfg.force_e_path else TRACK_MODE_PNP
    mode = torch.where(
        good,
        torch.where(e_success, TRACK_MODE_ESSENTIAL, fallback_mode),
        TRACK_MODE_CONST,
    )
    if tcfg.want_rigid_flow_diff:
        h, w = depth_ref_raw.shape[-2:]
        rflow = rigid_flow(depth_ref_raw.reshape(-1, h, w),
                           se3_inverse(pose).reshape(-1, 4, 4), K, K_inv)
        rigid_flow_diff = torch.linalg.vector_norm(rflow.reshape(flow_fwd.shape) - flow_fwd,
                                                   dim=-1)
    else:
        rigid_flow_diff = torch.zeros_like(flow_diff)
    return {
        "pose": pose,
        "mode": mode,
        "good_kp_found": good,
        "scale": scale,
        "kp_ref": kp_ref,
        "kp_cur": kp_cur,
        "kp_valid": valid,
        "inliers": torch.where(e_success[..., None], e_out["inliers"], pnp_out["inliers"]),
        "fb_flow_mask": kp.get("fb_flow_mask", flow_diff),
        "rigid_flow_diff": rigid_flow_diff,
        "depth_cur": depth_cur,
        "need_pnp": need_pnp,
        "depth_ref": depth_ref,
    }


def tracking_step_chunk(keys, flow_fwd, flow_diff, depth_cur_raw, depth_ref_raw, K, K_inv,
                        tcfg):
    """The scan runner's batched step: ``jax.vmap`` of the step over a
    chunk's frames in the JAX package (``scan_runner.py``), here one call
    over a leading frame axis.

    Each frame gets a dummy previous motion (the identity) and previous
    scale (1.0) and no scale-jump guard: the chunk's fix-up passes put in
    the constant-motion poses and apply the guard with the true running
    scale. The PnP fallback is deferred (placeholder pose and
    ``need_pnp``) unless ``force_e_path`` drops it, so the call reads
    nothing on the host. The drawer's rigid-flow map is not computed.

    Args:
        keys: [T x 8 x 2] int64 split keys on the device
            (``prng.chunk_keys``).
        flow_fwd: [T x H x W x 2]; flow_diff, depth_cur_raw,
            depth_ref_raw: [T x H x W].
        K, K_inv: [3 x 3] intrinsics.
        tcfg: the TrackingConfig of the frame execution.
    """
    tcfg_v = dataclasses.replace(tcfg, defer_pnp=not tcfg.force_e_path,
                                 scale_jump_guard=0.0, want_rigid_flow_diff=False)
    eye = torch.eye(4, dtype=torch.float32, device=flow_fwd.device)
    return tracking_step(keys, flow_fwd, flow_diff, depth_cur_raw, depth_ref_raw, eye, K,
                         K_inv, tcfg_v, prev_scale=1.0)
