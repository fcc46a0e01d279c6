"""The tracking step: keypoints -> E-tracker -> scale -> PnP fallback.

Counterpart of ``dfvo_tpu/pipeline/tracking.py``: the reference's per-frame
``DFVO.tracking()`` decision tree on the device of its inputs, with every
option of the JAX step: the three keypoint selectors (``local_bestN``,
``bestN``, ``sampled``), depth consistency (given the pose CNN's pose),
simple or iterative scale recovery, and the rigid-flow iterative
keypoints of the E and PnP trackers.

* no good keypoints            -> constant-motion model
* E valid and scale recovered  -> E pose with metric translation
* |t| = 0 or scale = -1        -> PnP pose

The JAX package pays for the PnP fallback only on frames that need it
(``lax.cond``). Here the step reads that decision on the host once per
call: ``need_pnp`` is the step's one host synchronisation (none with
``force_e_path`` or ``defer_pnp``). The iterative scale recovery's five
iterations run in full, each frozen by a ``done`` mask on the device, so
it adds no read.

Every function takes leading frame axes where the JAX package ``vmap``s
over a chunk's frames: :func:`tracking_step_chunk` is the scan runner's
``jax.vmap`` of the deferred step, one kernel per op for the whole chunk,
and :func:`pnp_fallback` runs over the frames that the chunk sends it.
With iterative scale recovery the chunk's scale stage runs frame by frame
with the running scale carried on the device (the JAX package scans its
whole step for it).

A step's keys are ``split(rng, 8)`` followed by the iterative scale's
``fold_in(split[2], i)``, i < 5 (``utils/prng.py`` ``with_iter_keys``):
derived on the host from a host key, or given per frame as a device
tensor [... x 13 x 2] (``prng.step_keys``).
"""

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..geometry.lie import make_se3, se3_inverse
from ..geometry.ops import backproject_depth, reproject, rigid_flow, transform_points
from ..matching.kp_selection import (
    KPSelectionSpec,
    bestN_flow_kp,
    local_bestN,
    opt_rigid_flow_kp,
    sampled_kp,
    sampled_kp_indices,
)
from ..ops.warp import grid_sample
from ..tracker.e_tracker import compute_pose_2d2d, find_scale_from_depth
from ..tracker.pnp_tracker import compute_pose_3d2d
from ..utils import prng
from ..utils.device import upload

TRACK_MODE_CONST = 0
TRACK_MODE_ESSENTIAL = 1
TRACK_MODE_PNP = 2


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


@functools.lru_cache(maxsize=None)
def _sampled_kp1(h, w, crop, num_kp, device):
    """The uniform keypoint list of a geometry on ``device`` (uploaded
    once)."""
    return upload(sampled_kp_indices(h, w, crop, num_kp), device)


def compute_depth_consistency(depth_cur_raw, depth_ref_raw, T_deep, K, K_inv):
    """Depth-consistency map [... x H x W] from the CNN depths and the pose
    CNN's pose: the current depth reprojected with the deep pose, the
    reference depth sampled there (border padding), and
    |warped - reprojected| / reprojected clipped to [0, 1]."""
    h, w = depth_cur_raw.shape[-2:]
    depth = depth_cur_raw.reshape(-1, h, w)
    T = T_deep.reshape(-1, 4, 4)
    coords = reproject(depth, T, K, K_inv)
    warp_depth = grid_sample(depth_ref_raw.reshape(-1, h, w, 1), coords,
                             padding_mode="border")[..., 0]
    reproj_depth = transform_points(backproject_depth(depth, K_inv), T)[..., 2]
    diff = torch.abs(warp_depth - reproj_depth)
    out = torch.clamp(diff / torch.clamp(reproj_depth, min=1e-12), 0.0, 1.0)
    return out.reshape(depth_cur_raw.shape)


def _rigid_flow_kp(flow_fwd, flow_diff, depth_ref_raw, T_ref2cur, K, K_inv, tcfg,
                   score_method, variants):
    """Rigid-optical flow consistent keypoints: the pose-induced flow
    rendered from the reference raw depth, compared with the optical flow,
    selected per cell of the rigid-flow grid."""
    h, w = depth_ref_raw.shape[-2:]
    rflow = rigid_flow(depth_ref_raw.reshape(-1, h, w), T_ref2cur.reshape(-1, 4, 4), K, K_inv)
    rdiff = torch.linalg.vector_norm(rflow.reshape(flow_fwd.shape) - flow_fwd, dim=-1)
    spec = _kp_spec(h, w, tcfg.rigid_rows, tcfg.rigid_cols, tcfg.rigid_num_kp)
    return opt_rigid_flow_kp(spec, flow_fwd, flow_diff, rdiff, rigid_thre=tcfg.rigid_flow_thre,
                             opt_thre=tcfg.optical_flow_thre, score_method=score_method,
                             variants=variants)


def _select_keypoints(tcfg, flow_fwd, flow_diff, depth_diff=None):
    """The configured keypoint selector."""
    if tcfg.kp_method == "local_bestN":
        spec = _kp_spec(tcfg.height, tcfg.width, tcfg.kp_rows, tcfg.kp_cols, tcfg.num_kp)
        return local_bestN(spec, flow_fwd, flow_diff, tcfg.flow_diff_thre,
                           score_method=tcfg.kp_score_method, depth_diff=depth_diff,
                           depth_diff_thre=tcfg.depth_consistency_thre)
    if tcfg.kp_method == "bestN":
        return bestN_flow_kp(flow_fwd, flow_diff, tcfg.num_kp)
    if tcfg.kp_method == "sampled":
        kp1 = _sampled_kp1(tcfg.height, tcfg.width, tcfg.flow_crop, tcfg.num_kp,
                           flow_fwd.device)
        return sampled_kp(kp1, flow_fwd)
    raise ValueError(f"unknown kp method: {tcfg.kp_method}")


def _scalar(x, like):
    """``x`` as a 0-d float32 tensor on ``like``'s device, without a
    host-to-device copy for a Python number."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _split_keys(rng):
    """A step's keys: ``prng.with_iter_keys(split(rng, 8))`` of a host key
    (numpy [13 x 2]), or the frames' keys [... x 13 x 2] as given (a
    device tensor, ``prng.step_keys``)."""
    if isinstance(rng, torch.Tensor):
        return rng
    return prng.with_iter_keys(prng.split(rng, 8))


def _scaled(T, scale):
    """T with its translation multiplied by ``scale`` [...]."""
    return make_se3(T[..., :3, :3], T[..., :3, 3] * scale[..., None])


def _where(cond, a, b):
    """``torch.where`` with ``cond`` [...] broadcast over the trailing axes
    of ``a`` and ``b``."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def pnp_fallback(rng, kp_ref, kp_cur, valid, depth_ref, flow_fwd, flow_diff,
                 depth_ref_raw, K, K_inv, tcfg):
    """The PnP fallback branch; its keys are keys 5 (and 6 for the
    iterative-keypoint pass) of the step's, as in ``tracking_step``. Over
    leading frame axes, ``rng`` holds each frame's keys [... x 13 x 2]
    (``prng.step_keys``).

    With ``pnp_tracker.iterative_kp`` the first pass runs 3 repeats, then a
    second pass on the rigid-flow best keypoints of its pose replaces it
    where it succeeds.
    """
    keys = _split_keys(rng)
    kw = dict(min_depth=tcfg.min_depth, max_depth=tcfg.max_depth,
              reproj_thre=tcfg.pnp_reproj_thre, num_hypotheses=tcfg.pnp_iter)
    out = compute_pose_3d2d(keys[..., 5, :], kp_ref, kp_cur, valid, depth_ref, K, K_inv,
                            repeats=3 if tcfg.pnp_iterative_kp else tcfg.pnp_repeat, **kw)
    if not tcfg.pnp_iterative_kp:
        return out
    rkp = _rigid_flow_kp(flow_fwd, flow_diff, depth_ref_raw, se3_inverse(out["T"]), K, K_inv,
                         tcfg, tcfg.pnp_iter_score_method, ("best",))
    out2 = compute_pose_3d2d(keys[..., 6, :], rkp["kp1_best"], rkp["kp2_best"],
                             rkp["valid_best"], depth_ref, K, K_inv, repeats=tcfg.pnp_repeat,
                             **kw)
    use2 = out2["ok"]
    return {"T": _where(use2, out2["T"], out["T"]), "ok": out["ok"] | use2,
            "inliers": _where(use2, out2["inliers"], out["inliers"]),
            "mask": _where(use2, out2["mask"], out["mask"])}


@torch.no_grad()
def tracking_step(rng, flow_fwd, flow_diff, depth_cur_raw, depth_ref_raw, prev_motion,
                  K, K_inv, tcfg, prev_scale=1.0, deep_pose=None, carry_scale=False):
    """One evaluation of the tracking decision tree.

    Args:
        rng: PRNG key (two uint32 words, utils/prng.py), or each frame's
            keys [... x 13 x 2] (``prng.step_keys``) as an int64 device
            tensor.
        flow_fwd: [... x H x W x 2] flow ref -> cur, with optional leading
            frame axes.
        flow_diff: [... x H x W] forward-backward flow inconsistency.
        depth_cur_raw, depth_ref_raw: [... x H x W] raw CNN depths.
        prev_motion: [... x 4 x 4] previous relative pose (constant-motion
            model).
        K, K_inv: [3 x 3] intrinsics, float32, on the inputs' device.
        tcfg: TrackingConfig.
        prev_scale: previous frame's scale (number or 0-d tensor): the
            iterative scale recovery's seed and the jump guard's reference.
        deep_pose: the pose CNN's [... x 4 x 4] pose (cur -> ref), for the
            depth-consistency filter; None without the pose CNN.
        carry_scale: frames on axis 0 follow one another: the scale stage
            runs frame by frame, each seeded with the running scale
            (``prev_scale`` before the first frame, then each frame's
            positive scale), kept on the device (``tracking_step_chunk``).

    Returns:
        dict with ``pose`` [... x 4 x 4] relative pose (cur -> ref),
        ``mode`` (0 const / 1 essential / 2 pnp), ``good_kp_found``,
        ``scale``, ``spike`` (the jump guard failed the scale), keypoints,
        inliers, the maps the drawer reads, and ``need_pnp`` and
        ``depth_ref`` for a deferred fallback.
    """
    if tcfg.scale_method not in ("simple", "iterative"):
        raise ValueError(f"unknown scale method: {tcfg.scale_method}")
    depth_range = (tcfg.min_depth, tcfg.max_depth)
    depth_cur = preprocess_depth_device(depth_cur_raw, tcfg.depth_crop, depth_range)
    depth_ref = preprocess_depth_device(depth_ref_raw, tcfg.depth_crop, depth_range)

    depth_diff = None
    if tcfg.depth_consistency and deep_pose is not None:
        depth_diff = compute_depth_consistency(depth_cur_raw, depth_ref_raw, deep_pose, K, K_inv)
    kp = _select_keypoints(tcfg, flow_fwd, flow_diff, depth_diff)
    kp_ref, kp_cur, valid = kp["kp1"], kp["kp2"], kp["valid"]
    keys = _split_keys(rng)
    eye4 = torch.eye(4, dtype=torch.float32, device=flow_fwd.device)
    lead = valid.shape[:-1]

    if tcfg.tracking_method == "PnP":
        # PnP every frame: E_pose stays identity, so every good-kp frame
        # takes the PnP branch
        e_out = {"inliers": torch.zeros_like(valid)}
        scale = torch.full(lead, -1.0, device=flow_fwd.device)
        no = torch.zeros(lead, dtype=torch.bool, device=flow_fwd.device)
        return _finish_tracking_step(
            rng, tcfg, kp, e_out, no, eye4, scale, no, prev_motion, depth_ref,
            depth_cur, depth_ref_raw, flow_fwd, flow_diff, K, K_inv)

    # the first E pass runs 3 repeats when a refined pass follows
    e_out = compute_pose_2d2d(
        keys[..., 0, :], kp_cur, kp_ref, valid, K, K_inv,
        reproj_thre=tcfg.e_reproj_thre, repeats=3 if tcfg.e_iterative_kp else tcfg.e_repeat,
        num_hypotheses=tcfg.num_hypotheses, validity_method=tcfg.validity_method,
        validity_thre=tcfg.validity_thre,
    )
    stage = (keys, e_out, kp_ref, kp_cur, valid, flow_fwd, flow_diff, depth_ref_raw, depth_cur)
    if carry_scale:
        e_out, T_e, scale, spike = _scale_stage_carried(stage, prev_scale, K, K_inv, tcfg)
    else:
        e_out, T_e, scale, spike = _scale_stage(*stage, _scalar(prev_scale, valid), K, K_inv,
                                                tcfg)
    e_success = e_out["valid"] & (scale != -1.0)
    return _finish_tracking_step(
        rng, tcfg, kp, e_out, e_success, _scaled(T_e, scale), scale, spike, prev_motion,
        depth_ref, depth_cur, depth_ref_raw, flow_fwd, flow_diff, K, K_inv)


def _scale_stage(keys, e_out, kp_ref, kp_cur, valid, flow_fwd, flow_diff, depth_ref_raw,
                 depth_cur, prev_scale, K, K_inv, tcfg):
    """Scale recovery, the iterative keypoints of the E tracker and the
    jump guard, after the first E pass; ``prev_scale`` is a tensor that
    broadcasts over the frames.

    Returns:
        (e_out, T_e (cur -> ref, unit translation), scale, spike).
    """
    T_e = make_se3(e_out["R"], e_out["t"])  # cur -> ref, unit translation

    def simple_scale(key, kp_r, kp_c, v, T):
        return find_scale_from_depth(
            key, kp_r, kp_c, v, se3_inverse(T), depth_cur, K_inv,
            ransac_thre=tcfg.scale_ransac_thre, max_trials=tcfg.scale_max_trials,
            min_samples=tcfg.scale_min_samples,
        )["scale"]

    if tcfg.scale_method == "simple":
        scale = simple_scale(keys[..., 1, :], kp_ref, kp_cur, valid, T_e)
    else:
        # five iterations of rigid-flow consistent keypoints and a scale
        # refit, each frame frozen once |delta scale| < 0.001; no host read.
        # Row 8 + i of the step keys is fold_in(keys[2], i).
        scale = prev_scale.expand(valid.shape[:-1])
        done = torch.zeros_like(scale, dtype=torch.bool)
        for i in range(prng.ITER_SCALE_ITERS):
            rkp = _rigid_flow_kp(flow_fwd, flow_diff, depth_ref_raw,
                                 se3_inverse(_scaled(T_e, scale)), K, K_inv, tcfg,
                                 tcfg.scale_iter_score_method, ("uniform",))
            new_scale = simple_scale(keys[..., 8 + i, :], rkp["kp1_uniform"],
                                     rkp["kp2_uniform"], rkp["valid_uniform"], T_e)
            delta = torch.abs(new_scale - scale)
            scale = torch.where(done, scale, new_scale)
            done = done | (delta < 0.001)
    minus_one = torch.full_like(scale, -1.0)
    scale = torch.where(e_out["valid"], scale, minus_one)

    if tcfg.e_iterative_kp:
        # a second E pass on the rigid-flow best keypoints of the scaled
        # pose, adopted where it is valid
        T_hybrid = _scaled(T_e, torch.where(scale != -1, scale, torch.ones_like(scale)))
        rkp = _rigid_flow_kp(flow_fwd, flow_diff, depth_ref_raw, se3_inverse(T_hybrid), K,
                             K_inv, tcfg, tcfg.e_iter_score_method, ("best",))
        e_ref = compute_pose_2d2d(
            keys[..., 3, :], rkp["kp2_best"], rkp["kp1_best"], rkp["valid_best"], K, K_inv,
            reproj_thre=tcfg.e_reproj_thre, repeats=tcfg.e_repeat,
            num_hypotheses=tcfg.num_hypotheses, validity_method=tcfg.validity_method,
            validity_thre=tcfg.validity_thre,
        )
        use_ref = e_ref["valid"]
        refined = {name: _where(use_ref, e_ref[name], e_out[name])
                   for name in ("R", "t", "inliers", "inlier_cnt")}
        e_out = dict(refined, valid=e_out["valid"] | use_ref)
        T_e = make_se3(e_out["R"], e_out["t"])
        if tcfg.scale_iterative_kp:
            scale_ref = simple_scale(keys[..., 4, :], rkp["kp1_best"], rkp["kp2_best"],
                                     rkp["valid_best"], T_e)
            scale = torch.where(e_out["valid"], scale_ref, minus_one)

    spike = torch.zeros_like(scale, dtype=torch.bool)
    if tcfg.scale_jump_guard > 0:
        # a physically impossible jump means the depth-ratio consensus was
        # captured by outliers: fail the scale so PnP takes the frame
        g = tcfg.scale_jump_guard
        spike = (prev_scale > 0) & (scale > 0) & ((scale > prev_scale * g)
                                                   | (scale * g < prev_scale))
        scale = torch.where(spike, minus_one, scale)
    return e_out, T_e, scale, spike


def _scale_stage_carried(stage, prev_scale, K, K_inv, tcfg):
    """:func:`_scale_stage` frame by frame over axis 0, each frame seeded
    with the running scale: ``prev_scale`` before the first, then the last
    positive scale, carried on the device as the JAX package's scanned
    step carries it."""
    carry = _scalar(prev_scale, stage[4])
    outs = []
    for i in range(stage[4].shape[0]):
        e_out, T_e, scale, spike = _scale_stage(
            stage[0][i], {k: v[i] for k, v in stage[1].items()}, *[t[i] for t in stage[2:]],
            carry, K, K_inv, tcfg)
        carry = torch.where(scale > 0, scale, carry)
        outs.append((e_out, T_e, scale, spike))
    e_out = {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}
    return (e_out,) + tuple(torch.stack([o[j] for o in outs]) for j in (1, 2, 3))


def _finish_tracking_step(rng, tcfg, kp, e_out, e_success, pose_e, scale, spike, prev_motion,
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
        "spike": spike,
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
                        tcfg, prev_scale=1.0):
    """The scan runner's batched step: ``jax.vmap`` of the step over a
    chunk's frames in the JAX package (``scan_runner.py``), here one call
    over a leading frame axis.

    Each frame gets a dummy previous motion (the identity): the chunk's
    fix-up pass puts in the constant-motion poses. With simple scale
    recovery each frame also gets a dummy previous scale (1.0) and no
    scale-jump guard: the chunk's spike pass applies the guard with the
    true running scale. With iterative scale recovery, which the running
    scale seeds, the scale stage runs frame by frame from ``prev_scale``
    with the guard, the running scale carried on the device (the JAX
    package scans its whole step for it; the keypoints, the first E pass
    and the PnP fallback do not depend on the carry and stay batched).
    The PnP fallback is deferred (placeholder pose and ``need_pnp``)
    unless ``force_e_path`` drops it, so the call reads nothing on the
    host. The drawer's rigid-flow map is not computed.

    Args:
        keys: [T x 13 x 2] int64 step keys on the device
            (``prng.step_keys``).
        flow_fwd: [T x H x W x 2]; flow_diff, depth_cur_raw,
            depth_ref_raw: [T x H x W].
        K, K_inv: [3 x 3] intrinsics.
        tcfg: the TrackingConfig of the frame execution.
        prev_scale: the running scale before the chunk (iterative scale
            recovery only).
    """
    iterative = tcfg.scale_method == "iterative"
    tcfg_v = dataclasses.replace(
        tcfg, defer_pnp=not tcfg.force_e_path, want_rigid_flow_diff=False,
        scale_jump_guard=tcfg.scale_jump_guard if iterative else 0.0)
    eye = torch.eye(4, dtype=torch.float32, device=flow_fwd.device)
    return tracking_step(keys, flow_fwd, flow_diff, depth_cur_raw, depth_ref_raw, eye, K,
                         K_inv, tcfg_v, prev_scale=prev_scale if iterative else 1.0,
                         carry_scale=iterative)
