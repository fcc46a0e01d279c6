"""Parity of the port's optional tracking stages with the JAX package, on
the CPU in float32: the ``bestN`` and ``sampled`` keypoint selectors, the
rigid-flow keypoints (``opt_rigid_flow_kp``), depth consistency, and the
tracking step with iterative scale recovery and the iterative keypoints of
the E and PnP trackers, frame by frame and as the scan execution's
chunk step.

The selectors run at small sizes; keypoints are held equal to JAX's
exactly (ties included: an all-zero ``flow_diff``, as the synthetic scenes
have, makes every pixel tie), ``kp2`` within 1e-6 (one float32 add). The
tracking step runs on the E and planar scenes of
tests/test_torch_tracking.py and on a chunk of oracle frames with one
option set (iterative scale, ``e_iterative_kp`` + ``scale_iterative_kp``,
``pnp_iterative_kp``): one JAX compile, read by one test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.matching import kp_selection as T_kp
from dfvo_torch.pipeline import scan_runner as T_scan
from dfvo_torch.pipeline import tracking as T_tr
from dfvo_torch.synth.oracle import make_oracle_sequence
from dfvo_torch.utils import prng
from dfvo_tpu.matching import kp_selection as J_kp
from dfvo_tpu.pipeline import tracking as J_tr
from tests.test_pipeline import TCFG, H, W, K, K_inv, gt_motion, smooth_depth, synthesize
from tests.test_torch_tracking import EXPECTED, T_TCFG, _scenes, rot_deg, run_port

# the iterative options, all on: one JAX program
ITERATIVE = dict(scale_method="iterative", e_iterative_kp=True, scale_iterative_kp=True,
                 pnp_iterative_kp=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


def _flow_inputs(seed, h, w, ties):
    rng = np.random.RandomState(seed)
    flow = (rng.randn(h, w, 2) * 3).astype(np.float32)
    if ties == "zeros":
        fd = np.zeros((h, w), np.float32)
    elif ties == "quantised":  # a few distinct values: ties everywhere
        fd = (rng.randint(0, 4, (h, w)) * 0.05).astype(np.float32)
    else:
        fd = (rng.rand(h, w) * 0.3).astype(np.float32)
    return flow, fd


def _assert_kp_equal(got, want, names=("kp1", "kp2", "valid")):
    kp1, kp2, valid = names
    np.testing.assert_array_equal(got[kp1].numpy(), np.asarray(want[kp1]))
    np.testing.assert_array_equal(got[valid].numpy(), np.asarray(want[valid]))
    np.testing.assert_allclose(got[kp2].numpy(), np.asarray(want[kp2]), atol=1e-6)


@pytest.mark.parametrize("ties", ["zeros", "quantised", "random"])
def test_bestN_matches_jax(ties):
    """bestN_flow_kp: the N most consistent pixels in JAX's order, the
    lower index first among equal values."""
    flow, fd = _flow_inputs(1, 24, 40, ties)
    want = J_kp.bestN_flow_kp(jnp.asarray(flow), jnp.asarray(fd), 300)
    got = T_kp.bestN_flow_kp(_t(flow), _t(fd), 300)
    _assert_kp_equal(got, want)
    assert bool(got["good_kp_found"]) and bool(want["good_kp_found"])
    if ties == "zeros":  # every pixel ties: the first 300 in raster order
        idx = np.arange(300)
        np.testing.assert_array_equal(got["kp1"].numpy(), np.stack([idx % 40, idx // 40], -1))


@pytest.mark.parametrize("crop", [((0.0, 1.0), (0.0, 1.0)), ((0.3, 1.0), (0.1, 0.9))])
def test_sampled_matches_jax(crop):
    flow, _ = _flow_inputs(2, 30, 50, "random")
    kp1 = J_kp.sampled_kp_indices(30, 50, crop, 200)
    np.testing.assert_array_equal(T_kp.sampled_kp_indices(30, 50, crop, 200), kp1)
    want = J_kp.sampled_kp(jnp.asarray(kp1), jnp.asarray(flow))
    got = T_kp.sampled_kp(_t(kp1), _t(flow))
    _assert_kp_equal(got, want)


@pytest.mark.parametrize("score_method", ["rigid_flow", "opt_flow"])
def test_opt_rigid_flow_kp_matches_jax(score_method):
    """Both variants: the best keypoints per cell and the uniformly strided
    ones (a stable valid-first order); cells with no, few and many
    valid pixels, and quantised scores that tie."""
    h, w = 40, 60
    flow, fd = _flow_inputs(3, h, w, "quantised")
    rng = np.random.RandomState(4)
    rd = (rng.randint(0, 8, (h, w)) * 1.0).astype(np.float32)
    rd[:10, :20] = 9.0  # a cell block with no rigid-consistent pixel
    jspec = J_kp.KPSelectionSpec(h, w, 4, 5, 200)
    tspec = T_kp.KPSelectionSpec(h, w, 4, 5, 200)
    want = J_kp.opt_rigid_flow_kp(jspec, jnp.asarray(flow), jnp.asarray(fd), jnp.asarray(rd),
                                  rigid_thre=5.0, opt_thre=0.1, score_method=score_method)
    got = T_kp.opt_rigid_flow_kp(tspec, _t(flow), _t(fd), _t(rd), rigid_thre=5.0,
                                 opt_thre=0.1, score_method=score_method)
    for variant in ("best", "uniform"):
        _assert_kp_equal(got, want, (f"kp1_{variant}", f"kp2_{variant}", f"valid_{variant}"))
        assert 0 < int(got[f"valid_{variant}"].sum()) < 200
    # over a frame axis, each frame as alone
    both = T_kp.opt_rigid_flow_kp(tspec, _t(np.stack([flow, -flow])), _t(np.stack([fd, fd])),
                                  _t(np.stack([rd, rd[::-1].copy()])), score_method=score_method,
                                  variants=("uniform",))
    one = T_kp.opt_rigid_flow_kp(tspec, _t(-flow), _t(fd), _t(rd[::-1].copy()),
                                 score_method=score_method, variants=("uniform",))
    assert "kp1_best" not in both
    for k in ("kp1_uniform", "kp2_uniform", "valid_uniform"):
        assert torch.equal(both[k][1], one[k])


def test_depth_consistency_matches_jax():
    """compute_depth_consistency (values in [0, 1]) over a frame axis: a
    consistent pair (the current depth scattered into the reference view
    by the motion), the same pair under a wrong pose, and a smooth
    unrelated reference depth. Within 1e-5 on the smooth depth; within
    2e-4 on the scattered one, whose zero holes turn the sampler's
    rounding of a coordinate into a jump of the bilinear weights (1.2e-4
    measured, on 1.3 % of the pixels)."""
    depth_cur = smooth_depth(np.random.RandomState(2))
    T_cur2ref, _ = gt_motion(scale=0.5)
    _, scattered = synthesize(depth_cur, T_cur2ref)
    bad = np.eye(4, dtype=np.float32)
    bad[2, 3] = 5.0
    refs = np.stack([scattered, scattered, smooth_depth(np.random.RandomState(5))])
    poses = np.stack([T_cur2ref.astype(np.float32), bad, T_cur2ref.astype(np.float32)])
    got = T_tr.compute_depth_consistency(_t(np.stack([depth_cur] * 3)), _t(refs), _t(poses),
                                         _t(K), _t(K_inv)).numpy()
    for i, atol in enumerate((2e-4, 2e-4, 1e-5)):
        want = np.asarray(J_tr.compute_depth_consistency(
            jnp.asarray(depth_cur), jnp.asarray(refs[i]), jnp.asarray(poses[i]),
            jnp.asarray(K), jnp.asarray(K_inv)))
        np.testing.assert_allclose(got[i], want, atol=atol, err_msg=f"pair {i}")
    assert np.median(got[0, 20:-20, 40:-40]) < 0.05 < np.median(got[1, 20:-20, 40:-40])


class _Zeros:
    """A frontend stub of zero network outputs: a chunk step with an oracle
    then tracks the oracle alone."""

    def infer_chunk(self, variables, all_imgs):
        m, h, w = all_imgs.shape[:3]
        z = torch.zeros((m - 1, h, w))
        return {"depths": z, "flow_fwd": torch.zeros((m - 1, h, w, 2)), "flow_diff": z}


def _oracle_chunk():
    """Five oracle pairs at 192x640: coherent E frames, pair 2's current
    depth divided by 30 (its scale jumps x30: the guard sends it to PnP)
    and pair 4's multiplied by 30 (past max_depth: its scale fails)."""
    depths, flows, _ = make_oracle_sequence(H, W, K, 6, seed=0, speed=2.0)
    depths = [np.asarray(d) for d in depths]
    depths[3] = depths[3] / 30.0
    depths[5] = depths[5] * 30.0
    return depths, np.stack(flows), np.full((5, H, W), 0.01, np.float32)


def test_iterative_options_match_jax(scenes):
    """The iterative step (iterative scale, ``e_iterative_kp`` +
    ``scale_iterative_kp``, ``pnp_iterative_kp``) of both packages, on one
    JAX compile.

    The E and planar scenes: the same mode, rotation within 0.01 deg,
    translation within 1e-3 |t|, scale within 1e-3, the same selector
    keypoints. Inlier masks: on the E scene (the refined pass's keypoints
    scored by an all-zero flow_diff, in index order) equal on 99.5 % of the
    keypoints; on the planar scene the PnP pass's rigid-flow keypoints are
    scored by |rigid - optical flow|, rounding noise on an exact scene, so
    the packages pick other pixels and only the inlier counts are held
    (within 10 %).

    Then one chunk of five oracle frames through the port's iterative
    chunk step (keypoints, first E pass and PnP batched; the scale stage
    frame by frame) against the JAX package's iterative chunk step, which
    scans the jitted step over the frames carrying the pose and the scale
    (``new_scale = where(scale > 0, scale, prev)``), here run frame by
    frame on the host: modes equal (pair 2 spiked), poses within 1e-5, each
    frame's scale and the carried scale within 1e-5 relative.
    """
    jcfg = dataclasses.replace(TCFG, **ITERATIVE)
    tcfg = dataclasses.replace(T_TCFG, **ITERATIVE)

    def jax_step(key, flow, fd, dc, dr, prev, ps):
        return jax.device_get(J_tr.tracking_step(
            key, *[jnp.asarray(a) for a in (flow, fd, dc, dr, prev)], jnp.asarray(K),
            jnp.asarray(K_inv), jcfg, prev_scale=ps))

    for scene in ("essential", "planar"):
        flow, fd, dc, dr, prev, ps, T_gt = scenes[scene]
        want = jax_step(jax.random.PRNGKey(0), flow, fd, dc, dr, prev, jnp.float32(ps))
        got = {k: v.numpy() for k, v in run_port(scenes[scene], tcfg).items()}
        msg = f"scene {scene}"
        assert int(got["mode"]) == int(want["mode"]) == EXPECTED[scene], msg
        np.testing.assert_array_equal(got["kp_ref"], want["kp_ref"], err_msg=msg)
        P, PJ = got["pose"].astype(np.float64), np.asarray(want["pose"], np.float64)
        assert rot_deg(P[:3, :3], PJ[:3, :3]) < 0.01, msg
        assert np.linalg.norm(P[:3, 3] - PJ[:3, 3]) <= 1e-3 * np.linalg.norm(PJ[:3, 3]), msg
        s, sj = float(got["scale"]), float(want["scale"])
        assert abs(s - sj) <= 1e-3 * abs(sj), msg
        n, nj = int(got["inliers"].sum()), int(want["inliers"].sum())
        if scene == "essential":
            assert (got["inliers"] == want["inliers"]).mean() >= 0.995, msg
            assert abs(np.linalg.norm(P[:3, 3]) - 1.5) / 1.5 < 0.05
        else:
            assert abs(n - nj) <= 0.1 * nj, msg
        assert rot_deg(P[:3, :3], T_gt[:3, :3]) < 0.15, msg
        assert np.linalg.norm(P[:3, 3] - T_gt[:3, 3]) < 0.15, msg

    depths, flows, diffs = _oracle_chunk()
    step, _ = T_scan.make_chunk_step(_Zeros(), tcfg)
    info = {}
    tposes, tmodes, tcarry = step(
        None, torch.zeros((5, H, W, 3), dtype=torch.uint8),
        (torch.zeros(H, W, 3, dtype=torch.uint8), _t(depths[0]), torch.eye(4), 1.0),
        _t(prng.step_keys(0, range(1, 6)).astype(np.int64)), _t(K), _t(K_inv),
        oracle={"depths": _t(np.stack(depths[1:])), "flow_fwd": _t(flows),
                "flow_diff": _t(diffs)}, info=info)
    motion, scale = np.eye(4, dtype=np.float32), jnp.float32(1.0)
    jmodes, jscales = [], []
    for i in range(5):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i + 1)
        out = jax_step(key, flows[i], diffs[i], depths[i + 1], depths[i], motion, scale)
        np.testing.assert_allclose(tposes[i].numpy(), out["pose"], atol=1e-5,
                                   err_msg=f"chunk frame {i}")
        jmodes.append(int(out["mode"]))
        jscales.append(float(out["scale"]))
        motion, scale = out["pose"], jnp.where(out["scale"] > 0, out["scale"], scale)
    E, P = T_tr.TRACK_MODE_ESSENTIAL, T_tr.TRACK_MODE_PNP
    assert jmodes == [E, E, P, E, P]
    assert tmodes.tolist() == jmodes
    assert info["spike"].tolist() == [False, False, True, False, False]
    np.testing.assert_allclose(info["scale"], jscales, rtol=1e-5)
    np.testing.assert_allclose(float(tcarry[3]), float(scale), rtol=1e-5)
    np.testing.assert_allclose(tcarry[2].numpy(), motion, atol=1e-5)


@pytest.mark.parametrize("kp_method", ["bestN", "sampled"])
def test_selectors_track_the_essential_scene(scenes, kp_method):
    """The port's step with the global best-N or the uniform selector
    tracks the E scene by E, to tests/test_pipeline.py's bounds. The
    scene's flow_diff is redrawn uniform below 0.1 (on an all-zero one
    best-N takes the top rows of the image, which fixes no pose)."""
    flow, _, dc, dr, prev, ps, T_gt = scenes["essential"]
    fd = (np.random.RandomState(6).rand(*dc.shape) * 0.1).astype(np.float32)
    tcfg = dataclasses.replace(T_TCFG, kp_method=kp_method)
    out = run_port((flow, fd, dc, dr, prev, ps, T_gt), tcfg)
    assert int(out["mode"]) == T_tr.TRACK_MODE_ESSENTIAL
    P = out["pose"].numpy().astype(np.float64)
    assert rot_deg(P[:3, :3], T_gt[:3, :3]) < 0.1
    assert abs(np.linalg.norm(P[:3, 3]) - 1.5) / 1.5 < 0.05
    assert int(out["kp_valid"].sum()) == tcfg.num_kp


def test_depth_consistency_reaches_the_selector(scenes, monkeypatch):
    """With depth consistency on, a deep pose routes the depth-consistency
    map into local_bestN (its threshold applied); without a deep pose (the
    scan execution's case) the option does nothing."""
    flow, fd, dc, dr, prev, ps, _ = scenes["essential"]
    seen = []
    local = T_tr.local_bestN

    def spy(*args, **kwargs):
        seen.append(kwargs["depth_diff"])
        return local(*args, **kwargs)

    monkeypatch.setattr(T_tr, "local_bestN", spy)
    tcfg = dataclasses.replace(T_TCFG, depth_consistency=True)
    inputs = [_t(a) for a in (flow, fd, dc, dr, prev)]
    bad = torch.eye(4)
    bad[2, 3] = 5.0
    out = T_tr.tracking_step(prng.PRNGKey(0), *inputs, _t(K), _t(K_inv), tcfg, deep_pose=bad)
    torch.testing.assert_close(seen[-1], T_tr.compute_depth_consistency(
        inputs[2], inputs[3], bad, _t(K), _t(K_inv)))
    plain = T_tr.tracking_step(prng.PRNGKey(0), *inputs, _t(K), _t(K_inv), tcfg)
    assert seen[-1] is None
    assert not torch.equal(out["kp_ref"], plain["kp_ref"])


def test_step_keys_fold_like_jax():
    """The iterative scale's keys: fold_in(split(fold_in(PRNGKey(seed),
    i), 8)[2], j) for j < 5, word for word, after the eight split keys."""
    ids = [1, 7, 4540]
    got = prng.step_keys(4869, ids)
    assert got.shape == (3, 13, 2)
    for row, i in enumerate(ids):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(4869), i), 8)
        np.testing.assert_array_equal(got[row, :8], np.asarray(jax.random.key_data(keys)))
        for j in range(5):
            np.testing.assert_array_equal(
                got[row, 8 + j], np.asarray(jax.random.key_data(jax.random.fold_in(keys[2], j))))
