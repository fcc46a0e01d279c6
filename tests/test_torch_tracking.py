"""Parity of the PyTorch port's tracking step with the JAX package, on the
CPU in float32.

The scenes are tests/test_pipeline.py's (analytic depth and exact rigid
flow from a known motion) and the spike case of
tests/test_tracking_options.py (previous scale 0.1): the E-success scene,
the planar scene that GRIC sends to PnP, the constant-motion scene, and
the scale spike that the jump guard sends to PnP. The JAX tracking step
runs once per scene with test_pipeline's TCFG, the static program the JAX
suite builds; only test_tracking_step_matches_jax reads it, so one test
worker compiles it. Tolerances: the same ``mode``, rotation within 0.01
deg, translation within 1e-3 |t|, scale within 1e-3 relative, the same
keypoints, inlier masks equal on at least 99.5 % of the valid keypoints.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.pipeline import tracking as T_tr
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils import prng
from dfvo_tpu.pipeline import tracking as J_tr
from dfvo_tpu.utils import ConfigLoader
from tests.test_pipeline import H, TCFG, W, K, K_inv, gt_motion, smooth_depth, synthesize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options/examples/default_configuration.yml")
T_TCFG = T_tr.TrackingConfig(**dataclasses.asdict(TCFG))


def rot_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees (atan2 form, exact near zero)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    v = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return np.degrees(np.arctan2(np.linalg.norm(v) / 2, (np.trace(M) - 1) / 2))


def _scenes():
    """name -> (flow, flow_diff, depth_cur, depth_ref, prev_motion,
    prev_scale, ground-truth T_cur2ref or None)."""
    zeros = np.zeros((H, W), np.float32)
    eye = np.eye(4, dtype=np.float32)
    out = {}
    depth_ref = smooth_depth(np.random.RandomState(0))
    T_gt, T_r2c = gt_motion(scale=1.5)
    flow, depth_cur = synthesize(depth_ref, T_r2c)
    out["essential"] = (flow, zeros, depth_cur, depth_ref, eye, 1.0, T_gt)
    depth_ref = np.full((H, W), 15.0, np.float32)
    T_gt, T_r2c = gt_motion(scale=0.8)
    flow, depth_cur = synthesize(depth_ref, T_r2c)
    out["planar"] = (flow, zeros, depth_cur, depth_ref, eye, 1.0, T_gt)
    rng = np.random.RandomState(1)
    depth_ref = smooth_depth(rng)
    flow = rng.randn(H, W, 2).astype(np.float32)
    prev = eye.copy()
    prev[2, 3] = 0.7
    out["const"] = (flow, np.ones((H, W), np.float32), depth_ref, depth_ref, prev, 1.0, None)
    depth_ref = smooth_depth(np.random.RandomState(3))
    T_gt, T_r2c = gt_motion(scale=1.5)
    flow, depth_cur = synthesize(depth_ref, T_r2c)
    out["spike"] = (flow, zeros, depth_cur, depth_ref, eye, 0.1, T_gt)
    return out


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


def run_jax(inputs):
    flow, fd, dc, dr, prev, ps, _ = inputs
    return jax.device_get(J_tr.tracking_step(
        jax.random.PRNGKey(0), jnp.asarray(flow), jnp.asarray(fd), jnp.asarray(dc),
        jnp.asarray(dr), jnp.asarray(prev), jnp.asarray(K), jnp.asarray(K_inv), TCFG,
        prev_scale=ps,
    ))


def run_port(inputs, tcfg=T_TCFG):
    flow, fd, dc, dr, prev, ps, _ = inputs
    return T_tr.tracking_step(
        prng.PRNGKey(0), *[torch.from_numpy(a) for a in (flow, fd, dc, dr, prev)],
        torch.from_numpy(K), torch.from_numpy(K_inv), tcfg, prev_scale=ps,
    )


# mode, and the JAX tests' own bounds against the ground truth
# (tests/test_pipeline.py, tests/test_tracking_options.py)
EXPECTED = {
    "essential": T_tr.TRACK_MODE_ESSENTIAL,
    "planar": T_tr.TRACK_MODE_PNP,
    "const": T_tr.TRACK_MODE_CONST,
    "spike": T_tr.TRACK_MODE_PNP,
}


def test_tracking_step_matches_jax(scenes):
    """Each scene through both packages (one test, so that one worker
    compiles the JAX step)."""
    for scene, inputs in scenes.items():
        want = run_jax(inputs)
        got = {k: v.numpy() for k, v in run_port(inputs).items()}
        _assert_step_matches(scene, inputs, got, want)


def _assert_step_matches(scene, inputs, got, want):
    msg = f"scene {scene}"
    assert int(got["mode"]) == int(want["mode"]) == EXPECTED[scene], msg
    assert bool(got["good_kp_found"]) == bool(want["good_kp_found"]), msg
    np.testing.assert_array_equal(got["kp_valid"], want["kp_valid"], err_msg=msg)
    np.testing.assert_allclose(got["kp_ref"], want["kp_ref"], atol=0, err_msg=msg)
    np.testing.assert_allclose(got["kp_cur"], want["kp_cur"], rtol=1e-5, atol=1e-4,
                               err_msg=msg)
    P, PJ = got["pose"].astype(np.float64), np.asarray(want["pose"], np.float64)
    assert rot_deg(P[:3, :3], PJ[:3, :3]) < 0.01, msg
    assert np.linalg.norm(P[:3, 3] - PJ[:3, 3]) <= 1e-3 * np.linalg.norm(PJ[:3, 3]), msg
    s, sj = float(got["scale"]), float(want["scale"])
    assert abs(s - sj) <= 1e-3 * abs(sj), msg
    valid = got["kp_valid"]
    if valid.any():
        assert (got["inliers"] == want["inliers"])[valid].mean() >= 0.995, msg
    np.testing.assert_allclose(got["depth_cur"], want["depth_cur"], atol=0, err_msg=msg)
    np.testing.assert_allclose(got["rigid_flow_diff"], want["rigid_flow_diff"],
                               rtol=1e-3, atol=1e-3, err_msg=msg)

    T_gt = inputs[-1]
    if scene == "essential":
        assert rot_deg(P[:3, :3], T_gt[:3, :3]) < 0.1
        assert abs(np.linalg.norm(P[:3, 3]) - 1.5) / 1.5 < 0.05
        assert np.linalg.norm(P[:3, 3] - T_gt[:3, 3]) < 0.15
    elif scene == "planar":
        assert rot_deg(P[:3, :3], T_gt[:3, :3]) < 0.1
        assert np.linalg.norm(P[:3, 3] - T_gt[:3, 3]) < 0.1
    elif scene == "const":
        np.testing.assert_allclose(P, inputs[4], atol=1e-6)
    else:
        assert s == -1.0
        assert np.linalg.norm(P[:3, 3] - T_gt[:3, 3]) < 0.1


def test_force_e_path_falls_back_to_constant_motion(scenes):
    """force_e_path: no PnP branch; the planar frame keeps the previous
    motion, and the step reads nothing on the host."""
    inputs = scenes["planar"]
    prev = np.eye(4, dtype=np.float32)
    prev[0, 3] = 0.3
    out = run_port(inputs[:4] + (prev,) + inputs[5:],
                   dataclasses.replace(T_TCFG, force_e_path=True))
    assert int(out["mode"]) == T_tr.TRACK_MODE_CONST
    np.testing.assert_array_equal(out["pose"].numpy(), prev)
    assert not bool(out["need_pnp"])


def test_pnp_method_tracks_every_frame_with_pnp(scenes):
    """tracking_method: PnP sends every good-keypoint frame to PnP, which
    recovers the metric pose of the E scene."""
    inputs = scenes["essential"]
    out = run_port(inputs, dataclasses.replace(T_TCFG, tracking_method="PnP"))
    assert int(out["mode"]) == T_tr.TRACK_MODE_PNP
    assert float(out["scale"]) == -1.0
    P, T_gt = out["pose"].numpy().astype(np.float64), inputs[-1]
    assert rot_deg(P[:3, :3], T_gt[:3, :3]) < 0.1
    assert np.linalg.norm(P[:3, 3] - T_gt[:3, 3]) < 0.1


def test_frame_keys_match_jax():
    """The frame step's key, fold_in(PRNGKey(seed), img_id), and the
    step's split(rng, 8), word for word."""
    for seed, img_id in ((4869, 1), (4869, 3), (0, 0), (123, 4540)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), img_id)
        tk = prng.fold_in(prng.PRNGKey(seed), img_id)
        np.testing.assert_array_equal(tk, np.asarray(jax.random.key_data(jk)))
        np.testing.assert_array_equal(prng.split(tk, 8),
                                      np.asarray(jax.random.key_data(jax.random.split(jk, 8))))


def test_from_cfg_matches_jax():
    """TrackingConfig's defaults, and from_cfg of the default YAML and of
    the option variants that change its routing, field for field."""
    def both(edit=None):
        out = []
        for loader, cls in ((ConfigLoader, J_tr.TrackingConfig),
                            (TConfigLoader, T_tr.TrackingConfig)):
            cfg = loader().merge_cfg([DEFAULT_CFG])
            if edit:
                edit(cfg)
            out.append(dataclasses.asdict(cls.from_cfg(cfg)))
        return out

    def pnp(cfg):
        cfg.tracking_method = "PnP"

    def guard_off(cfg):
        cfg.tpu.scale_jump_guard = 0
        cfg.tpu.scale_ransac_hypotheses = 64
        cfg.visualization.enable = False

    assert (dataclasses.asdict(T_tr.TrackingConfig())
            == dataclasses.asdict(J_tr.TrackingConfig()))
    for edit in (None, pnp, guard_off):
        want, got = both(edit)
        assert got == want
    want, _ = both()
    assert want["scale_max_trials"] == 1024 and want["scale_jump_guard"] == 5.0

    def bad_src(cfg):
        cfg.e_tracker.kp_src = "kp_list"

    with pytest.raises(ValueError, match="kp_src"):
        both(bad_src)
