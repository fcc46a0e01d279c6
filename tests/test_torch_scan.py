"""The port's scan execution against the JAX package and against the port's
own frame execution, on the CPU in float32.

Sizes are those of tests/test_scan_runner.py (64x96, 32 hypotheses,
``scan_chunk: 3``, float32), so each JAX program here is one the JAX suite
compiles too: the chunk step with an oracle of
``test_scan_scale_jump_guard_matches_sequential`` and the scan CLI of
``test_cli_scan_execution_matches_frame_execution``. No JAX initialisation
is compiled: the weights are the port's seeded initialisation converted by
the JAX package's converters (tests/test_torch_models.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.models import convert as bridge
from dfvo_torch.pipeline import scan_runner as T_scan
from dfvo_torch.pipeline import tracking as T_tr
from dfvo_torch.pipeline.dfvo import DFVO as TDFVO
from dfvo_torch.solvers import ransac as T_ran
from dfvo_torch.synth.oracle import make_oracle_sequence
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils import prng
from dfvo_torch.utils.io import load_poses_from_txt
from dfvo_tpu.pipeline import DFVO as JDFVO
from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend
from dfvo_tpu.pipeline.scan_runner import ScanRunner as JScanRunner
from dfvo_tpu.utils import ConfigLoader
from tests.test_torch_models import _perturb, seeded_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options/examples/default_configuration.yml")
H, W = 64, 96
K = np.array([[55.0, 0, 48.0], [0, 55.0, 32.0], [0, 0, 1.0]], np.float32)
K_inv = np.linalg.inv(K).astype(np.float32)
N_FRAMES = 8
# the GT's first pose: a turn of about 17 degrees and an offset, so a
# trajectory that starts at the identity differs from one that starts here
G0 = np.array([[0.956, 0.0, 0.2934, 1.5], [0.0, 1.0, 0.0, -0.25],
               [-0.2934, 0.0, 0.956, 3.0], [0.0, 0.0, 0.0, 1.0]])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keys(seed, ids):
    return _t(prng.step_keys(seed, ids).astype(np.int64))


# -- (a) the batched draws ----------------------------------------------------

def test_chunk_keys_match_jax():
    ids = [1, 2, 3, 7, 2**31 + 5]
    want = jax.vmap(lambda i: jax.random.split(jax.random.fold_in(jax.random.PRNGKey(4), i), 8))(
        jnp.asarray(ids, jnp.uint32))
    np.testing.assert_array_equal(prng.chunk_keys(4, ids), np.asarray(jax.random.key_data(want)))


@pytest.mark.parametrize("stage, n, m, k", [(0, 2000, 1280, 8), (1, 2000, 1024, 3),
                                             (5, 300, 500, 6)])
def test_batched_draws_equal_per_key_draws(stage, n, m, k):
    """The device path of the hash over a [T, 2] key batch equals the
    host-key path of each frame bit for bit, and so does sample_points
    over a frame axis (each frame with its own validity)."""
    rng = np.random.RandomState(stage)
    ids = [3, 4, 5, 9]
    keys = prng.chunk_keys(0, ids)[:, stage]
    valid = rng.rand(len(ids), n) < np.array([[0.9], [0.3], [0.01], [0.0]])
    pts = _t(rng.randn(len(ids), n, 5).astype(np.float32))
    order, count = T_ran._valid_front_order(_t(valid))
    draws = T_ran._hash_draw(_t(keys.astype(np.int64)), m * k, count, "cpu")
    got = T_ran.sample_points(_t(keys.astype(np.int64)), pts, _t(valid), m, k)
    for i, key in enumerate(keys):
        o1, c1 = T_ran._valid_front_order(_t(valid[i]))
        assert torch.equal(order[i], o1) and torch.equal(count[i], c1)
        assert torch.equal(draws[i], T_ran._hash_draw(key, m * k, c1, "cpu"))
        assert torch.equal(got[i], T_ran.sample_points(key, pts[i], _t(valid[i]), m, k))
    assert got.shape == (len(ids), m, k, 5)


# -- (b) the batched tracking step ---------------------------------------------

def _oracle_frames(t=4):
    """t oracle pairs at 64x96: coherent E frames, a frame whose
    current-view depth is scaled x30 (past max_depth: its scale fails and
    it asks for PnP), and a frame of random flow."""
    depths, flows, motions = make_oracle_sequence(H, W, K, t + 1, seed=0, speed=2.0)
    depths[3] = depths[3] * 30.0
    flows[3] = np.random.RandomState(0).randn(H, W, 2).astype(np.float32) * 3.0
    return (np.stack(flows), np.full((t, H, W), 0.01, np.float32), np.stack(depths[1:]),
            np.stack(depths[:-1]), motions)


def test_chunk_tracking_step_equals_single_calls():
    """tracking_step_chunk over a frame axis against one deferred
    tracking_step per frame (the JAX package's vmap of it): modes, PnP
    requests, keypoint validity and inliers equal; poses, scales and
    keypoints within 1e-5 (float32 batched products reassociate by an
    ulp). Then the batched PnP fallback against one call per frame."""
    tcfg = T_tr.TrackingConfig(height=H, width=W, num_hypotheses=32)
    flow, fd, dc, dr, _ = _oracle_frames()
    ids = [1, 2, 3, 4]
    keys = _keys(0, ids)
    got = T_tr.tracking_step_chunk(keys, _t(flow), _t(fd), _t(dc), _t(dr), _t(K), _t(K_inv),
                                   tcfg)
    one_cfg = dataclasses.replace(tcfg, defer_pnp=True, scale_jump_guard=0.0,
                                  want_rigid_flow_diff=False)
    assert got["need_pnp"].any() and not got["need_pnp"].all()
    for i, fid in enumerate(ids):
        want = T_tr.tracking_step(prng.fold_in(prng.PRNGKey(0), fid), _t(flow[i]), _t(fd[i]),
                                  _t(dc[i]), _t(dr[i]), torch.eye(4), _t(K), _t(K_inv),
                                  one_cfg, prev_scale=1.0)
        assert set(want) == set(got)
        for name, w in want.items():
            g = got[name][i]
            if w.dtype in (torch.bool, torch.int64):
                assert torch.equal(g, w), f"frame {i}: {name}"
            else:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=f"frame {i}: {name}")
        if want["need_pnp"]:  # the placeholder pose, and no host read
            assert torch.equal(want["pose"], torch.eye(4))

    args = [got[k] for k in ("kp_ref", "kp_cur", "kp_valid", "depth_ref")]
    batched = T_tr.pnp_fallback(keys, *args, _t(flow), _t(fd), _t(dr), _t(K), _t(K_inv), tcfg)
    for i, fid in enumerate(ids):
        one = T_tr.pnp_fallback(prng.fold_in(prng.PRNGKey(0), fid), *[a[i] for a in args],
                                _t(flow[i]), _t(fd[i]), _t(dr[i]), _t(K), _t(K_inv), tcfg)
        assert torch.equal(batched["inliers"][i], one["inliers"]), f"frame {i}"
        torch.testing.assert_close(batched["T"][i], one["T"], atol=1e-5, rtol=0)


def test_chunk_tracking_step_force_e_path():
    """With ``tpu.force_e_path`` the batched step has no PnP branch: no
    frame asks for PnP, and a frame whose E pose fails takes the
    placeholder (the identity) in constant-motion mode, as one call per
    frame does."""
    tcfg = T_tr.TrackingConfig(height=H, width=W, num_hypotheses=32, force_e_path=True)
    flow, fd, dc, dr, _ = _oracle_frames()
    got = T_tr.tracking_step_chunk(_keys(0, [1, 2, 3, 4]), _t(flow), _t(fd), _t(dc), _t(dr),
                                   _t(K), _t(K_inv), tcfg)
    one_cfg = dataclasses.replace(tcfg, scale_jump_guard=0.0, want_rigid_flow_diff=False)
    assert not got["need_pnp"].any()
    assert (got["mode"] == T_tr.TRACK_MODE_CONST).any()
    for i in range(4):
        want = T_tr.tracking_step(prng.fold_in(prng.PRNGKey(0), i + 1), _t(flow[i]), _t(fd[i]),
                                  _t(dc[i]), _t(dr[i]), torch.eye(4), _t(K), _t(K_inv),
                                  one_cfg, prev_scale=1.0)
        assert int(got["mode"][i]) == int(want["mode"])
        torch.testing.assert_close(got["pose"][i], want["pose"], atol=1e-5, rtol=0)


# -- (c) the chunk step against the JAX package's -------------------------------

def _scan_cfg(loader, **tpu):
    cfg = loader().merge_cfg([DEFAULT_CFG])
    cfg.image.height = H
    cfg.image.width = W
    cfg.tpu.ransac_hypotheses = 32
    cfg.tpu.scan_chunk = 3
    cfg.tpu.dtype = "float32"
    for k, v in tpu.items():
        cfg.tpu[k] = v
    return cfg


@pytest.fixture(scope="module")
def weights():
    """Seeded weights for both packages (float32)."""
    jvars = seeded_flax_variables(0)
    tvars = {"depth": bridge.monodepth2_depth_from_flax(jvars["depth"]),
             "flow": bridge.liteflownet_from_flax(jvars["flow"])}
    return jax.tree.map(jnp.asarray, jvars), tvars


def test_chunk_step_matches_jax(weights):
    """The oracle chunk of
    tests/test_scan_runner.py::test_scan_scale_jump_guard_matches_sequential
    (pair 0 goes PnP, pair 1 tracks by E) with pair 2's current-view depth
    divided by 30 instead of multiplied (x30 pushes it past max_depth, so
    its scale fails before the guard): its depth-ratio scale jumps x30 and
    the spike pass sends it to PnP. Both packages' chunk steps on it: modes
    equal, poses within 1e-5, each frame's scale (JAX: |t| of an E frame's
    pose, -1 otherwise) within 1e-5 relative, and the carry."""
    jvars, tvars = weights
    depths, flows, _ = make_oracle_sequence(H, W, K, 4, seed=0, speed=2.0)
    depths = [np.asarray(d) for d in depths]
    depths[3] = depths[3] / 30.0
    oracle = {"depths": np.stack(depths[1:]), "flow_fwd": np.stack(flows),
              "flow_diff": np.full((3, H, W), 0.01, np.float32)}
    imgs = np.zeros((3, H, W, 3), np.uint8)

    jrun = JScanRunner(_scan_cfg(ConfigLoader))
    base = jax.random.PRNGKey(0)
    jposes, jmodes, jcarry = jrun._chunk_step(
        jrun.frontend.prepare_variables(jvars), jnp.asarray(imgs),
        (jnp.zeros((H, W, 3), jnp.uint8), jnp.asarray(depths[0]), jnp.eye(4, dtype=jnp.float32),
         jnp.asarray(1.0, jnp.float32)),
        jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(1, 4)),
        jnp.asarray(K), jnp.asarray(K_inv), oracle={k: jnp.asarray(v) for k, v in oracle.items()})
    jposes, jmodes = np.asarray(jposes), np.asarray(jmodes)

    trun = T_scan.ScanRunner(_scan_cfg(TConfigLoader), device="cpu")
    info = {}
    tposes, tmodes, tcarry = trun._chunk_step(
        trun.frontend.prepare_variables(tvars), _t(imgs),
        (torch.zeros(H, W, 3, dtype=torch.uint8), _t(depths[0]), torch.eye(4), 1.0),
        _keys(0, [1, 2, 3]), _t(K), _t(K_inv), oracle={k: _t(v) for k, v in oracle.items()},
        info=info)

    assert jmodes.tolist() == [T_tr.TRACK_MODE_PNP, T_tr.TRACK_MODE_ESSENTIAL,
                               T_tr.TRACK_MODE_PNP]
    assert tmodes.tolist() == jmodes.tolist()
    assert info["spike"].tolist() == [False, False, True]
    np.testing.assert_allclose(tposes.numpy(), jposes, atol=1e-5)
    jscale = np.where(jmodes == T_tr.TRACK_MODE_ESSENTIAL,
                      np.linalg.norm(jposes[:, :3, 3], axis=-1), -1.0)
    np.testing.assert_allclose(info["scale"], jscale, rtol=1e-5)
    np.testing.assert_allclose(float(tcarry[3]), float(jcarry[3]), rtol=1e-5)
    np.testing.assert_allclose(tcarry[2].numpy(), np.asarray(jcarry[2]), atol=1e-5)
    np.testing.assert_allclose(tcarry[1].numpy(), np.asarray(jcarry[1]), rtol=1e-5)


def test_scan_runner_run_tracks_frames(weights):
    """ScanRunner.run over an in-memory sequence of 6 frames (chunks of 3,
    the last padded): frame 0 at the identity, finite poses with
    rotation blocks on SO(3), and the chunk steps' relative poses chained
    in order."""
    frames = np.random.RandomState(0).randint(0, 255, (6, H, W, 3), dtype=np.uint8)
    cfg = _scan_cfg(TConfigLoader)
    cfg.pnp_tracker.ransac.iter = 20  # every frame goes to PnP: 5 x 20 hypotheses
    runner = T_scan.ScanRunner(cfg, device="cpu")
    poses = runner.run(weights[1], frames, K, K_inv)
    assert sorted(poses) == list(range(6))
    np.testing.assert_allclose(poses[0], np.eye(4))
    for p in poses.values():
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3), atol=1e-5)


# -- (d), (e) DFVO.main in scan execution ---------------------------------------

@pytest.fixture(scope="module")
def kitti_offset(tmp_path_factory):
    """tests/test_torch_dfvo.py's tiny_kitti with a GT that starts at G0,
    not at the identity."""
    import cv2

    root = tmp_path_factory.mktemp("kitti_scan_torch")
    img_dir = root / "odom_data" / "07" / "image_2"
    img_dir.mkdir(parents=True)
    (root / "gt_poses").mkdir()
    rng = np.random.RandomState(3)
    big = cv2.GaussianBlur((rng.rand(200, 600, 3) * 255).astype(np.uint8), (0, 0), 2)
    lines = []
    for i in range(N_FRAMES):
        cv2.imwrite(str(img_dir / f"{i:06d}.jpg"), big[20:140, 8 * i : 8 * i + 400])
        P = np.eye(4)
        P[0, 3] = 0.1 * i
        lines.append(" ".join(str(v) for v in (G0 @ P).flatten()[:12]))
    (root / "gt_poses" / "07.txt").write_text("\n".join(lines) + "\n")
    (root / "odom_data" / "07" / "calib.txt").write_text(
        "".join(f"P{j}: 230.0 0.0 200.0 0.0 0.0 230.0 60.0 0.0 0.0 0.0 1.0 0.0\n"
                for j in range(4)))
    return root


def _cli_cfg(loader, root, result_dir, execution):
    """The configuration of tests/test_scan_runner.py::
    test_cli_scan_execution_matches_frame_execution (the drawer on in scan
    execution, off in frame execution)."""
    cfg = _scan_cfg(loader, execution=execution)
    cfg.seq = "07"
    cfg.directory.img_seq_dir = str(root / "odom_data")
    cfg.directory.gt_pose_dir = str(root / "gt_poses")
    cfg.directory.result_dir = str(result_dir)
    cfg.visualization.enable = execution == "scan"
    cfg.visualization.save_img = False
    return cfg


@pytest.fixture(scope="module")
def perturbed():
    """The weights of tests/test_torch_dfvo.py::test_dfvo_main_matches_jax
    (flow biases redrawn, flow-delta heads x10), so PnP moves the camera by
    millimetres per frame."""
    jvars = seeded_flax_variables(0)
    jvars["flow"] = _perturb(jvars["flow"], np.random.RandomState(0), head_scale=10.0)
    return jvars


def _port_main(cfg, jvars):
    vo = TDFVO(cfg, device="cpu")
    vo.variables = {"depth": bridge.monodepth2_depth_from_flax(jvars["depth"]),
                    "flow": bridge.liteflownet_from_flax(jvars["flow"])}
    vo.infer_variables = vo.frontend.prepare_variables(vo.variables)
    vo.main()
    return load_poses_from_txt(os.path.join(cfg.directory.result_dir, "07.txt"))


@pytest.fixture(scope="module")
def port_scan(kitti_offset, perturbed, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_scan")
    return _port_main(_cli_cfg(TConfigLoader, kitti_offset, out, "scan"), perturbed), out


def test_dfvo_scan_main_matches_jax(kitti_offset, perturbed, port_scan, tmp_path, monkeypatch):
    """DFVO(cfg).main() in scan execution, 7 tracked frames in chunks of 3
    (the last padded), in both packages on the same weights: every pose
    within 1e-5, and both trajectories start at the GT's first pose."""
    monkeypatch.setattr(JDeepFrontend, "init_variables",
                        lambda self, rng: jax.tree.map(jnp.asarray, perturbed))
    JDFVO(_cli_cfg(ConfigLoader, kitti_offset, tmp_path / "jax", "scan")).main()
    want = load_poses_from_txt(str(tmp_path / "jax" / "07.txt"))
    got, out = port_scan
    assert sorted(got) == sorted(want) == list(range(N_FRAMES))
    np.testing.assert_allclose(want[0], G0, atol=1e-12)
    np.testing.assert_allclose(got[0], G0, atol=1e-12)
    # the compared motion lies far above the tolerance
    rel = [np.linalg.inv(want[i - 1]) @ want[i] for i in range(1, N_FRAMES)]
    assert max(np.linalg.norm(r[:3, 3]) for r in rel) >= 100 * 1e-5
    for i in want:
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, err_msg=f"frame {i}")
    assert (out / "map.png").is_file()


def test_scan_execution_matches_frame_execution(kitti_offset, perturbed, port_scan, tmp_path):
    """The port's two executions on the same sequence: the frame execution
    starts at the identity and the scan execution at the GT's first pose
    G0 (as in the JAX package); apart from that offset the trajectories
    agree within 1e-4 (the batched networks pair frames in another order,
    tests/test_scan_runner.py allows 1e-3)."""
    frame = _port_main(_cli_cfg(TConfigLoader, kitti_offset, tmp_path, "frame"), perturbed)
    scan, _ = port_scan
    np.testing.assert_allclose(frame[0], np.eye(4), atol=1e-12)
    for i in frame:
        np.testing.assert_allclose(scan[i], G0 @ frame[i], atol=1e-4, err_msg=f"frame {i}")


def test_cli_scan_execution_writes_trajectory(kitti_offset, tmp_path):
    """``python -m dfvo_torch.apis.run --device cpu`` with
    ``tpu.execution: scan`` and its own seeded weights: one finite pose per
    frame, the annotated configuration and the trajectory map."""
    from dfvo_torch.apis import run

    result = tmp_path / "result"
    custom = tmp_path / "custom.yml"
    custom.write_text(
        'seq: "07"\n'
        "image: {height: 64, width: 96}\n"
        f"directory: {{img_seq_dir: {kitti_offset / 'odom_data'}, "
        f"gt_pose_dir: {kitti_offset / 'gt_poses'}, result_dir: {result}}}\n"
        "visualization: {enable: True, save_img: False}\n"
        "tpu: {ransac_hypotheses: 32, dtype: float32, execution: scan, scan_chunk: 4}\n"
        # seeded weights send every frame to PnP: 5 x 20 hypotheses, not 5 x 100
        "pnp_tracker: {ransac: {iter: 20}}\n"
    )
    vo = run.main(["-d", DEFAULT_CFG, "-c", str(custom), "--no_confirm", "--device", "cpu"])
    assert vo.tracking_stage == N_FRAMES
    poses = load_poses_from_txt(str(result / "07.txt"))
    assert sorted(poses) == list(range(N_FRAMES))
    assert all(np.isfinite(p).all() for p in poses.values())
    assert "execution: scan  # |CHANGED| default: frame" in (result / "configuration.yml").read_text()
    assert (result / "map.png").is_file()
    assert set(vo.timers.timers) >= {"depth_cnn", "data_loading", "vo_step", "visualization",
                                     "DF-VO"}


# -- (f) the refusals -------------------------------------------------------------

@pytest.mark.parametrize("edit, error, match", [
    (lambda c: c.depth.__setitem__("depth_src", "gt"), ValueError, "depth_src: gt"),
    (lambda c: c.deep_pose.__setitem__("enable", True), ValueError, "deep_pose.enable"),
    (lambda c: setattr(c, "tracking_method", "deep_pose"), ValueError,
     "tracking_method: deep_pose"),
    (lambda c: (c.online_finetune.__setitem__("enable", True),
                c.online_finetune.depth.update(enable=True, pose_src="deep_pose")),
     ValueError, "needs the pose CNN"),
    (lambda c: c.tpu.__setitem__("execution", "sideways"), ValueError, "execution"),
], ids=["depth_src", "deep_pose.enable", "deep_pose", "finetune", "sideways"])
def test_scan_refusals(kitti_offset, tmp_path, edit, error, match):
    cfg = _cli_cfg(TConfigLoader, kitti_offset, tmp_path, "scan")
    edit(cfg)
    with pytest.raises(error, match=match):
        TDFVO(cfg, device="cpu").main()
    assert not (tmp_path / "07.txt").exists()
