"""The port's multi-sequence runs against the JAX package and against the
port's single-sequence calls, on the CPU.

* The three steps of ``dfvo_torch.parallel.MultiSeqRunner`` against the
  JAX package, S = 3 sequences in float32 at 64x96, each with its own
  intrinsics and keys. The JAX ``MultiSeqRunner`` (dfvo_tpu/parallel/
  multiseq.py) maps the single-sequence programs over a mesh of one
  sequence per device: ``infer`` then ``tracking_step`` per sequence (its
  vmap turns PnP's ``lax.cond`` into a select of the same values); the
  scan runner's chunk step per sequence; the finetuning loss's
  ``value_and_grad`` per pair, ``pmean`` over the pairs and one Adam step.
  The reference runs those same JAX programs per sequence, as the port's
  frame-, scan- and finetuning-parity tests compile them
  (tests/test_torch_dfvo.py ``split_jax_step``,
  tests/test_torch_scan.py::test_dfvo_scan_main_matches_jax,
  tests/test_torch_finetune.py::test_update_and_frame_loop_match_jax: the
  same configurations, so the persistent compilation cache serves them),
  and averages the gradients as ``pmean`` does. Weights:
  tests/test_torch_models.py ``seeded_flax_variables`` (no JAX
  initialisation is compiled).
* The batched ``DeepFrontend.infer`` at S = 3 against three single-pair
  calls, and the geometry with [S x 3 x 3] intrinsics against S calls at
  [3 x 3].
* ``python -m dfvo_torch.apis.run_multiseq`` in both executions over three
  synthetic KITTI-layout sequences, against the port's steps chained the
  CLI's way, scored by ``dfvo_torch.apis.eval_odom``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfvo_torch.datasets import datasets as t_datasets
from dfvo_torch.parallel import MultiSeqRunner as TRunner
from dfvo_torch.pipeline import tracking as T_tr
from dfvo_torch.pipeline.frontend import DeepFrontend as TDeepFrontend
from dfvo_torch.pipeline.scan_runner import make_chunk_step as t_chunk_step
from dfvo_torch.synth.oracle import make_oracle_sequence
from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils import prng
from dfvo_tpu.utils import ConfigLoader
from tests.test_torch_dfvo import _frame_cfg, jax_infer, tiny_kitti  # noqa: F401
from tests.test_torch_finetune import (B1, LR, _ft_cfg, _jax_variables, _port_tree,
                                       _port_variables, _rel_err)
from tests.test_torch_scan import _cli_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options/examples/default_configuration.yml")
H, W, S = 64, 96, 3
T = 3  # the scan parity test's chunk (tests/test_torch_scan.py ``_scan_cfg``)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _intrinsics(s):
    """Sequence s's camera: focal lengths and principal point moved per
    sequence, so that a mixed-up sequence axis shows."""
    return np.array([[0.58 * W * (1 + 0.05 * s), 0, 0.5 * W + s],
                     [0, 1.92 * H * (1 - 0.03 * s), 0.5 * H - s], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def inputs():
    """The weights of tests/test_torch_dfvo.py::test_dfvo_main_matches_jax
    (flow biases redrawn, the flow heads x10, so the flows and the poses
    they give lie far above the tolerances) in both packages, and S
    sequences' frames, reference depths and cameras."""
    jvars = jax.tree.map(jnp.asarray, _jax_variables())
    rng = np.random.RandomState(0)
    K = np.stack([_intrinsics(s) for s in range(S)])
    data = {
        "imgs": rng.randint(0, 255, (S, T, H, W, 3)).astype(np.uint8),
        "img_ref": rng.randint(0, 255, (S, H, W, 3)).astype(np.uint8),
        "depth_ref": rng.uniform(1, 40, (S, H, W)).astype(np.float32),
        "K": K, "K_inv": np.linalg.inv(K).astype(np.float32),
    }
    return jvars, _port_variables(jvars), data


def test_vo_step_matches_jax(inputs, tmp_path):
    """One batched VO step of S sequences, each with its own intrinsics and
    its raw key ``fold_in(PRNGKey(0), s)``, against each sequence's JAX
    ``infer`` and ``tracking_step`` (no ``prev_scale``: 1.0, as the JAX
    step passes none; the rigid-flow map on, an extra output, as the
    frame-parity test's program has it): modes equal, poses within 1e-5
    and depths within relative 1e-4 (the frame-step parity of
    tests/test_torch_frontend.py), the motion far above that."""
    from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend
    from dfvo_tpu.pipeline.tracking import TrackingConfig, tracking_step

    jvars, tvars, d = inputs
    jcfg = _frame_cfg(ConfigLoader, tmp_path, tmp_path / "jax")
    jfe = JDeepFrontend(jcfg)
    tcfg = dataclasses.replace(TrackingConfig.from_cfg(jcfg), want_rigid_flow_diff=True)
    infer, pv = jax_infer(jfe), jfe.prepare_variables(jvars)
    keys = prng.fold_in_many(prng.PRNGKey(0), np.arange(S))
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (S, 4, 4))
    jp, jm, jd = [], [], []
    for s in range(S):
        fo = infer(pv, jnp.asarray(d["imgs"][s, 0]).astype(jnp.float32) / 255.0,
                   jnp.asarray(d["img_ref"][s]).astype(jnp.float32) / 255.0)
        tr = tracking_step(jnp.asarray(keys[s]), fo["flow_fwd"], fo["flow_diff"],
                           fo["depth_cur"], jnp.asarray(d["depth_ref"][s]), jnp.asarray(eye[s]),
                           jnp.asarray(d["K"][s]), jnp.asarray(d["K_inv"][s]), tcfg,
                           prev_scale=jnp.asarray(1.0, jnp.float32))
        jp.append(np.asarray(tr["pose"]))
        jm.append(int(tr["mode"]))
        jd.append(np.asarray(fo["depth_cur"]))
    trun = TRunner(_frame_cfg(TConfigLoader, tmp_path, tmp_path / "torch"), device="cpu")
    tp, tm, td = trun.make_vo_step()(
        trun.frontend.prepare_variables(tvars), _t(d["imgs"][:, 0]), _t(d["img_ref"]),
        _t(d["depth_ref"]), _t(eye), keys, _t(d["K"]), _t(d["K_inv"]))
    jp = np.stack(jp)
    assert tm.tolist() == jm
    assert np.abs(jp[:, :3, 3]).max() >= 100 * 1e-5
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.stack(jd), rtol=1e-4)


def test_chunk_step_matches_jax(inputs, tmp_path):
    """One chunk of T = 3 frames of S sequences: the raw keys
    ``fold_in(fold_in(PRNGKey(0), i), s)`` [S x T x 2] of the JAX CLI, each
    sequence's intrinsics and carry, against each sequence's JAX chunk step
    (the scan runner's, one sequence per device in the JAX
    ``MultiSeqRunner``). Modes equal, poses and the carried motion within
    1e-5, the carried depth within relative 1e-4 (the chunk parity of
    tests/test_torch_scan.py), the carried scale within relative 1e-5."""
    from dfvo_tpu.pipeline.scan_runner import ScanRunner as JScanRunner

    jvars, tvars, d = inputs
    base = prng.PRNGKey(0)
    keys = prng.fold_in_many(prng.fold_in_many(base, np.arange(1, T + 1))[None],
                             np.arange(S)[:, None])
    jkeys = jax.vmap(lambda i: jax.vmap(
        lambda s: jax.random.fold_in(jax.random.fold_in(jnp.asarray(base), i), s))(
            jnp.arange(S, dtype=jnp.uint32)))(jnp.arange(1, T + 1)).swapaxes(0, 1)
    np.testing.assert_array_equal(np.asarray(jkeys), keys)
    jscan = JScanRunner(_cli_cfg(ConfigLoader, tmp_path, tmp_path / "jax", "scan"))
    assert jscan.chunk == T
    pv = jscan.frontend.prepare_variables(jvars)
    jp, jm, jc = [], [], []
    for s in range(S):
        p, m, c = jscan._chunk_step(
            pv, jnp.asarray(d["imgs"][s]),
            (jnp.asarray(d["img_ref"][s]), jnp.asarray(d["depth_ref"][s]),
             jnp.eye(4, dtype=jnp.float32), jnp.asarray(1.0, jnp.float32)),
            jkeys[s], jnp.asarray(d["K"][s]), jnp.asarray(d["K_inv"][s]))
        jp.append(np.asarray(p))
        jm.append(np.asarray(m))
        jc.append([np.asarray(x) for x in c])
    jp, jm = np.stack(jp), np.stack(jm)
    jc = [np.stack([c[i] for c in jc]) for i in range(4)]
    trun = TRunner(_cli_cfg(TConfigLoader, tmp_path, tmp_path / "torch", "scan"), device="cpu")
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (S, 4, 4))
    tp, tm, tc = trun.make_chunk_step()(
        trun.frontend.prepare_variables(tvars), _t(d["imgs"]),
        (_t(d["img_ref"]), _t(d["depth_ref"]), _t(eye), np.ones(S, np.float32)), keys,
        _t(d["K"]), _t(d["K_inv"]))
    assert tm.tolist() == jm.tolist()
    assert np.abs(jp[..., :3, 3]).max() >= 100 * 1e-5
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-5)
    np.testing.assert_array_equal(tc[0].numpy(), jc[0])
    np.testing.assert_allclose(tc[1].numpy(), jc[1], rtol=1e-4)
    np.testing.assert_allclose(tc[2].numpy(), jc[2], atol=1e-5)
    np.testing.assert_allclose(tc[3], jc[3], rtol=1e-5)


def test_train_step_matches_jax(inputs, tiny_kitti, tmp_path):
    """One sequence-averaged Adam step over S pairs with flow and depth
    finetuning (tests/test_torch_finetune.py's configuration and camera)
    against the JAX package: its jitted ``update`` per pair gives each
    pair's loss and gradient (the first Adam moment over 1 - b1), their
    means are what the JAX step's ``pmean`` gives, and the JAX optimizer
    takes one step on the mean gradient. The loss within relative 1e-5;
    each network's gradient, as the port's loss gives it, within
    tests/test_torch_finetune.py's bounds by norm (flow 1e-4, depth 1e-3);
    every parameter's step within 2 lr of JAX's and all but 1e-4 of them
    within lr/10 (1e-3 for the depth network, whose gradient turns on
    rounding). The port's gradient is its
    first Adam moment over 1 - b1, as the JAX one."""
    from dfvo_tpu.pipeline.finetune import OnlineFinetuner as JFinetuner
    from dfvo_tpu.pipeline.frontend import DeepFrontend as JDeepFrontend

    jvars, tvars, d = inputs
    jcfg = _ft_cfg(_frame_cfg(ConfigLoader, tiny_kitti, tmp_path / "jax"))
    tcfg = _ft_cfg(_frame_cfg(TConfigLoader, tiny_kitti, tmp_path / "torch"))
    cam = t_datasets[tcfg.dataset](tcfg).cam_intrinsics
    K, K_inv = cam.mat.astype(np.float32), cam.inv_mat.astype(np.float32)
    img_ref = d["img_ref"].astype(np.float32) / 255.0
    img_cur = d["imgs"][:, 0].astype(np.float32) / 255.0
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (S, 4, 4)).copy()
    poses[:, 0, 3] = 0.01 * np.arange(1, S + 1)
    poses[:, 2, 3] = 0.02

    jft = JFinetuner(JDeepFrontend(jcfg), jcfg)
    jstate = jft.init_state(jvars, K, K_inv)
    losses, grads = [], []
    for s in range(S):
        _, (adam, *_), loss = jft.update(jvars, jstate, jnp.asarray(img_ref[s]),
                                         jnp.asarray(img_cur[s]), jnp.asarray(poses[s]))
        losses.append(float(loss))
        grads.append(jax.tree.map(lambda m: np.asarray(m) / np.float32(1 - B1), adam.mu))
    j_grad = jax.tree.map(lambda *g: np.mean(np.stack(g), axis=0), *grads)
    j_step, _ = jax.jit(jft.optimizer.update)(j_grad, jstate, jft._trainable(jvars))

    trun = TRunner(tcfg, device="cpu")
    ft = trun.finetuner
    before = {net: {k: v.clone() for k, v in sd.items()} for net, sd in tvars.items()}
    tnew = {net: {k: v.clone() for k, v in sd.items()} for net, sd in tvars.items()}
    topt = ft.init_state(tnew, K, K_inv)
    np.testing.assert_array_equal(ft._K.numpy(), np.asarray(jft._K))
    tnew, topt, tloss = trun.make_train_step()(tnew, topt, _t(img_ref), _t(img_cur), _t(poses))
    assert topt["count"] == 1
    np.testing.assert_allclose(float(tloss), np.mean(losses), rtol=1e-5)
    for net in ("flow", "depth"):
        jg = _port_tree(net, j_grad[net], jvars)
        js = _port_tree(net, j_step[net], jvars)
        keys = ft.frontend.trainable_keys(net)
        assert set(jg) == set(keys)
        flat = [np.concatenate([topt["mu"][net][k].numpy().ravel() / np.float32(1 - B1)
                                for k in keys]),
                np.concatenate([jg[k].ravel() for k in keys])]
        assert _rel_err(*flat) < (1e-4 if net == "flow" else 1e-3), net
        step_t = np.concatenate([(tnew[net][k] - before[net][k]).numpy().ravel() for k in keys])
        step_j = np.concatenate([js[k].ravel() for k in keys])
        diff = np.abs(step_t - step_j)
        assert np.abs(step_j).max() > 0.5 * LR, net
        # Adam's first step is about lr·sign(g): a gradient near zero whose
        # sign turns on rounding is 2 lr off (tests/test_torch_finetune.py
        # ``_check_update``; measured here 1.16 lr for one flow element)
        assert diff.max() <= 2 * LR, net
        assert np.mean(diff <= 0.1 * LR) >= (1 - 1e-4 if net == "flow" else 1 - 1e-3), net


# -- the batched frontend and the per-sequence geometry --------------------------

@pytest.mark.parametrize("network", ["liteflow", "hd3"])
def test_batched_infer_equals_single_pairs(network):
    """``infer`` on S = 3 pairs (LiteFlowNet's ``shared`` mode with img1 =
    [ref_0..ref_2, cur_2..cur_0]) against three single-pair calls:
    LiteFlowNet's flows equal, depths within relative 1e-5 (the batched
    convolution's sums), HD3's flows (a pixel or two, with the classifiers
    of tests/test_torch_hd3_pipeline.py) within 1e-4 px."""
    cfg = TConfigLoader().merge_cfg([DEFAULT_CFG])
    cfg.image.height, cfg.image.width = H, W
    cfg.tpu.dtype = "float32"
    cfg.deep_flow.network = network
    fe = TDeepFrontend(cfg, "cpu")
    if network == "hd3":  # flows of a pixel or two (tests/test_torch_hd3_pipeline.py)
        from tests.test_torch_hd3_pipeline import hd3_variables

        variables = fe.prepare_variables(hd3_variables(0.3, 4.0)[1])
    else:
        variables = fe.prepare_variables(fe.init_variables(torch.Generator().manual_seed(0)))
    rng = np.random.RandomState(1)
    cur, ref = (_t(rng.rand(3, H, W, 3).astype(np.float32)) for _ in range(2))
    got = fe.infer(variables, cur, ref)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "depth_cur": (3, H, W), "flow_fwd": (3, H, W, 2), "flow_bwd": (3, H, W, 2),
        "flow_diff": (3, H, W)}
    for s in range(3):
        one = fe.infer(variables, cur[s], ref[s])
        torch.testing.assert_close(got["depth_cur"][s], one["depth_cur"], rtol=1e-5, atol=0)
        for k in ("flow_fwd", "flow_bwd", "flow_diff"):
            if network == "liteflow":
                assert torch.equal(got[k][s], one[k]), (s, k)
            else:
                torch.testing.assert_close(got[k][s], one[k], atol=1e-4, rtol=0)


E, PNP, CONST = T_tr.TRACK_MODE_ESSENTIAL, T_tr.TRACK_MODE_PNP, T_tr.TRACK_MODE_CONST


@pytest.mark.parametrize("options, modes", [
    ("simple", [E, PNP, CONST]),
    ("iterative", [E, PNP, CONST]),
    # the x30 depth fails the consistency check everywhere: no good keypoint
    ("depth_consistency", [E, CONST, CONST]),
])
def test_geometry_takes_per_sequence_intrinsics(options, modes):
    """``tracking_step`` over a leading sequence axis with [S x 3 x 3]
    intrinsics (three oracle scenes, one camera each: E tracking, a scale
    that fails and falls to PnP, random flow with no good keypoint) against
    one call per sequence at [3 x 3]: simple scale; the iterative scale and
    the E and PnP trackers' iterative keypoints; depth consistency from the
    scenes' poses. Modes, keypoints and inliers equal (with iterative
    keypoints, the inlier counts within 10 %); poses and scales
    within 1e-5 and the rigid-flow map within 1e-4 px (batched float32
    products; 1e-2 px after the noise-picked keypoints)."""
    tcfg = T_tr.TrackingConfig(height=H, width=W, num_hypotheses=32,
                               want_rigid_flow_diff=True)
    if options == "iterative":
        tcfg = dataclasses.replace(tcfg, scale_method="iterative", e_iterative_kp=True,
                                   pnp_iterative_kp=True, scale_iterative_kp=True)
    if options == "depth_consistency":
        tcfg = dataclasses.replace(tcfg, depth_consistency=True)
    scenes = []
    for s in range(3):
        # the oracle's third pair (its first ones go to PnP, tests/test_torch_scan.py)
        depths, flows, motions = make_oracle_sequence(H, W, _intrinsics(s), 4, seed=s, speed=2.0)
        flow, dcur, dref = flows[2], depths[3], depths[2]
        fd = np.full((H, W), 0.01, np.float32)
        if s == 1:
            dcur = dcur * 30.0  # past max_depth: the scale fails, PnP takes the frame
        if s == 2:
            flow = np.random.RandomState(0).randn(H, W, 2).astype(np.float32)
            fd = np.ones((H, W), np.float32)
        scenes.append((flow, fd, dcur, dref, motions[2]))
    K = np.stack([_intrinsics(s) for s in range(3)])
    K_inv = np.linalg.inv(K).astype(np.float32)
    keys = prng.fold_in_many(prng.PRNGKey(0), np.arange(3))
    prev = np.eye(4, dtype=np.float32)
    prev[2, 3] = 0.7
    stack = [_t(np.stack([sc[j] for sc in scenes])) for j in range(5)]
    got = T_tr.tracking_step(_t(prng.split_step_keys(keys).astype(np.int64)), *stack[:4],
                             _t(np.broadcast_to(prev, (3, 4, 4))), _t(K), _t(K_inv), tcfg,
                             deep_pose=stack[4].float())
    assert got["mode"].tolist() == modes
    for s, sc in enumerate(scenes):
        want = T_tr.tracking_step(keys[s], *[_t(a) for a in sc[:4]], _t(prev), _t(K[s]),
                                  _t(K_inv[s]), tcfg, deep_pose=_t(sc[4]).float())
        for name, w in want.items():
            g = got[name][s]
            if name == "inliers" and options == "iterative":
                # the rigid-flow keypoints of an exact scene pick pixels by
                # rounding noise (ROADMAP queue 3): counts within 10 %
                assert abs(int(g.sum()) - int(w.sum())) <= 0.1 * int(w.sum()), s
            elif w.dtype in (torch.bool, torch.int64):
                assert torch.equal(g, w), f"sequence {s}: {name}"
            else:  # the rigid-flow map in px through batched products: 1e-4
                # (1e-2 where the PnP pose comes from the noise-picked
                # keypoints: measured 1.9e-3 with one thread)
                tol = 1e-5
                if name == "rigid_flow_diff":
                    tol = 1e-2 if options == "iterative" else 1e-4
                torch.testing.assert_close(g, w, atol=tol, rtol=1e-5,
                                           msg=f"sequence {s}: {name}")


# -- the CLI -------------------------------------------------------------------

SEQS = ["00", "01", "02"]
CLI_FRAMES, CLI_CHUNK = 3, 3  # scan: one chunk of 3 with a padded frame


@pytest.fixture(scope="module")
def kitti3(tmp_path_factory):
    """Three KITTI-odometry-layout sequences (tests/test_multiseq.py's:
    crops of one blurred noise image panning 10 px per frame, offset per
    sequence; calib.txt; GT poses), each with its own focal length."""
    import cv2

    root = tmp_path_factory.mktemp("kitti_multiseq")
    gt_dir = root / "gt_poses"
    gt_dir.mkdir()
    rng = np.random.RandomState(0)
    big = cv2.GaussianBlur((rng.rand(500, 1500, 3) * 255).astype(np.uint8), (0, 0), 3)
    for s_i, s in enumerate(SEQS):
        img_dir = root / "odom_data" / s / "image_2"
        img_dir.mkdir(parents=True)
        lines = []
        for i in range(CLI_FRAMES + 1):
            y = 50 + 5 * s_i
            cv2.imwrite(str(img_dir / f"{i:06d}.jpg"), big[y : y + 370, 10 * i : 10 * i + 1226])
            P = np.eye(4)
            P[0, 3] = 0.1 * i
            lines.append(" ".join(str(v) for v in P.flatten()[:12]))
        (gt_dir / f"{s}.txt").write_text("\n".join(lines) + "\n")
        f = 707.09 + 20.0 * s_i
        (root / "odom_data" / s / "calib.txt").write_text("\n".join(
            f"P{j}: {f} 0.0 601.88 0.0 0.0 {f} 183.11 0.0 0.0 0.0 1.0 0.0"
            for j in range(4)) + "\n")
    return root


def _chain_steps(run, execution):
    """The CLI's trajectories recomputed from the runner's steps on the
    same frames and keys (the CLI's rules), chained in float64."""
    from dfvo_torch.utils.native_loader import make_prefetcher

    cfg, n = run.cfg, run.n_frames
    frames = []
    for d in run.datasets:  # decoded as the CLI decodes them
        loader = make_prefetcher([d.get_image_path(d.get_timestamp(i)) for i in range(n)], H, W)
        frames.append(np.stack([loader.next()[1] for _ in range(n)]))
        loader.close()
    frames = np.stack(frames)
    fe, variables, nseq = run.runner.frontend, run.variables, len(SEQS)
    from dfvo_torch.pipeline.dfvo import depth_only

    depth0 = depth_only(fe, variables, _t(frames[:, 0]))
    eye = torch.eye(4).expand(nseq, 4, 4)
    rel = np.zeros((nseq, n, 4, 4))
    base = prng.PRNGKey(cfg.seed)
    if execution == "frame":
        step, prev, dref = run.runner.make_vo_step(), eye, depth0
        for i in range(1, n):
            keys = prng.fold_in_many(base, np.arange(i * nseq, (i + 1) * nseq))
            prev, _, dref = step(variables, _t(frames[:, i]), _t(frames[:, i - 1]), dref, prev,
                                 keys, run.K, run.K_inv)
            rel[:, i] = prev.double().numpy()
    else:  # chunks of CLI_CHUNK frames, the last padded; per sequence through scan_runner
        chunk_step, _ = t_chunk_step(fe, run.runner.tcfg)
        for s in range(nseq):
            carry = (_t(frames[s, 0]), depth0[s], torch.eye(4), np.float32(1.0))
            for start in range(1, n, CLI_CHUNK):
                ids = list(range(start, min(start + CLI_CHUNK, n)))
                pad = ids + [ids[-1]] * (CLI_CHUNK - len(ids))
                keys = prng.fold_in_many(prng.fold_in_many(base, np.array(pad)), s)
                poses, _, carry = chunk_step(variables, _t(frames[s, pad]), carry,
                                             _t(prng.split_step_keys(keys).astype(np.int64)),
                                             run.K[s], run.K_inv[s])
                rel[s, ids] = poses.double().numpy()[: len(ids)]
    trajs = []
    for s in range(nseq):
        traj, P = [np.eye(4)], np.eye(4)
        for i in range(1, n):
            P = P @ rel[s, i]
            traj.append(P)
        trajs.append(np.stack(traj))
    return trajs


@pytest.mark.parametrize("execution", ["frame", "scan"])
def test_cli_tracks_each_sequence(kitti3, tmp_path, execution):
    """``python -m dfvo_torch.apis.run_multiseq --device cpu`` over the three
    sequences (``--max_frames 3``; scan: one chunk of 3 with a padded
    frame): one finite trajectory of 3 poses per sequence, equal within
    1e-9 to the
    port's steps on the same frames and keys chained the CLI's way, and
    ``python -m dfvo_torch.apis.eval_odom`` scores them."""
    from dfvo_torch.apis import eval_odom, run_multiseq
    from dfvo_torch.utils.io import load_poses_from_txt

    custom = tmp_path / "custom.yml"
    custom.write_text(
        f"image:\n    height: {H}\n    width: {W}\n"
        f"directory:\n    img_seq_dir: {kitti3 / 'odom_data'}\n"
        f"    gt_pose_dir: {kitti3 / 'gt_poses'}\n    result_dir: {tmp_path / 'result'}\n"
        f"tpu:\n    ransac_hypotheses: 32\n    dtype: float32\n    execution: {execution}\n"
        f"    scan_chunk: {CLI_CHUNK}\n"
        # random weights send every frame to PnP: 5 x 20 hypotheses, not 5 x 100
        "pnp_tracker:\n    ransac:\n        iter: 20\n")
    run = run_multiseq.main(["-d", DEFAULT_CFG, "-c", str(custom), "--seqs", *SEQS,
                             "--max_frames", str(CLI_FRAMES), "--device", "cpu"])
    assert run.n_frames == CLI_FRAMES
    # per-sequence intrinsics reach the steps
    assert len({float(k) for k in run.K[:, 0, 0]}) == len(SEQS)
    want = _chain_steps(run, execution)
    for s, name in enumerate(SEQS):
        got = load_poses_from_txt(str(tmp_path / "result" / f"{name}.txt"))
        assert sorted(got) == list(range(CLI_FRAMES))
        assert all(np.isfinite(p).all() for p in got.values())
        # the file holds each pose's str(float64): exact
        np.testing.assert_allclose(np.stack([got[i] for i in range(CLI_FRAMES)]), want[s],
                                   atol=1e-9, err_msg=name)
    eval_odom.main(["--result", str(tmp_path / "result"), "--gt", str(kitti3 / "gt_poses"),
                    "--align", "6dof", "--seqs", *SEQS])
    assert (tmp_path / "result" / "result.txt").exists()


def test_cli_defaults_to_cuda_and_raises_without_it(kitti3, monkeypatch):
    from dfvo_torch.apis import run_multiseq

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_multiseq.main(["-d", DEFAULT_CFG, "--seqs", *SEQS])
