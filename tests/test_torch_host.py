"""The port's host side against the JAX package's, on the same inputs, with
no JAX compile: file IO, the saved configuration, the KITTI loaders, the
KITTI evaluation, the flow colouring, the drawer, the frame prefetchers,
checkpoint loading, and the frame loop's refusals and its gt-depth path.
Numpy and cv2 work is compared exactly; the evaluation to 1e-9.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from dfvo_torch.utils import ConfigLoader as TConfigLoader
from dfvo_torch.utils import io as T_io
from dfvo_tpu.utils import ConfigLoader
from dfvo_tpu.utils import io as J_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "options/examples/default_configuration.yml")
RAW_SEQ = "2011_09_26_drive_0001_sync"


def _rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def _poses(rng, n, step=1.0):
    """A drive of ``n`` poses: small random turns (Rodrigues) and about
    ``step`` metres forward per frame."""
    poses, P = {}, np.eye(4)
    for i in range(n):
        poses[i] = P.copy()
        w = 0.01 * rng.randn(3)
        S = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        th = np.linalg.norm(w)
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(th) / th * S + (1 - np.cos(th)) / th**2 * S @ S
        T[:3, 3] = [0.05 * rng.randn(), 0.02 * rng.randn(), step]
        P = P @ T
    return poses


def _write_image(path, rng, h=120, w=400):
    img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8), (0, 0), 2)
    cv2.imwrite(str(path), img)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """A KITTI odometry sequence (07) and a KITTI raw drive, 4 frames each,
    with GT depth PNGs for both."""
    root = tmp_path_factory.mktemp("kitti_host")
    rng = np.random.RandomState(0)
    odom = root / "odom" / "07"
    (odom / "image_2").mkdir(parents=True)
    (root / "gt_poses").mkdir()
    (root / "depth" / "gt" / "07").mkdir(parents=True)
    raw_day = root / "raw" / RAW_SEQ[:10]
    (raw_day / RAW_SEQ / "image_02" / "data").mkdir(parents=True)
    oxts = root / "oxts" / RAW_SEQ[:10] / RAW_SEQ / "oxts" / "data"
    oxts.mkdir(parents=True)
    (root / "rawdepth" / RAW_SEQ).mkdir(parents=True)
    lines = []
    for i in range(4):
        _write_image(odom / "image_2" / f"{i:06d}.jpg", rng)
        _write_image(raw_day / RAW_SEQ / "image_02" / "data" / f"{i:010d}.png", rng)
        depth = (rng.uniform(5.0, 40.0, (120, 400)) * 500).astype(np.uint16)
        cv2.imwrite(str(root / "depth" / "gt" / "07" / f"{i:010d}.png"), depth)
        cv2.imwrite(str(root / "rawdepth" / RAW_SEQ / f"{i:010d}.png"), depth)
        P = np.eye(4)
        P[:3, 3] = [0.1 * i, 0.01 * i, 0.5 * i]
        lines.append(" ".join(str(v) for v in P.flatten()[:12]))
        vals = [49.0 + 1e-5 * i, 8.4 + 2e-5 * i, 110.0 + 0.01 * i, 0.01 * i, -0.02 * i,
                0.5 + 0.03 * i] + [0.0] * 24
        (oxts / f"{i:010d}.txt").write_text(" ".join(str(v) for v in vals) + "\n")
    (root / "gt_poses" / "07.txt").write_text("\n".join(lines) + "\n")
    (odom / "calib.txt").write_text("\n".join(
        f"P{j}: 707.09 0.0 601.88 {-j * 10.0} 0.0 707.09 183.11 0.0 0.0 0.0 1.0 0.0"
        for j in range(4)) + "\n")
    (raw_day / "calib_cam_to_cam.txt").write_text(
        "calib_time: 09-Jan-2012 13:57:47\n"
        + "".join(f"P_rect_0{j}: 721.5 0.0 609.5 {-j * 40.0} 0.0 721.5 172.8 0.0 0.0 0.0 1.0 0.0\n"
                  for j in range(4)))
    return root


def _cfg(loader, root, dataset="kitti_odom", depth_src=None, h=64, w=96):
    cfg = loader().merge_cfg([DEFAULT_CFG])
    cfg.dataset = dataset
    cfg.image.height, cfg.image.width = h, w
    cfg.depth.depth_src = depth_src
    if dataset == "kitti_odom":
        cfg.seq = "07"
        cfg.directory.img_seq_dir = str(root / "odom")
        cfg.directory.gt_pose_dir = str(root / "gt_poses")
        cfg.directory.depth_dir = str(root / "depth")
    else:
        cfg.seq = RAW_SEQ
        cfg.image.ext = "png"
        cfg.directory.img_seq_dir = str(root / "raw")
        cfg.directory.gt_pose_dir = str(root / "oxts")
        cfg.directory.depth_dir = str(root / "rawdepth")
    cfg.directory.result_dir = str(root / "result")
    cfg.visualization.enable = False
    cfg.tpu.ransac_hypotheses = 32
    cfg.tpu.dtype = "float32"
    return cfg


# -- io ------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["kitti", "tum"])
def test_pose_files_round_trip_like_jax(tmp_path, fmt):
    from dfvo_torch.geometry.camera import SE3

    poses = _poses(np.random.RandomState(1), 6)
    se3 = {i: SE3(p) for i, p in poses.items()}
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    T_io.save_traj(str(got), T_io.convert_SE3_to_arr(se3), format=fmt)
    J_io.save_traj(str(want), J_io.convert_SE3_to_arr(se3), format=fmt)
    assert got.read_text() == want.read_text()
    load_t = T_io.load_poses_from_txt if fmt == "kitti" else T_io.load_poses_from_txt_tum
    load_j = J_io.load_poses_from_txt if fmt == "kitti" else J_io.load_poses_from_txt_tum
    back, ref = load_t(str(got)), load_j(str(want))
    assert list(back) == list(ref)
    for k in back:
        np.testing.assert_array_equal(back[k], ref[k])
    if fmt == "kitti":  # the file holds the poses themselves
        for k in poses:
            np.testing.assert_array_equal(back[k], poses[k])


def test_quaternions_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(20):
        R = _rotation(rng)
        q = T_io.rot2quat(R)
        np.testing.assert_array_equal(q, J_io.rot2quat(R))
        np.testing.assert_array_equal(T_io.quat2mat(q), J_io.quat2mat(q))
        np.testing.assert_allclose(T_io.quat2mat(q), R, atol=1e-12)


def test_intrinsics_loaders_match_jax(layouts):
    odom = str(layouts / "odom" / "07" / "calib.txt")
    raw = str(layouts / "raw" / RAW_SEQ[:10] / "calib_cam_to_cam.txt")
    assert T_io.load_kitti_odom_intrinsics(odom, 192, 640) == \
        J_io.load_kitti_odom_intrinsics(odom, 192, 640)
    assert T_io.load_kitti_raw_intrinsics(raw, 192, 640) == \
        J_io.load_kitti_raw_intrinsics(raw, 192, 640)


def test_image_and_depth_readers_match_jax(layouts):
    jpg = str(layouts / "odom" / "07" / "image_2" / "000001.jpg")
    got = T_io.read_image(jpg, 64, 96)
    np.testing.assert_array_equal(got, J_io.read_image(jpg, 64, 96))
    want = cv2.resize(cv2.cvtColor(cv2.imread(jpg, 1), cv2.COLOR_BGR2RGB), (96, 64))
    np.testing.assert_array_equal(got, want)
    crop = [[0.2, 0.9], [0.1, 1.0]]
    np.testing.assert_array_equal(T_io.read_image(jpg, 32, 48, crop),
                                  J_io.read_image(jpg, 32, 48, crop))
    png = str(layouts / "depth" / "gt" / "07" / "0000000002.png")
    depth = T_io.read_depth(png, 500, [64, 96])
    np.testing.assert_array_equal(depth, J_io.read_depth(png, 500, [64, 96]))
    np.testing.assert_array_equal(
        T_io.preprocess_depth(depth, [[0.3, 1.0], [0.0, 1.0]], (0, 30)),
        J_io.preprocess_depth(depth, [[0.3, 1.0], [0.0, 1.0]], (0, 30)))
    with pytest.raises(FileNotFoundError):
        T_io.read_image(str(layouts / "missing.jpg"), 64, 96)


# -- configuration ---------------------------------------------------------

def test_save_cfg_matches_jax(tmp_path):
    custom = tmp_path / "custom.yml"
    custom.write_text('seq: "07"\nimage: {height: 64}\ntpu: {dtype: float32}\n'
                      "visualization: {flow: {vis_rigid_diff: False}}\n")
    files = [DEFAULT_CFG, str(custom)]
    TConfigLoader().save_cfg(files, str(tmp_path / "port" / "configuration.yml"))
    ConfigLoader().save_cfg(files, str(tmp_path / "jax" / "configuration.yml"))
    got = (tmp_path / "port" / "configuration.yml").read_text()
    assert got == (tmp_path / "jax" / "configuration.yml").read_text()
    assert "height: 64  # |CHANGED| default: 192" in got
    assert "vis_rigid_diff: false  # |CHANGED| default: True" in got


# -- datasets ----------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["kitti_odom", "kitti_raw"])
def test_kitti_loaders_match_jax(layouts, tmp_path, dataset):
    from dfvo_torch.datasets import datasets as t_registry
    from dfvo_tpu.datasets import datasets as j_registry

    got = t_registry[dataset](_cfg(TConfigLoader, layouts, dataset, depth_src="gt"))
    want = j_registry[dataset](_cfg(ConfigLoader, layouts, dataset, depth_src="gt"))
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got.cam_intrinsics.mat, want.cam_intrinsics.mat)
    assert got.data_dir == want.data_dir
    assert list(got.gt_poses) == list(want.gt_poses)
    for k in got.gt_poses:
        np.testing.assert_array_equal(got.gt_poses[k], want.gt_poses[k])
    for i in range(4):
        ts = got.get_timestamp(i)
        assert ts == want.get_timestamp(i)
        assert got.get_image_path(ts) == want.get_image_path(ts)
        np.testing.assert_array_equal(got.get_image(ts), want.get_image(ts))
        np.testing.assert_array_equal(got.get_depth(ts), want.get_depth(ts))

    from dfvo_torch.geometry.camera import SE3

    traj = {i: SE3(p) for i, p in _poses(np.random.RandomState(3), 4).items()}
    got.save_result_traj(str(tmp_path / "port.txt"), traj)
    want.save_result_traj(str(tmp_path / "jax.txt"), traj)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_unported_datasets_name_their_item(layouts):
    from dfvo_torch.datasets import datasets as t_registry

    for name in ("tum-1", "tum-2", "tum-3", "adelaide1", "adelaide2", "kinect", "robotcar"):
        cfg = _cfg(TConfigLoader, layouts)
        cfg.dataset = name
        with pytest.raises(NotImplementedError, match="item 13"):
            t_registry[name](cfg)


# -- evaluation --------------------------------------------------------------

@pytest.mark.parametrize("alignment", [None, "scale", "scale_7dof", "7dof", "6dof"])
def test_eval_seq_matches_jax(alignment):
    from dfvo_torch.evaluation import KittiEvalOdom as TEval
    from dfvo_tpu.evaluation import KittiEvalOdom as JEval

    rng = np.random.RandomState(4)
    gt = _poses(rng, 260, step=1.0)  # 260 m: segments of 100 and 200 m
    pred = _poses(rng, 260, step=0.9)
    got = TEval().eval_seq(gt, pred, alignment)
    want = JEval().eval_seq(gt, pred, alignment)
    assert len(got["seq_err"]) > 0
    for key in ("t_err_percent", "r_err_deg_per_100m", "ate", "rpe_m", "rpe_deg", "seq_len"):
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(np.asarray(got["seq_err"]), np.asarray(want["seq_err"]),
                               rtol=1e-9, atol=1e-12)
    assert got["segment_errs"].keys() == want["segment_errs"].keys()


def test_eval_writes_the_summary_like_jax(tmp_path):
    from dfvo_torch.evaluation import KittiEvalOdom as TEval
    from dfvo_tpu.evaluation import KittiEvalOdom as JEval

    rng = np.random.RandomState(5)
    for name in ("gt", "port", "jax"):
        (tmp_path / name).mkdir()
    J_io.save_traj(str(tmp_path / "gt" / "07.txt"), _poses(rng, 150))
    pred = _poses(rng, 150, step=1.1)
    for name in ("port", "jax"):
        J_io.save_traj(str(tmp_path / name / "07.txt"), pred)
    TEval().eval(str(tmp_path / "gt"), str(tmp_path / "port"), alignment="7dof")
    JEval().eval(str(tmp_path / "gt"), str(tmp_path / "jax"), alignment="7dof")
    for f in ("result.txt", "errors/07.txt"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()


# -- flow colouring and the drawer -----------------------------------------

def test_flow_to_image_matches_jax():
    from dfvo_torch.flowlib import flow_to_image as t_fti
    from dfvo_tpu.flowlib import flow_to_image as j_fti

    rng = np.random.RandomState(6)
    flow = (rng.randn(48, 80, 2) * 5).astype(np.float32)
    flow[3, 4] = [1e8, 0.0]  # unknown flow
    flow[5, 6] = [np.nan, 1.0]
    np.testing.assert_array_equal(t_fti(flow), j_fti(flow))
    np.testing.assert_array_equal(t_fti(np.zeros((8, 8, 2))), j_fti(np.zeros((8, 8, 2))))


class _FakeVO:
    """What the drawer reads from a DFVO."""

    def __init__(self, cfg, gt_poses):
        self.cfg = cfg
        self.dataset = type("D", (), {"gt_poses": gt_poses})()
        self.global_poses = {}
        self.cur_data, self.ref_data = {}, {}
        self.tracking_mode = "PnP"


def test_drawer_draws_a_frame_without_keypoints(layouts, tmp_path):
    """A frame whose flow passes no forward-backward check (HD3 with seeded
    weights at 192x640 on the card) has no valid keypoint: the port's
    drawer shows the two images side by side without matches, where the
    JAX package's ``draw_match_side`` raises an IndexError."""
    from dfvo_torch.geometry.camera import SE3
    from dfvo_torch.pipeline.frame_drawer import FrameDrawer as TDrawer
    from dfvo_torch.pipeline.frame_drawer import draw_match_side
    from dfvo_tpu.pipeline.frame_drawer import draw_match_side as j_draw_match_side

    rng = np.random.RandomState(8)
    h, w, n = 64, 96, 50
    frames = (rng.rand(2, h, w, 3) * 255).astype(np.uint8)
    none = np.zeros((0, 2), np.float32)
    for inliers in (None, np.zeros(0, bool)):
        side = draw_match_side(frames[0], none, frames[1], none, 200, inliers)
        np.testing.assert_array_equal(side, np.hstack([frames[0][..., ::-1],
                                                       frames[1][..., ::-1]]))
    with pytest.raises(IndexError):
        j_draw_match_side(frames[0], none, frames[1], none, 200)

    cfg = _cfg(TConfigLoader, layouts)
    cfg.visualization.enable = True
    cfg.visualization.kp_match.vis_side.inlier_plot = True
    cfg.directory.result_dir = str(tmp_path)
    drawer = TDrawer(cfg)
    vo = _FakeVO(cfg, {})
    vo.ref_data["img"], vo.global_poses[1] = frames[0], SE3(np.eye(4))
    vo.cur_data.update(id=1, img=frames[1])
    out = {"kp_ref": (rng.rand(n, 2) * [w, h]).astype(np.float32),
           "kp_cur": (rng.rand(n, 2) * [w, h]).astype(np.float32),
           "kp_valid": np.zeros(n, bool), "inliers": np.zeros(n, bool),
           "depth_cur": rng.uniform(0.0, 40.0, (h, w)).astype(np.float32),
           "flow_fwd": rng.randn(h, w, 2).astype(np.float32),
           "flow_bwd": rng.randn(h, w, 2).astype(np.float32),
           "flow_diff": rng.rand(h, w).astype(np.float32) + 1.0,
           "rigid_flow_diff": rng.rand(h, w).astype(np.float32),
           "mode": np.asarray(0)}
    drawer.draw_frame(vo, out)
    assert drawer.img is not None and (tmp_path / "img" / "000001.jpg").is_file()


def test_drawer_pixels_match_jax(layouts, tmp_path):
    from dfvo_torch.geometry.camera import SE3
    from dfvo_torch.pipeline.frame_drawer import FrameDrawer as TDrawer
    from dfvo_tpu.pipeline.frame_drawer import FrameDrawer as JDrawer

    cfgs = {}
    for name, loader in (("port", TConfigLoader), ("jax", ConfigLoader)):
        cfg = _cfg(loader, layouts)
        cfg.visualization.enable = True
        cfg.directory.result_dir = str(tmp_path / name)
        cfgs[name] = cfg
    rng = np.random.RandomState(7)
    # a drive long enough for the map to zoom out
    traj = _poses(rng, 40, step=20.0)
    gt = _poses(rng, 40, step=19.0)
    h, w, n = 64, 96, 50
    frames = (rng.rand(2, h, w, 3) * 255).astype(np.uint8)
    out = {
        "kp_ref": (rng.rand(n, 2) * [w, h]).astype(np.float32),
        "kp_cur": (rng.rand(n, 2) * [w, h]).astype(np.float32),
        "kp_valid": rng.rand(n) > 0.3,
        "inliers": rng.rand(n) > 0.5,
        "depth_cur": rng.uniform(0.0, 40.0, (h, w)).astype(np.float32),
        "flow_fwd": rng.randn(h, w, 2).astype(np.float32),
        "flow_bwd": rng.randn(h, w, 2).astype(np.float32),
        "flow_diff": rng.rand(h, w).astype(np.float32),
        "rigid_flow_diff": rng.rand(h, w).astype(np.float32) * 6,
        "mode": np.asarray(2),
    }
    drawers = {"port": TDrawer(cfgs["port"]), "jax": JDrawer(cfgs["jax"])}
    for name, drawer in drawers.items():
        vo = _FakeVO(cfgs[name], gt)
        vo.ref_data["img"] = frames[0]
        for i in range(40):
            vo.global_poses[i] = SE3(traj[i])
            vo.cur_data.update(id=i, img=frames[1])
            if i == 39:
                # cv2.drawMatches colours the side-by-side matches from
                # cv2's global generator
                cv2.setRNGSeed(0)
                drawer.draw_frame(vo, out)
            else:
                drawer.draw_traj(vo)
        drawer.save_traj_map(str(tmp_path / f"{name}_map.png"))
    assert drawers["port"].draw_scale < 1.0  # the map zoomed out
    np.testing.assert_array_equal(drawers["port"].img, drawers["jax"].img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port_map.png")),
                                  cv2.imread(str(tmp_path / "jax_map.png")))
    assert (tmp_path / "port" / "img" / "000039.jpg").is_file()


# -- frame prefetchers -------------------------------------------------------

def test_prefetchers_match_jax_and_cv2(layouts):
    from dfvo_torch.utils import native_loader as T_nl
    from dfvo_tpu.utils import native_loader as J_nl

    paths = [str(layouts / "odom" / "07" / "image_2" / f"{i:06d}.jpg") for i in range(4)]
    native = T_nl.make_prefetcher(paths, 64, 96)
    assert native.name == "native", T_nl._lib_error
    assert T_nl.library_path().parent == T_nl.BUILD_DIR
    assert T_nl.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    want = J_nl.NativeFramePrefetcher(paths, 64, 96)
    threaded = T_nl.ThreadedFramePrefetcher(paths, 64, 96)
    assert threaded.name == "cv2-thread"
    for i in range(4):
        idx, img = native.next()
        assert idx == i
        np.testing.assert_array_equal(img, want.next()[1])
        idx, img = threaded.next()
        assert idx == i
        np.testing.assert_array_equal(img, T_io.read_image(paths[i], 64, 96))
    assert native.next() == (None, None) and threaded.next() == (None, None)
    for p in (native, want, threaded):
        p.close()


def test_prefetcher_names_what_is_missing(monkeypatch):
    from dfvo_torch.utils import native_loader as T_nl

    monkeypatch.setattr(T_nl, "load_library", lambda: None)
    monkeypatch.setattr(T_nl, "_lib_error", "g++ failed: jpeglib.h: No such file")
    monkeypatch.setattr(T_nl, "_has_cv2", lambda: False)
    with pytest.raises(RuntimeError, match=r"jpeglib\.h.*cv2 \(not installed\)"):
        T_nl.make_prefetcher(["a.jpg"], 8, 8)


def test_timer_scopes_and_means():
    from dfvo_torch.utils.timer import Timer

    timer = Timer()
    for _ in range(3):
        with timer.scope("vo step", "DF-VO"):
            pass
    timer.start("DF-VO")
    with pytest.raises(RuntimeError, match="started already"):
        timer.start("DF-VO")
    timer.end("DF-VO")
    means = timer.time_analysis()
    assert set(means) == {"vo step", "DF-VO"} and len(timer.timers["vo step"]["times"]) == 3
    assert timer.timers["vo step"]["group"] == "DF-VO"


# -- the frame loop ------------------------------------------------------------

def test_load_variables_reads_zoo_checkpoints(tmp_path):
    """Monodepth2's encoder.pth/depth.pth and LiteFlowNet's weights load
    straight into the modules' names; a mismatched checkpoint raises."""
    from dfvo_torch.pipeline.frontend import DeepFrontend

    cfg = TConfigLoader().merge_cfg([DEFAULT_CFG])
    fe = DeepFrontend(cfg, "cpu")
    zoo = fe.init_variables(torch.Generator().manual_seed(11))
    enc = {k[len("encoder."):]: v for k, v in zoo["depth"].items() if k.startswith("encoder.")}
    enc["encoder.fc.weight"] = torch.zeros(1000, 512)  # the classifier is left out
    enc["height"] = 192
    dec = {k[len("decoder."):]: v for k, v in zoo["depth"].items() if k.startswith("decoder.")}
    torch.save(enc, tmp_path / "encoder.pth")
    torch.save(dec, tmp_path / "depth.pth")
    torch.save({"module." + k: v for k, v in zoo["flow"].items()}, tmp_path / "lfn.pytorch")
    cfg.depth.deep_depth.pretrained_model = str(tmp_path)
    cfg.deep_flow.flow_net_weight = str(tmp_path / "lfn.pytorch")
    got = DeepFrontend(cfg, "cpu").load_variables(torch.Generator().manual_seed(0))
    for net in ("depth", "flow"):
        assert got[net].keys() == zoo[net].keys()
        assert all(torch.equal(got[net][k], zoo[net][k]) for k in zoo[net])
    dec.pop("decoder.13.conv.bias")
    torch.save(dec, tmp_path / "depth.pth")
    with pytest.raises(ValueError, match="missing"):
        DeepFrontend(cfg, "cpu").load_variables(torch.Generator().manual_seed(0))


def test_dfvo_defaults_to_cuda_and_raises_without_it(layouts, monkeypatch):
    from dfvo_torch.pipeline.dfvo import DFVO

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DFVO(_cfg(TConfigLoader, layouts))


def test_state_checkpoints_name_their_item(tmp_path):
    from dfvo_torch.pipeline.dfvo import DFVO

    vo = object.__new__(DFVO)
    with pytest.raises(NotImplementedError, match="item 11"):
        vo.save_state(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 11"):
        vo.load_state(str(tmp_path))


def test_gt_depth_never_runs_the_depth_net(layouts, tmp_path):
    """depth_src: gt feeds the dataset's depths to the step and never calls
    the depth network (the JAX package's tests/test_pipeline.py
    TestGtDepthPath)."""
    from dfvo_torch.pipeline.dfvo import DFVO

    cfg = _cfg(TConfigLoader, layouts, depth_src="gt")
    cfg.directory.result_dir = str(tmp_path / "result")
    vo = DFVO(cfg, device="cpu")
    assert vo.use_gt_depth

    def boom(*a, **k):
        raise AssertionError("the depth CNN must not run with depth_src: gt")

    vo.frontend._depth = boom
    vo.main(num_frames=3)
    poses = T_io.load_poses_from_txt(str(tmp_path / "result" / "07.txt"))
    assert sorted(poses) == [0, 1, 2]
    assert all(np.isfinite(p).all() for p in poses.values())
    want = torch.from_numpy(vo.dataset.get_depth(2)).float()
    assert torch.equal(vo.ref_data["raw_depth_dev"], want)
