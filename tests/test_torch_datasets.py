"""The port's TUM, Kinect, Adelaide and RobotCar loaders, the RobotCar SDK
and LiDAR readers and the TUM toolkit against the JAX package's, on
synthetic sequences in each dataset's own layout (those of
tests/test_datasets.py and tests/test_robotcar_lidar.py, widened). No JAX
compile: these are host numpy and cv2. Arrays are compared exactly or
within 1e-12, files byte for byte.

The TUM writer is the one place where the two differ on purpose: the port
stamps the pose of frame id i with the i-th synchronised timestamp, the
JAX package the k-th pose of the dict with the k-th timestamp. They agree
at ``frame_step: 1`` and part at ``frame_step: 2``.
"""

import csv

import cv2
import numpy as np
import pytest

from dfvo_torch.datasets import datasets as T_REG
from dfvo_torch.geometry.camera import SE3 as TSE3
from dfvo_torch.utils import AttrDict as TAttrDict
from dfvo_tpu.datasets import datasets as J_REG
from dfvo_tpu.geometry.camera import SE3 as JSE3
from dfvo_tpu.utils import AttrDict as JAttrDict

ANGLE_SETS = [
    (0.0, 0.0, 0.0),
    (0.3, -0.2, 0.9),
    (-1.2, 0.7, -0.4),
    (3.0, -1.4, 2.2),
    (0.01, 1.55, -0.02),  # near the gimbal lock (cos y ~ 0)
]
# Kinect stamps: 0.3 / 0.1 is 2.9999999999999996 in float64, so the frame
# stamped 0.3 is the file "2"
KINECT_STAMPS = ["0.000000", "0.100000", "0.300000", "0.400000", "0.500000"]


def _quat(rng):
    q = rng.randn(4)
    return q / np.linalg.norm(q)


def _cfg(dataset, seq, img_dir, gt_dir=None, h=48, w=80, ext="jpg", depth_src=None,
         depth_dir=None):
    return {"dataset": dataset, "seq": seq,
            "image": {"height": h, "width": w, "ext": ext},
            "depth": {"depth_src": depth_src},
            "directory": {"img_seq_dir": str(img_dir), "gt_pose_dir": gt_dir and str(gt_dir),
                          "depth_dir": depth_dir and str(depth_dir)}}


def _both(cfg):
    """(port loader, JAX loader) of one configuration, through each
    package's registry."""
    return T_REG[cfg["dataset"]](TAttrDict(cfg)), J_REG[cfg["dataset"]](JAttrDict(cfg))


def _write_tum(seq, rng, stamps, name, pose_file, n_img=(36, 52)):
    """A TUM-layout sequence: ``rgb/``, ``depth/`` (stamps 5 ms after the
    frame's), ``rgb.txt``, ``depth.txt`` and the pose list (2 ms after),
    with rotations; ``name`` maps a stamp to its file name."""
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb, depth, poses = [], [], []
    for s in stamps:
        t = float(s)
        cv2.imwrite(str(seq / "rgb" / f"{name(t)}.png"),
                    (rng.rand(*n_img, 3) * 255).astype(np.uint8))
        d = f"{t + 0.005:.6f}"
        cv2.imwrite(str(seq / "depth" / f"{name(float(d))}.png"),
                    (rng.rand(*n_img) * 5000 + 100).astype(np.uint16))
        rgb.append(f"{s} rgb/{name(t)}.png")
        depth.append(f"{d} depth/{name(float(d))}.png")
        qx, qy, qz, qw = _quat(rng)
        tx, ty, tz = rng.randn(3)
        poses.append(f"{t + 0.002:.6f} {tx:.4f} {ty:.4f} {tz:.4f} {qx:.6f} {qy:.6f} "
                     f"{qz:.6f} {qw:.6f}")
    # an unmatched frame (no depth, no pose within 0.02 s) is dropped
    rgb.append(f"{float(stamps[-1]) + 1.0:.6f} rgb/none.png")
    (seq / "rgb.txt").write_text("# color images\n" + "\n".join(rgb) + "\n")
    (seq / "depth.txt").write_text("\n".join(depth) + "\n")
    (seq / pose_file).write_text("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(poses) + "\n")


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.RandomState(0)
    _write_tum(root / "tum" / "fr1_seq", rng, [f"{100.0 + 0.1 * i:.6f}" for i in range(6)],
               lambda t: f"{t:.6f}", "groundtruth.txt")
    _write_tum(root / "kinect" / "k1", rng, KINECT_STAMPS, lambda t: str(int(t / 0.1)),
               "keyframe_trajectory_mono.txt")
    seq = root / "adelaide" / "seq1"
    seq.mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(seq / f"{i:06d}.jpg"), (rng.rand(64, 208, 3) * 255).astype(np.uint8))
    np.savetxt(str(seq / "cam.txt"), np.array([[500.0, 0, 416], [0, 500, 128], [0, 0, 1]]))
    # RobotCar: undistorted frames, stereo.timestamps, vo.csv, the SDK model
    rc = root / "robotcar"
    frames = rc / "2014-05-06-12-54-54" / "undistorted_stereo" / "centre"
    frames.mkdir(parents=True)
    (rc / "robotcar-dataset-sdk" / "models").mkdir(parents=True)
    (rc / "robotcar-dataset-sdk" / "models" / "stereo_narrow_left.txt").write_text(
        "983.044006 983.044006 643.646973 493.378998\n"
        "0 0 1 0\n1 0 0 0\n0 1 0 0\n0 0 0 1\n")
    stamps = [1399381494564000 + 62500 * i for i in range(5)]
    for ts in stamps:
        cv2.imwrite(str(frames / f"{ts:016d}.jpg"), (rng.rand(120, 160, 3) * 255).astype(np.uint8))
    (rc / "2014-05-06-12-54-54" / "stereo.timestamps").write_text(
        "".join(f"{ts} 1\n" for ts in stamps))
    (rc / "2014-05-06-12-54-54" / "vo").mkdir()
    rows = ["source_timestamp,destination_timestamp,x,y,z,roll,pitch,yaw"]
    vo_ts = [stamps[0] - 30000 + 50000 * i for i in range(8)]
    for i in range(1, len(vo_ts)):
        x, y, z = 1.0 + 0.1 * rng.randn(), 0.05 * rng.randn(), 0.02 * rng.randn()
        r, p, yw = 0.01 * rng.randn(3)
        rows.append(f"{vo_ts[i]},{vo_ts[i - 1]},{x},{y},{z},{r},{p},{yw}")
    (rc / "2014-05-06-12-54-54" / "vo" / "vo.csv").write_text("\n".join(rows) + "\n")
    return root


def _configs(root):
    tum, kin = root / "tum", root / "kinect"
    return {
        "tum": _cfg("tum-1", "fr1_seq", tum, tum, ext="png"),
        "tum_gt_depth": _cfg("tum-2", "fr1_seq", tum, tum, ext="png", depth_src="gt",
                             depth_dir=tum),
        "tum_no_gt": _cfg("tum-3", "fr1_seq", tum, ext="png"),
        "kinect": _cfg("kinect", "k1", kin, kin, ext="png", depth_src="gt", depth_dir=kin),
        "adelaide": _cfg("adelaide1", "seq1", root / "adelaide"),
        "robotcar": _cfg("robotcar", "2014-05-06-12-54-54", root / "robotcar",
                         root / "robotcar", h=64, w=160),
    }


@pytest.mark.parametrize("name", ["tum", "tum_gt_depth", "tum_no_gt", "kinect", "adelaide",
                                  "robotcar"])
def test_loader_matches_jax(layouts, tmp_path, name):
    """len, intrinsics, timestamps, images, depths, GT poses and the
    written trajectory (frame_step 1) of each loader, through both
    registries."""
    cfg = _configs(layouts)[name]
    t, j = _both(cfg)
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j) > 2
    for key in ("cx", "cy", "fx", "fy"):
        assert getattr(t.cam_intrinsics, key) == getattr(j.cam_intrinsics, key), key
    np.testing.assert_array_equal(t.cam_intrinsics.mat, j.cam_intrinsics.mat)
    assert t.data_dir == j.data_dir
    assert t.rgb_d_pose_pair == j.rgb_d_pose_pair
    stamps = [t.get_timestamp(i) for i in range(len(t))]
    assert stamps == [j.get_timestamp(i) for i in range(len(j))]
    for s in stamps:
        img = t.get_image(s)
        assert img.shape == (cfg["image"]["height"], cfg["image"]["width"], 3)
        np.testing.assert_array_equal(img, j.get_image(s))
        if cfg["depth"]["depth_src"] == "gt":
            np.testing.assert_array_equal(t.get_depth(s), j.get_depth(s))
    assert sorted(t.gt_poses) == sorted(j.gt_poses)
    for k in t.gt_poses:
        np.testing.assert_allclose(t.gt_poses[k], j.gt_poses[k], rtol=0, atol=1e-12)
    rng = np.random.RandomState(1)
    poses = {}
    for i in range(len(t)):
        P = np.eye(4)
        P[:3, :3], _ = np.linalg.qr(rng.randn(3, 3))
        P[:3, :3] *= np.sign(np.linalg.det(P[:3, :3]))
        P[:3, 3] = rng.randn(3)
        poses[i] = P
    t.save_result_traj(str(tmp_path / "t.txt"), {i: TSE3(P) for i, P in poses.items()})
    j.save_result_traj(str(tmp_path / "j.txt"), {i: JSE3(P) for i, P in poses.items()})
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_tum_gt_poses_are_rebased_and_intrinsics_scaled(layouts):
    t, _ = _both(_configs(layouts)["tum"])
    np.testing.assert_allclose(t.gt_poses[0], np.eye(4), atol=1e-12)
    assert t.cam_intrinsics.fx == 517.3 * 80 / 640
    assert len(t) == 6  # the unmatched seventh frame is dropped


def test_kinect_names_truncate(layouts):
    """The frame stamped 0.3 is read from "2.png", as the JAX package names
    it: int(0.3 / 0.1) is 2 in float64."""
    assert int(0.3 / 0.1) == 2
    t, j = _both(_configs(layouts)["kinect"])
    assert t.image_name(0.3) == "2"
    want = cv2.resize(cv2.cvtColor(cv2.imread(str(layouts / "kinect" / "k1" / "rgb" / "2.png")),
                                   cv2.COLOR_BGR2RGB), (80, 48))
    np.testing.assert_array_equal(t.get_image(0.3), want)
    np.testing.assert_array_equal(j.get_image(0.3), want)


@pytest.mark.parametrize("step", [1, 2])
def test_tum_writer_stamps_the_tracked_frames(layouts, tmp_path, step):
    """Poses keyed by frame id, as DFVO keeps them at ``frame_step``: the
    port stamps frame id i with synchronised stamp i. At step 1 the JAX
    writer agrees byte for byte; at step 2 it stamps frame 2k with stamp
    k, the fault this port fixes."""
    t, j = _both(_configs(layouts)["tum"])
    stamps = sorted(t.rgb_d_pose_pair)
    ids = list(range(0, len(t), step))
    rng = np.random.RandomState(2)
    poses = {}
    for i in ids:
        P = np.eye(4)
        P[:3, 3] = rng.randn(3)
        poses[i] = P
    t.save_result_traj(str(tmp_path / "t.txt"), {i: TSE3(P) for i, P in poses.items()})
    j.save_result_traj(str(tmp_path / "j.txt"), {i: JSE3(P) for i, P in poses.items()})
    got = np.loadtxt(tmp_path / "t.txt")
    want = np.loadtxt(tmp_path / "j.txt")
    np.testing.assert_array_equal(got[:, 0], [stamps[i] for i in ids])
    np.testing.assert_array_equal(want[:, 0], stamps[: len(ids)])
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    same = (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert same == (step == 1)


def test_registry_builds_every_loader(layouts):
    """Every name of the port's registry builds its loader, the same class
    as the JAX package's."""
    cfgs = _configs(layouts)
    by_kind = {"kitti_odom": None, "kitti_raw": None, "tum-1": cfgs["tum"], "tum-2": cfgs["tum"],
               "tum-3": cfgs["tum"], "adelaide1": cfgs["adelaide"],
               "adelaide2": cfgs["adelaide"], "kinect": cfgs["kinect"],
               "robotcar": cfgs["robotcar"]}
    assert set(T_REG) == set(J_REG) == set(by_kind)
    for name, cfg in by_kind.items():
        if cfg is None:
            continue  # tests/test_torch_host.py builds the KITTI loaders
        cfg = dict(cfg, dataset=name)
        t, j = _both(cfg)
        assert type(t).__name__ == type(j).__name__
        assert type(t).__module__.startswith("dfvo_torch.datasets.")


# -- RobotCar SDK ---------------------------------------------------------

@pytest.fixture(scope="module")
def sdk(tmp_path_factory):
    """A model directory with a synthetic look-up table (a 1.5 px shift
    and a slight shear) and a raw Bayer frame of 40x56."""
    root = tmp_path_factory.mktemp("sdk")
    models = root / "models"
    models.mkdir()
    h, w = 40, 56
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    lut = np.stack([(xs + 1.5 + 0.01 * ys).ravel(), (ys - 0.75).ravel()])
    lut.tofile(str(models / "stereo_narrow_left_distortion_lut.bin"))
    (models / "stereo_narrow_left.txt").write_text(
        "983.04 983.04 643.64 493.37\n1 0 0 0\n0 1 0 0\n0 0 1 0\n0 0 0 1\n")
    raw_dir = root / "seq" / "stereo" / "centre"
    raw_dir.mkdir(parents=True)
    rng = np.random.RandomState(3)
    cv2.imwrite(str(raw_dir / "1000.png"), (rng.rand(h, w) * 255).astype(np.uint8))
    rows = ["source_timestamp,destination_timestamp,x,y,z,roll,pitch,yaw"]
    ts = [1000, 2000, 3000, 4000]
    for i in range(1, 4):
        rows.append(f"{ts[i]},{ts[i - 1]},1.0,0.1,0.0,0.02,-0.01,{0.1 * i}")
    (root / "vo.csv").write_text("\n".join(rows) + "\n")
    with open(root / "ins.csv", "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["timestamp", "ins_status", "latitude", "longitude", "altitude",
                     "northing", "easting", "down", "utm_zone", "velocity_north",
                     "velocity_east", "velocity_down", "roll", "pitch", "yaw"])
        for i in range(5):
            wr.writerow([1000 + 700 * i, "INS_SOLUTION_GOOD", 51.7, -1.2, 110.0,
                         5735000.0 + 1.3 * i, 620000.0 - 0.4 * i, -110.0 + 0.01 * i, "30U",
                         0, 0, 0, 0.01 * i, -0.02 * i, 0.3 + 0.05 * i])
    return root


def test_robotcar_camera_model_and_load_image(sdk):
    from dfvo_torch.datasets import robotcar_sdk as T
    from dfvo_tpu.datasets import robotcar_sdk as J

    images = str(sdk / "seq" / "stereo" / "centre")
    tm, jm = T.CameraModel(str(sdk / "models"), images), J.CameraModel(str(sdk / "models"), images)
    assert (tm.camera, tm.focal_length, tm.principal_point) == \
        (jm.camera, jm.focal_length, jm.principal_point)
    np.testing.assert_array_equal(tm.G_camera_image, jm.G_camera_image)
    np.testing.assert_array_equal(tm.lut, jm.lut)
    for cam in ("mono_left", "mono_rear", "stereo/left", "stereo/right", "stereo/centre"):
        assert T.CameraModel._model_name(cam) == J.CameraModel._model_name(cam)
    path = str(sdk / "seq" / "stereo" / "centre" / "1000.png")
    np.testing.assert_array_equal(T.load_image(path), J.load_image(path))
    got = T.load_image(path, tm)
    assert got.shape == (40, 56, 3)
    np.testing.assert_array_equal(got, J.load_image(path, jm))


@pytest.mark.parametrize("q1,f", [
    ([np.cos(0.2), 0, 0, np.sin(0.2)], 0.5),
    ([-np.cos(0.3), 0.1, -0.2, np.sin(0.3)], 0.25),  # negative dot: the short way
    ([1.0, 1e-10, 0, 0], 0.5),  # below the 1e-8 angle: q0 back
])
def test_robotcar_slerp(q1, f):
    from dfvo_torch.datasets.robotcar_sdk import _slerp as t_slerp
    from dfvo_tpu.datasets.robotcar_sdk import _slerp as j_slerp

    q0, q1 = np.array([1.0, 0, 0, 0]), np.array(q1)
    q1 = q1 / np.linalg.norm(q1)
    np.testing.assert_array_equal(t_slerp(q0, q1, f), j_slerp(q0, q1, f))


def test_robotcar_interpolators(sdk):
    from dfvo_torch.datasets import robotcar_sdk as T
    from dfvo_tpu.datasets import robotcar_sdk as J

    req = [500, 1000, 1500, 2250, 3000, 3999, 4500]
    for fn, path in (("interpolate_vo_poses", "vo.csv"), ("interpolate_ins_poses", "ins.csv")):
        for origin in (1000, 2600):
            got = getattr(T, fn)(str(sdk / path), req, origin)
            want = getattr(J, fn)(str(sdk / path), req, origin)
            assert len(got) == len(want) == len(req)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=f"{fn} {origin}")
    np.testing.assert_array_equal(T._euler_to_rot(0.1, -0.2, 0.3), J._euler_to_rot(0.1, -0.2, 0.3))


# -- RobotCar LiDAR and radar ----------------------------------------------

def _velodyne_png(rng, n=12):
    intens = rng.randint(0, 255, (32, n), dtype=np.uint8)
    ranges = rng.randint(0, 60000, (32, n), dtype=np.uint16)
    angles = rng.randint(0, 36000, (1, n), dtype=np.uint16)
    ts = np.arange(n, dtype=np.int64)[None]
    return np.vstack([intens, ranges.T.copy().view(np.uint8).T.reshape(64, n),
                      angles.T.copy().view(np.uint8).T.reshape(2, n),
                      ts.T.copy().view(np.uint8).T.reshape(8, n)])


def test_robotcar_lidar_readers(tmp_path):
    from dfvo_torch.datasets import robotcar_lidar as T
    from dfvo_tpu.datasets import robotcar_lidar as J

    rng = np.random.RandomState(0)
    rng.rand(4, 100).astype(np.float32).tofile(str(tmp_path / "123.bin"))
    np.testing.assert_array_equal(T.load_velodyne_binary(str(tmp_path / "123.bin")),
                                  J.load_velodyne_binary(str(tmp_path / "123.bin")))
    cv2.imwrite(str(tmp_path / "456.png"), _velodyne_png(rng))
    got, want = T.load_velodyne_raw(str(tmp_path / "456.png")), \
        J.load_velodyne_raw(str(tmp_path / "456.png"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T.velodyne_raw_to_pointcloud(*got[:3]),
                                  J.velodyne_raw_to_pointcloud(*want[:3]))
    ranges = np.full((32, 1), 10.0)
    np.testing.assert_array_equal(
        T.velodyne_raw_to_pointcloud(ranges, np.full((32, 1), 7.0), np.zeros((1, 1))),
        J.velodyne_raw_to_pointcloud(ranges, np.full((32, 1), 7.0), np.zeros((1, 1))))

    A, R = 40, 64
    raw = np.zeros((A, 11 + R), np.uint8)
    raw[:, :8] = np.arange(A, dtype=np.int64)[:, None].copy().view(np.uint8).reshape(A, 8)
    az = (np.arange(A) / A * 5600).astype(np.uint16)
    raw[:, 8:10] = az[:, None].copy().view(np.uint8).reshape(A, 2)
    raw[:, 10] = 255
    raw[:, 11:] = rng.randint(0, 255, (A, R), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "radar.png"), raw)
    got, want = T.load_radar(str(tmp_path / "radar.png")), J.load_radar(str(tmp_path / "radar.png"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for width, cross in ((64, True), (63, False)):
        np.testing.assert_array_equal(
            T.radar_polar_to_cartesian(got[1], got[3], float(got[4][0]), 0.25, width, cross),
            J.radar_polar_to_cartesian(want[1], want[3], float(want[4][0]), 0.25, width, cross))


def test_robotcar_build_pointcloud(sdk, tmp_path):
    """Velodyne (binary and raw PNG scans) and LMS scans merged over a time
    window, each posed by the VO interpolation."""
    from dfvo_torch.datasets.robotcar_lidar import build_pointcloud as t_build
    from dfvo_tpu.datasets.robotcar_lidar import build_pointcloud as j_build

    rng = np.random.RandomState(4)
    ext = tmp_path / "extrinsics"
    ext.mkdir()
    for lidar in ("velodyne_left", "lms_front"):
        (ext / f"{lidar}.txt").write_text("1.5 0.2 -0.4 0.01 -0.02 0.3\n")
        (tmp_path / lidar).mkdir()
        stamps = [1200, 1800, 2600, 3400]
        (tmp_path / f"{lidar}.timestamps").write_text("".join(f"{t} 1\n" for t in stamps))
        for k, ts in enumerate(stamps):
            if lidar == "lms_front":
                rng.randn(30, 3).tofile(str(tmp_path / lidar / f"{ts}.bin"))
            elif k % 2:
                cv2.imwrite(str(tmp_path / lidar / f"{ts}.png"), _velodyne_png(rng, 6))
            else:
                rng.rand(4, 20).astype(np.float32).tofile(str(tmp_path / lidar / f"{ts}.bin"))
        args = (str(tmp_path / lidar), str(sdk / "vo.csv"), str(ext), 1000, 3000)
        (pa, ra), (pb, rb) = t_build(*args, origin_time=1500), j_build(*args, origin_time=1500)
        assert pa.shape[0] == 4 and pa.shape[1] > 0
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(ra, rb)


# -- TUM toolkit -------------------------------------------------------------

def test_tum_file_list_and_association(tmp_path):
    from dfvo_torch.evaluation import tum_tool as T
    from dfvo_tpu.evaluation import tum_tool as J

    p = tmp_path / "rgb.txt"
    p.write_text("# comment\n1.0 rgb/1.png\n2.0,rgb/2.png\n\n3.5\trgb/3.png extra\n")
    assert T.read_file_list(str(p)) == J.read_file_list(str(p))
    first = {0.0: ["a"], 1.0: ["b"], 2.0: ["c"], 2.01: ["d"]}
    second = {0.01: ["x"], 1.5: ["y"], 2.005: ["z"], 2.012: ["w"]}
    for offset, diff in ((0, 0.02), (0.001, 0.02), (0, 0.6)):
        assert T.associate(first, second, offset, diff) == J.associate(first, second, offset, diff)


def test_tum_ate_and_horn(tmp_path):
    from dfvo_torch.evaluation import tum_tool as T
    from dfvo_tpu.evaluation import tum_tool as J

    rng = np.random.RandomState(0)
    traj, P = {}, np.eye(4)
    for i in range(50):
        P = P.copy()
        P[:3, 3] += rng.randn(3) * 0.1
        traj[float(i)] = P
    M = np.eye(4)
    M[:3, :3] = T.euler2mat(0.3, -0.1, 0.2)
    M[:3, 3] = [5.0, -2.0, 1.0]
    moved = {k: M @ v for k, v in traj.items()}
    for k in moved:
        moved[k][:3, 3] += 0.01 * rng.randn(3)  # not a rigid copy: the RMSE is not 0
    (rt, at), (rj, aj) = T.compute_ate(traj, moved), J.compute_ate(traj, moved)
    assert abs(rt - rj) <= 1e-12
    for k in at:
        np.testing.assert_allclose(at[k], aj[k], rtol=0, atol=1e-12)
    a, b = rng.randn(3, 20), rng.randn(3, 20)
    for x, y in zip(T.align_horn(a, b), J.align_horn(a, b)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)


@pytest.mark.parametrize("z,y,x", ANGLE_SETS)
def test_tum_euler_conversions(z, y, x):
    from dfvo_torch.evaluation import tum_tool as T
    from dfvo_tpu.evaluation import tum_tool as J

    R = T.euler2mat(z, y, x)
    np.testing.assert_allclose(R, J.euler2mat(z, y, x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(T.euler2mat(z, y, x, isRadian=False),
                               J.euler2mat(z, y, x, isRadian=False), rtol=0, atol=1e-12)
    np.testing.assert_allclose(T.euler2quat(z, y, x), J.euler2quat(z, y, x), rtol=0, atol=1e-12)
    for seq in ("zyx", "xyz"):
        for thresh in (None, 1e-3):
            np.testing.assert_allclose(T.mat2euler(R, thresh, seq), J.mat2euler(R, thresh, seq),
                                       rtol=0, atol=1e-12)
    vec = np.array([1.0, -2.0, 3.0, x, y, z])
    np.testing.assert_allclose(T.pose_vec_to_mat(vec), J.pose_vec_to_mat(vec), rtol=0, atol=1e-12)


def test_tum_mat2euler_refuses_unknown_sequence():
    from dfvo_torch.evaluation.tum_tool import mat2euler as t_m2e
    from dfvo_tpu.evaluation.tum_tool import mat2euler as j_m2e

    for fn in (t_m2e, j_m2e):
        with pytest.raises(ValueError, match="Sequence"):
            fn(np.eye(3), seq="zxz")


def test_tum_dump_pose_seq(tmp_path):
    from dfvo_torch.evaluation import dump_pose_seq_TUM as t_dump
    from dfvo_tpu.evaluation.tum_tool import dump_pose_seq_TUM as j_dump

    rng = np.random.RandomState(5)
    poses = [np.concatenate([rng.randn(3), rng.uniform(-1.2, 1.2, 3)]) for _ in range(6)]
    times = [1311868164.0 + 0.1 * i for i in range(6)]
    t_dump(str(tmp_path / "t.txt"), poses, times)
    j_dump(str(tmp_path / "j.txt"), poses, times)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
