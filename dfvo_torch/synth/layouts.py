"""Synthetic sequences in the layouts of the TUM RGB-D, Adelaide and Oxford
RobotCar loaders, for the tests and the card's smoke run: frames of a
smooth random texture panning a pixel per frame, with each dataset's lists,
calibration and pose files. The poses are a camera moving along its x axis.

TUM (``write_tum``)::

    <root>/<seq>/rgb/<t>.png      t = "%.6f" stamps, 30 Hz
    <root>/<seq>/rgb.txt          "<t> rgb/<t>.png"
    <root>/<seq>/depth.txt        stamps 5 ms after the frames' (the depth
                                  maps themselves are not written: the
                                  shipped YAML reads none)
    <root>/<seq>/groundtruth.txt  "<t> tx ty tz qx qy qz qw", 2 ms after

Adelaide (``write_adelaide``)::

    <root>/<seq>/%06d.jpg         at the capture size (256x832 for adelaide1)
    <root>/<seq>/cam.txt          3x3 camera matrix at that size

Oxford RobotCar (``write_robotcar``)::

    <root>/<seq>/undistorted_stereo/centre/<ts:016d>.jpg   960x1280
    <root>/<seq>/stereo.timestamps                          "<ts> 1", 16 Hz
    <root>/<seq>/vo/vo.csv        relative VO poses between the frames
    <root>/robotcar-dataset-sdk/models/stereo_narrow_left.txt
"""

import os

import numpy as np

TUM_START = 1305031102.175304
TUM_PERIOD = 1.0 / 30.0
ROBOTCAR_START = 1399381444704913
ROBOTCAR_PERIOD = 62500


def panning_frames(seed, count, h, w):
    """[count x h x w x 3] uint8: a smooth random texture (8 px cells,
    bicubic) panning 1 px per frame."""
    import cv2

    rng = np.random.default_rng(seed)
    span = w + count
    coarse = rng.integers(0, 256, (h // 8 + 1, span // 8 + 1, 3)).astype(np.uint8)
    texture = cv2.resize(coarse, (span, h), interpolation=cv2.INTER_CUBIC)
    return np.stack([texture[:, i : i + w] for i in range(count)])


def _imwrite(path, rgb):
    import cv2

    if not cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)):
        raise OSError(f"cannot write {path}")


def write_tum(root, seq, frames, h=480, w=640, seed=0):
    """A TUM-layout sequence of ``frames`` PNG frames; returns their stamps
    as written ("%.6f")."""
    seq_dir = os.path.join(root, seq)
    os.makedirs(os.path.join(seq_dir, "rgb"), exist_ok=True)
    stamps, rgb, depth, poses = [], [], [], []
    for i, img in enumerate(panning_frames(seed, frames, h, w)):
        t = f"{TUM_START + i * TUM_PERIOD:.6f}"
        d = f"{float(t) + 0.005:.6f}"
        _imwrite(os.path.join(seq_dir, "rgb", f"{t}.png"), img)
        stamps.append(t)
        rgb.append(f"{t} rgb/{t}.png")
        depth.append(f"{d} depth/{d}.png")
        poses.append(f"{float(t) + 0.002:.6f} {0.004 * i:.4f} 0.0000 0.0000 0 0 0 1")
    for name, head, lines in (("rgb.txt", "color images", rgb), ("depth.txt", "depth maps", depth),
                              ("groundtruth.txt", "timestamp tx ty tz qx qy qz qw", poses)):
        with open(os.path.join(seq_dir, name), "w") as f:
            f.write(f"# {head}\n" + "\n".join(lines) + "\n")
    return stamps


def write_adelaide(root, seq, frames, h=256, w=832, seed=0):
    """An Adelaide-layout sequence of ``frames`` frames at its capture size."""
    seq_dir = os.path.join(root, seq)
    os.makedirs(seq_dir, exist_ok=True)
    for i, img in enumerate(panning_frames(seed, frames, h, w)):
        _imwrite(os.path.join(seq_dir, f"{i:06d}.jpg"), img)
    K = np.array([[0.85 * w, 0, w / 2], [0, 0.85 * w, h / 2], [0, 0, 1.0]])
    np.savetxt(os.path.join(seq_dir, "cam.txt"), K)


def write_robotcar(root, seq, frames, h=960, w=1280, seed=0):
    """A RobotCar-layout sequence of ``frames`` undistorted centre frames."""
    seq_dir = os.path.join(root, seq)
    img_dir = os.path.join(seq_dir, "undistorted_stereo", "centre")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "vo"), exist_ok=True)
    models = os.path.join(root, "robotcar-dataset-sdk", "models")
    os.makedirs(models, exist_ok=True)
    stamps = [ROBOTCAR_START + i * ROBOTCAR_PERIOD for i in range(frames)]
    for ts, img in zip(stamps, panning_frames(seed, frames, h, w)):
        _imwrite(os.path.join(img_dir, f"{ts:016d}.jpg"), img)
    with open(os.path.join(seq_dir, "stereo.timestamps"), "w") as f:
        f.write("".join(f"{ts} 1\n" for ts in stamps))
    rows = ["source_timestamp,destination_timestamp,x,y,z,roll,pitch,yaw"]
    rows += [f"{stamps[i]},{stamps[i - 1]},0.0,0.05,0.0,0.0,0.0,0.0" for i in range(1, frames)]
    with open(os.path.join(seq_dir, "vo", "vo.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    # the centre camera's intrinsics, then G_camera_image
    with open(os.path.join(models, "stereo_narrow_left.txt"), "w") as f:
        f.write("983.044006 983.044006 643.646973 493.378998\n"
                "0 0 1 0\n1 0 0 0\n0 1 0 0\n0 0 0 1\n")
