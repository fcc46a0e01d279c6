"""Demosaic and undistort Oxford RobotCar frames.

    python -m dfvo_torch.tools.undistort_robotcar --data_dir dataset/robotcar --seq 2014-...

Reads the raw Bayer frames of ``<seq>/stereo/centre``, demosaics and
undistorts them with the SDK's camera model
(``<data_dir>/robotcar-dataset-sdk/models``) and writes them, same names,
to ``<seq>/undistorted_stereo/centre``, where the RobotCar loader reads
them. The flags and files of ``tools/undistort_robotcar.py``; progress is
printed every PROGRESS_EVERY frames.
"""

import argparse
import os
from glob import glob

from ..datasets.robotcar_sdk import CameraModel, load_image

PROGRESS_EVERY = 100


def main(argv=None):
    import cv2

    parser = argparse.ArgumentParser(description="undistort RobotCar images")
    parser.add_argument("--data_dir", required=True, help="dataset root")
    parser.add_argument("--seq", required=True, help="sequence name")
    args = parser.parse_args(argv)

    models_dir = os.path.join(args.data_dir, "robotcar-dataset-sdk", "models")
    img_dir = os.path.join(args.data_dir, args.seq, "stereo", "centre")
    out_dir = os.path.join(args.data_dir, args.seq, "undistorted_stereo", "centre")
    os.makedirs(out_dir, exist_ok=True)

    model = CameraModel(models_dir, img_dir)
    paths = sorted(glob(os.path.join(img_dir, "*.png")))
    for n, path in enumerate(paths, 1):
        img = load_image(path, model)
        cv2.imwrite(os.path.join(out_dir, os.path.basename(path)),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        if n % PROGRESS_EVERY == 0 or n == len(paths):
            print(f"==> {n}/{len(paths)} frames undistorted into {out_dir}")


if __name__ == "__main__":
    main()
