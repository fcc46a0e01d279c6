"""Write KITTI-format GT pose files from KITTI raw OXTS data.

    python -m dfvo_torch.tools.generate_kitti_raw_pose \
        --data_dir dataset/kitti_raw --result_dir dataset/kitti_raw_pose \
        --seqs 2011_09_26_drive_0001_sync ...

The flags and the files of ``tools/generate_kitti_raw_pose.py``: one
``<seq>.txt`` per drive, each line a pose's first 12 numbers relative to
frame 0, in the camera convention.
"""

import argparse
import os
from glob import glob

from ..datasets.oxts import generate_pose


def main(argv=None):
    parser = argparse.ArgumentParser(description="KITTI raw GT pose export")
    parser.add_argument("--data_dir", required=True, help="kitti raw root")
    parser.add_argument("--result_dir", required=True)
    parser.add_argument("--seqs", nargs="+", required=True)
    args = parser.parse_args(argv)

    os.makedirs(args.result_dir, exist_ok=True)
    for seq in args.seqs:
        oxts_dir = os.path.join(args.data_dir, seq[:10], seq, "oxts", "data")
        n = len(glob(os.path.join(oxts_dir, "*.txt")))
        lines = [" ".join(str(v) for v in generate_pose(oxts_dir, i).flatten()[:12])
                 for i in range(n)]
        out = os.path.join(args.result_dir, f"{seq}.txt")
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"saved {out} ({n} poses)")


if __name__ == "__main__":
    main()
