"""Score a TUM-format trajectory: ATE after Horn's alignment.

    python -m dfvo_torch.apis.tum_eval --result result/tum/0/<seq>.txt \
        --gt dataset/tum/<seq>/groundtruth.txt [--max_difference 0.02]

The flags and the two printed lines of ``tools/evaluation/tum_eval.py``:
the number of pose pairs associated by timestamp, and the RMSE of their
translations.
"""

import argparse
import sys

from ..evaluation.tum_tool import associate, compute_ate
from ..utils.io import load_poses_from_txt_tum


def main(argv=None):
    parser = argparse.ArgumentParser(description="TUM ATE evaluation")
    parser.add_argument("--result", required=True, help="TUM-format result txt")
    parser.add_argument("--gt", required=True, help="TUM-format GT txt")
    parser.add_argument("--max_difference", type=float, default=0.02)
    args = parser.parse_args(argv)

    pred = load_poses_from_txt_tum(args.result)
    gt = load_poses_from_txt_tum(args.gt)
    matches = associate({t: [] for t in gt}, {t: [] for t in pred}, 0, args.max_difference)
    if len(matches) < 2:
        sys.exit("not enough matched timestamps between GT and result")
    rmse, _ = compute_ate({t1: gt[t1] for t1, _ in matches},
                          {t1: pred[t2] for t1, t2 in matches})
    print(f"compared_pose_pairs {len(matches)} pairs")
    print(f"absolute_translational_error.rmse {rmse:.6f} m")
    return len(matches), rmse


if __name__ == "__main__":
    main()
