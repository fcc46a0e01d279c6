"""Score trajectories with the KITTI odometry protocol.

    python -m dfvo_torch.apis.eval_odom --result RESULT_DIR \
        [--gt dataset/kitti_odom/gt_poses/] [--align {scale,scale_7dof,7dof,6dof}] \
        [--seqs 09 10]

The flags of ``tools/evaluation/odometry/eval_odom.py``. Writes
``result.txt``, ``errors/`` and, where matplotlib is installed, the plots
into the result directory.
"""

import argparse

from ..evaluation import KittiEvalOdom


def main(argv=None):
    parser = argparse.ArgumentParser(description="KITTI odometry evaluation")
    parser.add_argument("--result", type=str, required=True, help="result directory")
    parser.add_argument("--gt", type=str, default="dataset/kitti_odom/gt_poses/",
                        help="GT poses directory")
    parser.add_argument("--align", type=str, choices=["scale", "scale_7dof", "7dof", "6dof"],
                        default=None, help="alignment type")
    parser.add_argument("--seqs", nargs="+", default=None, help="sequences to be evaluated")
    args = parser.parse_args(argv)
    return KittiEvalOdom().eval(args.gt, args.result, alignment=args.align, seqs=args.seqs)


if __name__ == "__main__":
    main()
