"""Run DF-VO on one sequence with the PyTorch port.

    python -m dfvo_torch.apis.run -d options/examples/default_configuration.yml \
        [-c custom.yml] [-s SEQ] [--no_confirm] [--device cuda|cpu]

The flags of ``apis/run.py``, plus ``--device`` (default ``cuda``, which
fails without a GPU). Writes ``<seq>.txt`` (KITTI-format poses), the
merged ``configuration.yml`` with each changed value annotated
``# |CHANGED|``, and with visualization on ``map.png`` and ``img/``, all in
``directory.result_dir``.
"""

import argparse
import os
import random
import sys

import numpy as np

from ..pipeline.dfvo import DFVO
from ..utils import ConfigLoader
from ..utils.io import mkdir_if_not_exists


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="DF-VO (PyTorch port)")
    parser.add_argument("-s", "--seq", default=None, help="sequence (overrides YAML)")
    parser.add_argument("-d", "--default_configuration", type=str,
                        default="options/examples/default_configuration.yml",
                        help="default configuration file")
    parser.add_argument("-c", "--configuration", type=str, default=None,
                        help="custom configuration file")
    parser.add_argument("--no_confirm", action="store_true",
                        help="no confirmation questions")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device of the networks and the tracking step")
    return parser.parse_args(argv)


def read_cfgs(args):
    """Merge the default and custom configurations; ask before overwriting
    an existing trajectory unless ``--no_confirm``."""
    loader = ConfigLoader()
    cfg_files = [args.default_configuration, args.configuration]
    cfg = loader.merge_cfg(cfg_files)
    if args.seq is not None:
        cfg.seq = args.seq
    cfg.seq = str(cfg.seq)
    traj_txt = os.path.join(cfg.directory.result_dir, f"{cfg.seq}.txt")
    if not args.no_confirm and os.path.exists(traj_txt):
        if input(f"[{traj_txt}] exists. Overwrite it? [y/n]: ").lower() != "y":
            sys.exit("Quit the program..")
    return cfg, loader, cfg_files


def main(argv=None):
    """Run the CLI with ``argv`` (default: the process's arguments);
    returns the finished ``DFVO``."""
    args = parse_args(argv)
    cfg, loader, cfg_files = read_cfgs(args)
    # host RNGs; the tracking step's keys derive from cfg.seed
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)

    vo = DFVO(cfg, device=args.device)
    vo.main()

    mkdir_if_not_exists(cfg.directory.result_dir)
    loader.save_cfg(cfg_files, os.path.join(cfg.directory.result_dir, "configuration.yml"))
    return vo


if __name__ == "__main__":
    main()
