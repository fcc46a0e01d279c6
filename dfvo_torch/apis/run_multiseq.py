"""Track several sequences at once with the PyTorch port, on one GPU.

    python -m dfvo_torch.apis.run_multiseq -d options/examples/default_configuration.yml \
        [-c custom.yml] --seqs 00 01 02 ... [--max_frames N] [--device cuda|cpu]

The flags of ``apis/run_multiseq.py``, plus ``--device`` (default ``cuda``,
which fails without a GPU). The sequences are the batch axis of every step
(``parallel/multiseq.py``); one device holds them all, so nothing is padded.
Every sequence runs for the frames of the shortest one (or ``--max_frames``).
The first frames' depths come from one batched depth call; ``tpu.execution``
selects the loop:

* ``frame``: one batched VO step per frame; sequence s of frame i draws
  from the key ``fold_in(PRNGKey(seed), i * S + s)``, so the keys depend on
  S, as in the JAX package;
* ``scan``: chunks of ``tpu.scan_chunk`` frames per sequence, the last one
  padded with its last frame; frame i of sequence s draws from
  ``fold_in(fold_in(PRNGKey(seed), i), s)``.

Relative poses are chained on the host in float64 from the identity, and
one KITTI-format ``<seq>.txt`` per sequence is written to
``directory.result_dir``, for ``python -m dfvo_torch.apis.eval_odom``.
"""

import argparse
import os

import numpy as np
import torch

from ..datasets import datasets as dataset_registry
from ..parallel import MultiSeqRunner
from ..pipeline.dfvo import depth_only
from ..utils import ConfigLoader, prng
from ..utils.attrdict import AttrDict
from ..utils.device import upload
from ..utils.io import mkdir_if_not_exists, save_traj
from ..utils.native_loader import make_prefetcher
from ..utils.timer import Timer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="DF-VO multi-sequence (PyTorch port)")
    parser.add_argument("-d", "--default_configuration", type=str,
                        default="options/examples/default_configuration.yml")
    parser.add_argument("-c", "--configuration", type=str, default=None)
    parser.add_argument("--seqs", nargs="+", required=True)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device of the networks and the tracking steps")
    return parser.parse_args(argv)


def _resolve_device(name):
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_multiseq runs on a CUDA device by default and none is "
                           "available; pass --device cpu to run on the CPU")
    return torch.device(name)


class MultiSeqRun:
    """The state of one multi-sequence run: the datasets, their frame
    loaders, the runner, the variables and the trajectories."""

    def __init__(self, cfg, seqs, device, max_frames=None):
        self.cfg, self.seqs, self.device = cfg, [str(s) for s in seqs], device
        self.timers = Timer()
        self.datasets = []
        for s in self.seqs:  # a shallow copy of the configuration per sequence
            self.datasets.append(dataset_registry[cfg.dataset](AttrDict(cfg, seq=s)))
        n = min(len(d) for d in self.datasets)
        self.n_frames = min(n, max_frames) if max_frames else n
        self.runner = MultiSeqRunner(cfg, device=device)
        fe = self.runner.frontend
        self.variables = fe.prepare_variables(
            fe.load_variables(torch.Generator().manual_seed(int(cfg.seed))))
        self.K = upload(np.stack([d.cam_intrinsics.mat for d in self.datasets]), device,
                        torch.float32)
        self.K_inv = upload(np.stack([d.cam_intrinsics.inv_mat for d in self.datasets]), device,
                            torch.float32)
        self.trajs = [{0: np.eye(4)} for _ in self.seqs]
        self.loaders = []

    def open_loaders(self):
        h, w = self.cfg.image.height, self.cfg.image.width
        for ds in self.datasets:
            paths = [ds.get_image_path(ds.get_timestamp(i)) for i in range(self.n_frames)]
            self.loaders.append(make_prefetcher(paths, h, w))
        self.loader = self.loaders[0].name

    def close(self):
        for ld in self.loaders:
            ld.close()

    def next_batch(self):
        """The next frame of every sequence, [S x H x W x 3] uint8 on the
        host."""
        return np.stack([ld.next()[1] for ld in self.loaders])

    def chain(self, s, i, rel):
        """Frame i of sequence s: the previous pose times ``rel``."""
        self.trajs[s][i] = self.trajs[s][i - 1] @ rel

    def run_frames(self):
        """The frame execution: one batched VO step per frame."""
        S = len(self.seqs)
        base = prng.PRNGKey(self.cfg.seed)
        vo_step = self.runner.make_vo_step()
        with self.timers.scope("data_loading"):
            img_ref = upload(self.next_batch(), self.device)
        with self.timers.scope("depth_cnn"):
            depth_ref = depth_only(self.runner.frontend, self.variables, img_ref)
        prev = torch.eye(4, device=self.device).expand(S, 4, 4)
        for i in range(1, self.n_frames):
            self.timers.start("DF-VO")
            with self.timers.scope("data_loading", "DF-VO"):
                img_cur = upload(self.next_batch(), self.device)
                rngs = prng.fold_in_many(base, np.arange(i * S, (i + 1) * S))
            with self.timers.scope("vo_step", "DF-VO"):
                poses, _, depth_ref = vo_step(self.variables, img_cur, img_ref, depth_ref, prev,
                                              rngs, self.K, self.K_inv)
                rel = poses.to("cpu", torch.float64).numpy()
            prev, img_ref = poses, img_cur
            for s in range(S):
                self.chain(s, i, rel[s])
            self.timers.end("DF-VO")

    def run_chunks(self):
        """The scan execution: one chunk step per ``tpu.scan_chunk``
        frames of every sequence."""
        S, T = len(self.seqs), int(self.cfg.tpu.scan_chunk)
        h, w = self.cfg.image.height, self.cfg.image.width
        base = prng.PRNGKey(self.cfg.seed)
        chunk_step = self.runner.make_chunk_step()
        with self.timers.scope("data_loading"):
            img_ref = upload(self.next_batch(), self.device)
        with self.timers.scope("depth_cnn"):
            depth_ref = depth_only(self.runner.frontend, self.variables, img_ref)
        carry = (img_ref, depth_ref, torch.eye(4, device=self.device).expand(S, 4, 4),
                 np.ones(S, np.float32))
        for start in range(1, self.n_frames, T):
            self.timers.start("DF-VO")
            ids = list(range(start, min(start + T, self.n_frames)))
            with self.timers.scope("data_loading", "DF-VO"):
                imgs = np.empty((S, T, h, w, 3), np.uint8)
                for j in range(len(ids)):
                    imgs[:, j] = self.next_batch()
                imgs[:, len(ids):] = imgs[:, len(ids) - 1 : len(ids)]  # a fixed chunk shape
                id_pad = np.array(ids + [ids[-1]] * (T - len(ids)))
                rngs = prng.fold_in_many(prng.fold_in_many(base, id_pad)[None],
                                         np.arange(S)[:, None])  # [S x T x 2]
                imgs_dev = upload(imgs, self.device)
            with self.timers.scope("vo_step", "DF-VO"):
                poses, _, carry = chunk_step(self.variables, imgs_dev, carry, rngs, self.K,
                                             self.K_inv)
                rel = poses.to("cpu", torch.float64).numpy()[:, : len(ids)]
            for s in range(S):
                for j, i in enumerate(ids):
                    self.chain(s, i, rel[s, j])
            self.timers.end("DF-VO")

    def save(self):
        result_dir = self.cfg.directory.result_dir
        mkdir_if_not_exists(result_dir)
        for s, name in enumerate(self.seqs):
            save_traj(os.path.join(result_dir, f"{name}.txt"), self.trajs[s], format="kitti")
        print(f"saved {len(self.seqs)} trajectories to {result_dir}")


def main(argv=None):
    """Run the CLI with ``argv`` (default: the process's arguments);
    returns the finished :class:`MultiSeqRun`."""
    args = parse_args(argv)
    cfg = ConfigLoader().merge_cfg([args.default_configuration, args.configuration])
    device = _resolve_device(args.device)
    run = MultiSeqRun(cfg, args.seqs, device, args.max_frames)
    execution = str(cfg.tpu.get("execution", "frame"))
    if execution not in ("frame", "scan"):
        raise ValueError(f"tpu.execution must be 'frame' or 'scan', got {execution!r}")
    print(f"==> {len(run.seqs)} sequences x {run.n_frames} frames, {execution} execution, "
          f"on {device}")
    run.open_loaders()
    try:
        run.run_chunks() if execution == "scan" else run.run_frames()
    finally:
        run.close()
    run.save()
    run.timers.time_analysis()
    return run


if __name__ == "__main__":
    main()
