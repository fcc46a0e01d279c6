"""Saving and restoring network variables and the optimizer state.

Counterpart of ``dfvo_tpu/utils/checkpoint.py`` (the finetuned model that
``DFVO`` writes, ``DFVO.save_state``, and the step checkpoints of
:class:`CheckpointLogger`), on ``torch.save`` instead of orbax: a
directory holding one ``variables.pt`` of CPU tensors. The format is the
port's own; the JAX package's orbax checkpoints are not read.
"""

import os
import shutil

import torch

from .device import download

PAYLOAD = "variables.pt"


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _replace(tree, leaves):
    if isinstance(tree, dict):
        return {k: _replace(v, leaves) for k, v in tree.items()}
    return next(leaves) if isinstance(tree, torch.Tensor) else tree


def _to_cpu(tree):
    """The nested dict ``tree`` with its tensors on the host, downloaded
    after one synchronisation."""
    return _replace(tree, iter(download(_leaves(tree))))


def save_variables(path, variables, opt_state=None, train_state=None):
    """Save the variables ({net: state dict}) and, when given, the optimizer
    and train state (nested dicts of tensors and numbers) to the directory
    ``path``, replacing what it held. Returns the absolute path."""
    path = os.path.abspath(path)
    payload = {"variables": variables}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if train_state is not None:
        payload["train_state"] = train_state
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(_to_cpu(payload), os.path.join(path, PAYLOAD))
    return path


def restore_variables(path):
    """The payload of :func:`save_variables` (CPU tensors): a dict with
    ``variables`` and, where saved, ``opt_state`` and ``train_state``."""
    return torch.load(os.path.join(os.path.abspath(path), PAYLOAD), map_location="cpu",
                      weights_only=True)


class CheckpointLogger:
    """Step checkpoints with a best-model copy (the JAX package's
    ``CheckpointLogger``, on orbax's ``CheckpointManager`` there):
    ``<ckpt_dir>/<step>/`` for each saved step, the ``keep_n`` newest
    kept, and ``<ckpt_dir>/best/`` rewritten whenever the metric falls."""

    BEST = "best"

    def __init__(self, ckpt_dir, keep_n=5):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.keep_n = keep_n
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.best_metric = None

    def steps(self):
        """The saved steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.ckpt_dir)
                      if d.isdigit() and os.path.isfile(os.path.join(self.ckpt_dir, d, PAYLOAD)))

    def save(self, step, variables, opt_state=None, train_state=None, metric=None):
        """Save at ``step``, drop the steps beyond the ``keep_n`` newest,
        and when ``metric`` improves (lower is better) snapshot the same
        payload to ``<ckpt_dir>/best``."""
        save_variables(os.path.join(self.ckpt_dir, str(int(step))), variables, opt_state,
                       train_state)
        for old in self.steps()[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))
        if metric is not None and (self.best_metric is None or metric < self.best_metric):
            self.best_metric = metric
            save_variables(os.path.join(self.ckpt_dir, self.BEST), variables, opt_state,
                           train_state)

    def restore_latest(self):
        """(step, payload) of the newest saved step, or (None, None)."""
        steps = self.steps()
        if not steps:
            return None, None
        return steps[-1], restore_variables(os.path.join(self.ckpt_dir, str(steps[-1])))
