"""Saving and restoring network variables and the optimizer state.

Counterpart of ``save_variables`` / ``restore_variables`` of
``dfvo_tpu/utils/checkpoint.py`` (the finetuned model that ``DFVO``
writes), on ``torch.save`` instead of orbax: a directory holding one
``variables.pt`` of CPU tensors. The format is the port's own; the JAX
package's orbax checkpoints are not read.
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
