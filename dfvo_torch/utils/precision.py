"""Precision control for geometry and solver code.

Counterpart of ``dfvo_tpu/utils/precision.py``. On the card, float32
matmuls may run in TF32 (10-bit mantissa) when the process allows it; that
suits the networks but bends rotations off SO(3) and destabilises RANSAC
inlier counts. Every public geometry/solver entry point is wrapped with
:func:`highp`, which runs it with TF32 matmuls off and restores the
caller's setting on exit (the counterpart of
``jax.default_matmul_precision("float32")``). It sets cuBLAS's float32
precision through ``torch.backends.cuda.matmul.fp32_precision`` ("ieee"
inside) where torch has that setting, else through the older
``allow_tf32`` flag.
"""

import functools

import torch


def _tf32_setting():
    """(name, value that turns TF32 off) of this torch's cuBLAS setting."""
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        return "fp32_precision", "ieee"
    return "allow_tf32", False


def highp(fn):
    """Decorator: run ``fn`` with float32 matmuls in true float32."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        matmul = torch.backends.cuda.matmul
        name, off = _tf32_setting()
        saved = getattr(matmul, name)
        setattr(matmul, name, off)
        try:
            return fn(*args, **kwargs)
        finally:
            setattr(matmul, name, saved)

    return wrapped
