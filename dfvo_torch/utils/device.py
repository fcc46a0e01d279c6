"""Host-to-device copies that do not synchronise.

A blocking copy of a host tensor to the card waits for the card to finish
the work queued before it. :func:`upload` stages a host array in pinned
memory and copies it on the current stream instead, so the host can keep
launching; the caching host allocator keeps the staging buffer until the
copy is done.
"""

import numpy as np
import torch


def upload(arr, device, dtype=None):
    """A numpy array (or host tensor) as a tensor on ``device``, copied
    without a host synchronisation on a CUDA device."""
    t = torch.as_tensor(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
