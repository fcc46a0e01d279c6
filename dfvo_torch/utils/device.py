"""Copies between the host and the device with the fewest synchronisations.

A blocking copy of a host tensor to the card waits for the card to finish
the work queued before it. :func:`upload` stages a host array in pinned
memory and copies it on the current stream instead, so the host can keep
launching; the caching host allocator keeps the staging buffer until the
copy is done. :func:`download` brings many device tensors back after one
synchronisation.
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


def download(tensors):
    """CPU copies of a list of tensors; CUDA tensors are copied into pinned
    memory on their streams and waited for once."""
    out, streams = [], set()
    for t in tensors:
        t = t.detach()
        if t.device.type != "cuda":
            out.append(t.cpu())
            continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        streams.add(torch.cuda.current_stream(t.device))
        out.append(host)
    for stream in streams:
        stream.synchronize()
    return out
