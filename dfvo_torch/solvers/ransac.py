"""Shared machinery for batched, fixed-shape RANSAC.

Counterpart of ``dfvo_tpu/solvers/ransac.py``: every hypothesis is a row
of a batch, minimal samples are drawn at once from a counter-based hash of
the PRNG key, and keypoint sets are fixed-size arrays with validity masks.
The draws equal the JAX package's bit for bit on any device: the uint32
arithmetic runs in int64 masked to 32 bits, each 32x32-bit product split
into 16-bit halves so that nothing overflows.
"""

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c):
    """(x * c) mod 2**32 for x an int64 tensor (or int) in [0, 2**32) and c
    a constant below 2**32, without overflowing int64."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _mix32(x):
    """splitmix/murmur3-style 32-bit avalanche, on an int64 tensor or a
    Python int holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def pick(x, idx):
    """``x[idx]`` along the first axis for an index tensor of any shape,
    read on the device (a 0-d index is never read on the host)."""
    return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def _valid_front_order(valid_mask):
    """Stable compaction permutation: valid indices first, invalid after,
    by an exact integer cumsum and scatter (no sort).

    Returns:
        (order [N] int64, count 0-d int64 clamped to >= 1).
    """
    n = valid_mask.shape[0]
    cs_valid = torch.cumsum(valid_mask, 0)
    n_valid = cs_valid[-1]
    cs_invalid = torch.cumsum(~valid_mask, 0)
    pos = torch.where(valid_mask, cs_valid - 1, n_valid + cs_invalid - 1)
    iota = torch.arange(n, device=valid_mask.device)
    order = torch.zeros(n, dtype=torch.long, device=valid_mask.device).scatter_(0, pos, iota)
    return order, torch.clamp(n_valid, min=1)


def _hash_draw(rng, num_draws, count, device):
    """[num_draws] int64 draws in [0, count) from a hashed iota seeded by
    the key's two words (``count`` a 0-d tensor on ``device``)."""
    kd = [int(w) for w in rng]
    base = _mix32(_mul32(kd[0], _GOLDEN) ^ _mix32(kd[-1]))
    iota = torch.arange(num_draws, dtype=torch.long, device=device)
    raw = _mix32((_mul32(iota, _GOLDEN) + base) & _MASK)
    return raw % count


def sample_indices(rng, valid_mask, num_hypotheses, sample_size):
    """[M x k] indices of valid points for minimal samples (uniform, with
    replacement across hypotheses)."""
    order, count = _valid_front_order(valid_mask)
    draws = _hash_draw(rng, num_hypotheses * sample_size, count, valid_mask.device)
    return order[draws.reshape(num_hypotheses, sample_size)]


def sample_points(rng, pts, valid_mask, num_hypotheses, sample_size):
    """[M x k x D] sampled point rows, equal to ``pts[sample_indices(...)]``.

    Args:
        rng: PRNG key (two uint32 words, utils/prng.py).
        pts: [N x D] point rows (callers pack their arrays on D).
        valid_mask: [N] bool validity.
        num_hypotheses: M.
        sample_size: k.
    """
    order, count = _valid_front_order(valid_mask)
    compact = pts[order]  # valid rows first
    draws = _hash_draw(rng, num_hypotheses * sample_size, count, pts.device)
    picked = compact[torch.clamp(draws, max=pts.shape[0] - 1)]
    return picked.reshape(num_hypotheses, sample_size, pts.shape[-1])
