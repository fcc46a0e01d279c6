"""Shared machinery for batched, fixed-shape RANSAC.

Counterpart of ``dfvo_tpu/solvers/ransac.py``: every hypothesis is a row
of a batch, minimal samples are drawn at once from a counter-based hash of
the PRNG key, and keypoint sets are fixed-size arrays with validity masks.
The draws equal the JAX package's bit for bit on any device: the uint32
arithmetic runs in int64 masked to 32 bits, each 32x32-bit product split
into 16-bit halves so that nothing overflows. Each function also takes
leading frame axes (the JAX package ``vmap``s it over a chunk's frames),
with one key per frame as a device tensor.
"""

import math

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


def pick(x, idx, dim=0):
    """``x[idx]`` along axis ``dim`` for an index tensor of any shape,
    read on the device (a 0-d index is never read on the host). The axes
    before ``dim`` are frame axes: ``idx`` leads with the same ones, and
    each frame picks from its own rows."""
    if dim == 0:
        return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])
    lead, rest = x.shape[:dim], x.shape[dim + 1:]
    flat = x.reshape(math.prod(lead), x.shape[dim], -1)
    i = idx.reshape(flat.shape[0], -1)
    out = torch.gather(flat, 1, i[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape(idx.shape + rest)


def _valid_front_order(valid_mask):
    """Stable compaction permutation over the last axis: valid indices
    first, invalid after, by an exact integer cumsum and scatter (no sort).

    Returns:
        (order [... x N] int64, count [...] int64 clamped to >= 1).
    """
    n = valid_mask.shape[-1]
    cs_valid = torch.cumsum(valid_mask, -1)
    n_valid = cs_valid[..., -1:]
    cs_invalid = torch.cumsum(~valid_mask, -1)
    pos = torch.where(valid_mask, cs_valid - 1, n_valid + cs_invalid - 1)
    iota = torch.arange(n, device=valid_mask.device).expand_as(pos)
    order = torch.zeros_like(pos).scatter_(-1, pos, iota)
    return order, torch.clamp(n_valid[..., 0], min=1)


def _hash_draw(rng, num_draws, count, device):
    """[... x num_draws] int64 draws in [0, count) from a hashed iota seeded
    by the key's two words (``count`` [...] on ``device``).

    ``rng`` is a host key (two uint32 words; the hash's seed is then
    computed on the host), or a [... x 2] int64 tensor of key words on the
    device, one key per frame, hashed there with the same integer
    arithmetic, so both give the same draws bit for bit."""
    iota = torch.arange(num_draws, dtype=torch.long, device=device)
    if isinstance(rng, torch.Tensor):
        kd = rng.to(torch.long)
        base = _mix32(_mul32(kd[..., 0], _GOLDEN) ^ _mix32(kd[..., -1]))[..., None]
        count = count[..., None]
    else:
        kd = [int(w) for w in rng]
        base = _mix32(_mul32(kd[0], _GOLDEN) ^ _mix32(kd[-1]))
    raw = _mix32((_mul32(iota, _GOLDEN) + base) & _MASK)
    return raw % count


def sample_indices(rng, valid_mask, num_hypotheses, sample_size):
    """[... x M x k] indices of valid points for minimal samples (uniform,
    with replacement across hypotheses)."""
    order, count = _valid_front_order(valid_mask)
    draws = _hash_draw(rng, num_hypotheses * sample_size, count, valid_mask.device)
    return torch.gather(order, -1, draws).reshape(
        order.shape[:-1] + (num_hypotheses, sample_size))


def sample_points(rng, pts, valid_mask, num_hypotheses, sample_size):
    """[... x M x k x D] sampled point rows, equal to
    ``pts[sample_indices(...)]``.

    Args:
        rng: PRNG key (two uint32 words, utils/prng.py), or [... x 2] key
            words on the device, one per frame (see :func:`_hash_draw`).
        pts: [... x N x D] point rows (callers pack their arrays on D).
        valid_mask: [... x N] bool validity.
        num_hypotheses: M.
        sample_size: k.
    """
    nb = valid_mask.dim() - 1
    order, count = _valid_front_order(valid_mask)
    compact = pick(pts, order, nb)  # valid rows first
    draws = _hash_draw(rng, num_hypotheses * sample_size, count, pts.device)
    picked = pick(compact, torch.clamp(draws, max=pts.shape[-2] - 1), nb)
    return picked.reshape(picked.shape[:nb] + (num_hypotheses, sample_size, pts.shape[-1]))
