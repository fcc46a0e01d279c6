"""Counterpart of the ``jax.random`` key calls on the tracking path.

The JAX package derives each frame's key as
``fold_in(PRNGKey(seed), img_id)`` and splits it into eight per-stage keys;
the RANSAC draws then hash the two 32-bit words of a key
(``solvers/ransac.py``). Keys are tiny, so they live on the host: a key is
a numpy ``uint32[2]`` array, and the functions below reproduce
``jax.random`` bit for bit (threefry2x32 with JAX's
``jax_threefry_partitionable`` layout, the default since JAX 0.5).
:func:`chunk_keys` derives a whole chunk's split keys at once and
:func:`step_keys` adds the folded keys of the iterative scale recovery to
them, for the scan runner to upload with the chunk's images;
:func:`split_step_keys` does the same for any array of keys (the
multi-sequence steps' per-sequence keys).
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0, x1):
    """The threefry2x32 block cipher (20 rounds) of one counter pair under
    ``key`` (two words); returns the two output words as Python ints."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x = [(int(x0) + ks[0]) & _MASK, (int(x1) + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32), as JAX
    without 64-bit mode takes it: the words (0, seed)."""
    seed = int(seed)
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return np.array([0, seed], np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    (0, data)."""
    return np.array(threefry2x32(key, 0, int(data) & _MASK), np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)`` under the partitionable layout: row i
    is threefry of the counter pair (0, i)."""
    return np.stack([fold_in(key, i) for i in range(num)])


def _threefry2x32_np(k0, k1, x0, x1):
    """:func:`threefry2x32` over equal-shaped numpy arrays of words (held
    in uint64, masked to 32 bits)."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint64) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    m = np.uint64(_MASK)
    x = [(x0 + ks[0]) & m, (x1 + ks[1]) & m]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & m
            x[1] = (((x[1] << np.uint64(r)) | (x[1] >> np.uint64(32 - r))) & m) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & m
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & m
    return x[0], x[1]


def chunk_keys(seed, ids, num=8):
    """``split(fold_in(PRNGKey(seed), i), num)`` for every frame id ``i``
    of ``ids``, as one uint32 [len(ids) x num x 2] array."""
    return fold_in_keys(fold_in_many(PRNGKey(seed), np.asarray(ids)), num)


def fold_in_many(keys, data):
    """``fold_in(key, d)`` elementwise: uint32 keys [... x 2] (or one key)
    and integer data that broadcast against their leading axes; uint32
    [... x 2]."""
    keys = np.asarray(keys, np.uint32)
    data = np.asarray(data, np.uint64) & np.uint64(_MASK)
    shape = np.broadcast_shapes(keys.shape[:-1], data.shape)
    f0, f1 = _threefry2x32_np(np.broadcast_to(keys[..., 0], shape),
                              np.broadcast_to(keys[..., 1], shape), np.zeros(shape, np.uint64),
                              np.broadcast_to(data, shape))
    return np.stack([f0, f1], axis=-1).astype(np.uint32)


def key_data(key):
    """``jax.random.key_data``: the key's two uint32 words."""
    return np.asarray(key, np.uint32).reshape(2)


# the tracking step's iterative scale recovery folds its stage key (row 2
# of the split) with each of its iterations
ITER_SCALE_STAGE = 2
ITER_SCALE_ITERS = 5


def fold_in_keys(keys, num):
    """``fold_in(key, i)`` for i in range(num) of every key of a uint32
    [... x 2] array: [... x num x 2]."""
    keys = np.asarray(keys, np.uint32)
    shape = keys.shape[:-1] + (num,)
    k0 = np.broadcast_to(keys[..., 0, None], shape)
    k1 = np.broadcast_to(keys[..., 1, None], shape)
    data = np.broadcast_to(np.arange(num, dtype=np.uint64), shape)
    f0, f1 = _threefry2x32_np(k0, k1, np.zeros(shape, np.uint64), data)
    return np.stack([f0, f1], axis=-1).astype(np.uint32)


def with_iter_keys(split_keys):
    """A step's split keys [... x 8 x 2] followed by the iterative scale
    recovery's ``fold_in(split[2], i)``, i < 5: [... x 13 x 2]."""
    split_keys = np.asarray(split_keys, np.uint32)
    folded = fold_in_keys(split_keys[..., ITER_SCALE_STAGE, :], ITER_SCALE_ITERS)
    return np.concatenate([split_keys, folded], axis=-2)


def split_step_keys(keys):
    """Every key the tracking step draws from, for raw keys [... x 2] (as
    the JAX ``tracking_step`` splits its ``rng``): ``split(key, 8)`` and the
    iterative scale's folded keys, uint32 [... x 13 x 2]."""
    return with_iter_keys(fold_in_keys(keys, 8))


def step_keys(seed, ids):
    """Every key the tracking step of frame ``i`` of ``ids`` draws from:
    :func:`chunk_keys` with the iterative scale's folded keys appended, as
    one uint32 [len(ids) x 13 x 2] array."""
    return with_iter_keys(chunk_keys(seed, ids))
