"""Counterpart of the ``jax.random`` key calls on the tracking path.

The JAX package derives each frame's key as
``fold_in(PRNGKey(seed), img_id)`` and splits it into eight per-stage keys;
the RANSAC draws then hash the two 32-bit words of a key
(``solvers/ransac.py``). Keys are tiny, so they live on the host: a key is
a numpy ``uint32[2]`` array, and the functions below reproduce
``jax.random`` bit for bit (threefry2x32 with JAX's
``jax_threefry_partitionable`` layout, the default since JAX 0.5).
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


def key_data(key):
    """``jax.random.key_data``: the key's two uint32 words."""
    return np.asarray(key, np.uint32).reshape(2)
