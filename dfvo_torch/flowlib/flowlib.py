"""Optical-flow visualization: the Middlebury color coding.

Counterpart of ``flow_to_image`` in ``dfvo_tpu/flowlib/flowlib.py`` and
what it needs; the flow file readers and writers are not ported.
"""

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7


def make_color_wheel():
    """Middlebury color wheel [55 x 3]."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def compute_color(u, v):
    """Flow components -> RGB uint8 via the Middlebury wheel."""
    ncols = _WHEEL.shape[0]
    nan_mask = np.isnan(u) | np.isnan(v)
    u = np.where(nan_mask, 0, u)
    v = np.where(nan_mask, 0, v)

    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        small = rad <= 1
        col = np.where(small, 1 - rad * (1 - col), col * 0.75)
        img[..., i] = np.where(nan_mask, 0, np.floor(255 * col)).astype(
            np.uint8
        )
    return img


def flow_to_image(flow):
    """[H x W x 2] flow -> RGB uint8 visualization, normalized by the max
    radius."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    bad = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1, rad.max()) if rad.size else -1
    eps = np.finfo(float).eps
    u = u / (maxrad + eps)
    v = v / (maxrad + eps)
    img = compute_color(u, v)
    img[bad] = 0
    return img
