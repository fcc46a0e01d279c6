"""Synthetic oracle sequences: geometrically self-consistent depth + flow
(+ optionally rendered images) for testing and the card's smoke run.

Counterpart of ``dfvo_tpu/synth/oracle.py``, in numpy only (the card's
machine has no cv2). A sequence starts from a smooth random depth field;
each next frame's depth is the previous frame's point cloud rendered into
the new camera (far-to-near scatter approximating a z-buffer, then hole
fill), so the exact reprojection flow and the depth chain agree metrically
across the whole sequence.
"""

import numpy as np


def _bilinear_resize(a, h, w):
    """Separable bilinear resize of a 2-D (or 2-D + channel) array."""
    ys = np.linspace(0.0, a.shape[0] - 1.0, h)
    xs = np.linspace(0.0, a.shape[1] - 1.0, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, a.shape[0] - 1)
    x1 = np.minimum(x0 + 1, a.shape[1] - 1)
    fy = (ys - y0).reshape(-1, 1)
    fx = (xs - x0).reshape(1, -1)
    if a.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    top = a[y0][:, x0] * (1 - fx) + a[y0][:, x1] * fx
    bot = a[y1][:, x0] * (1 - fx) + a[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def smooth_field(rng, h, w, coarse=(6, 20), lo=0.0, hi=1.0):
    """Smooth random field in [lo, hi]: bilinear upsample of coarse noise."""
    field = _bilinear_resize(rng.rand(*coarse), h, w)
    field = (field - field.min()) / max(field.max() - field.min(), 1e-12)
    return lo + field * (hi - lo)


def _shift_max(a):
    """3x3 neighbourhood maximum (edge-replicated)."""
    p = np.pad(a, 1, mode="edge")
    out = a
    for dy in range(3):
        for dx in range(3):
            out = np.maximum(out, p[dy : dy + a.shape[0], dx : dx + a.shape[1]])
    return out


def _fill_holes(depth):
    """Fill non-positive pixels with the local neighbourhood max (iterated)."""
    d = depth.copy()
    for _ in range(12):
        holes = d <= 0
        if not holes.any():
            break
        dil = _shift_max(d)
        d[holes] = dil[holes]
    if (d <= 0).any():
        fill = np.median(d[d > 0]) if (d > 0).any() else 1.0
        d[d <= 0] = fill
    return d


def make_motions(n, speed=1.0):
    """Per-pair ground-truth motions T_cur2ref (cur -> ref): forward
    dominant with curvature and speed variation (KITTI-like)."""
    out = []
    for i in range(n):
        v = speed * (1.0 + 0.3 * np.sin(i / 3.0))
        yaw = 0.004 * np.sin(i / 5.0)
        pitch = 0.002 * np.cos(i / 7.0)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cx, sx = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        T = np.eye(4)
        T[:3, :3] = Rx @ Ry
        T[:3, 3] = [0.05 * np.sin(i / 4.0), -0.02, v]
        out.append(T)
    return out


def make_oracle_sequence(h, w, K, n_frames, seed=0, speed=1.0):
    """Geometrically consistent (depths, flows, motions) chains.

    Returns:
        depths: [n_frames] list of [h x w] float32 metric depth.
        flows: [n_frames - 1] list of [h x w x 2] float32 ref->cur flow.
        motions: [n_frames - 1] list of [4 x 4] T_cur2ref ground truth.
    """
    rng = np.random.RandomState(seed)
    K = np.asarray(K, np.float64)
    K_inv = np.linalg.inv(K)
    motions = make_motions(n_frames - 1, speed=speed)

    ys, xs = np.mgrid[0:h, 0:w]
    pix_h = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    rays = pix_h @ K_inv.T

    depths = [smooth_field(rng, h, w, lo=6.0, hi=40.0)]
    flows = []
    for i in range(n_frames - 1):
        T_ref2cur = np.linalg.inv(motions[i])
        pts_ref = rays * depths[i][..., None]
        pts_cur = pts_ref @ T_ref2cur[:3, :3].T + T_ref2cur[:3, 3]
        uv = pts_cur @ K.T
        z = uv[..., 2]
        pix = uv[..., :2] / np.maximum(z[..., None], 1e-9)
        flows.append((pix - np.stack([xs, ys], -1)).astype(np.float32))

        px = np.round(pix[..., 0]).astype(int)
        py = np.round(pix[..., 1]).astype(int)
        ok = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
        d_next = np.zeros((h, w))
        order = np.argsort(-z[ok])  # far-to-near write order ~ z-buffer
        d_next[py[ok].ravel()[order], px[ok].ravel()[order]] = z[ok].ravel()[
            order
        ]
        d_next = _fill_holes(d_next)
        # replenish content the forward-moving camera has consumed: pixels
        # whose depth left a sane range get fresh scene (the NEXT pair's
        # flow is computed from this refreshed field, so every pair stays
        # exactly self-consistent; long sequences would otherwise run out
        # of scene after ~lo/|t_z| frames and collapse to NaN)
        stale = ~np.isfinite(d_next) | (d_next < 2.0) | (d_next > 80.0)
        if stale.any():
            fresh = smooth_field(rng, h, w, lo=6.0, hi=40.0)
            d_next[stale] = fresh[stale]
        depths.append(d_next)
    return [d.astype(np.float32) for d in depths], flows, motions


def render_images(depths, flows, seed=0):
    """Textured uint8 frames photometrically consistent with the flow.

    Frame 0 is multi-octave smooth noise; each next frame scatters the
    previous frame's colours along the flow (same far-to-near order the
    depth chain uses), holes filled with the base texture.
    """
    rng = np.random.RandomState(seed + 101)
    h, w = depths[0].shape
    octaves = [(6, 20), (12, 40), (24, 80), (48, 160)]
    img = np.zeros((h, w, 3))
    for amp, coarse in zip((0.4, 0.3, 0.2, 0.1), octaves):
        img += amp * np.stack(
            [smooth_field(rng, h, w, coarse=coarse) for _ in range(3)], -1
        )
    base = (img / img.max() * 255).astype(np.uint8)

    ys, xs = np.mgrid[0:h, 0:w]
    frames = [base]
    for i, flow in enumerate(flows):
        pix = np.stack([xs, ys], -1) + flow
        px = np.round(pix[..., 0]).astype(int)
        py = np.round(pix[..., 1]).astype(int)
        z = depths[i]
        ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        nxt = base.copy()
        order = np.argsort(-z[ok])
        nxt[py[ok].ravel()[order], px[ok].ravel()[order]] = frames[-1][ok][
            order
        ]
        frames.append(nxt)
    return frames


def structured_flow_diff(rng, h, w, n_bad=3, base_lo=0.005, base_hi=0.05,
                         bad_lo=1.0, bad_hi=5.0):
    """Forward-backward flow-consistency map with distinct good/bad regions.

    Returns (flow_diff [h x w] float32, bad_mask [h x w] bool). The good
    background is a smooth low-consistency-error field; ``n_bad``
    rectangles carry errors far above any sensible ``kp.flow_consist_thre``
    so keypoint selection (ref kp_selection.py:74-179 local_bestN) must
    reject them for tracking to stay accurate.
    """
    diff = smooth_field(rng, h, w, coarse=(8, 24), lo=base_lo, hi=base_hi)
    bad = np.zeros((h, w), bool)
    for _ in range(n_bad):
        bh = rng.randint(h // 8, h // 3)
        bw = rng.randint(w // 8, w // 3)
        y0 = rng.randint(0, h - bh)
        x0 = rng.randint(0, w - bw)
        bad[y0 : y0 + bh, x0 : x0 + bw] = True
    diff = np.where(bad, rng.uniform(bad_lo, bad_hi, (h, w)), diff)
    return diff.astype(np.float32), bad


def corrupt_flow(flow, bad_mask, rng, scale=12.0):
    """Replace flow inside ``bad_mask`` with large random garbage — the
    signal structured_flow_diff flags. Keypoints picked there would wreck
    the essential estimate; selection must route around them."""
    noise = rng.randn(*flow.shape).astype(np.float32) * scale
    return np.where(bad_mask[..., None], flow + noise, flow)


def chain_motions(motions):
    """Ground-truth global poses from per-pair motions (ref chaining rule,
    dfvo.py:109-119)."""
    g = np.eye(4)
    out = [g.copy()]
    for T in motions:
        g = g @ T
        out.append(g.copy())
    return out
