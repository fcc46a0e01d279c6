"""The traffic generator: one coherent synthetic drive, made on the device
from a seed and a traffic file's parameters.

A drive is a pool of ``chunks`` x ``chunk`` + 1 frames. It starts from a
smooth random depth field. Each next frame's depth is the previous frame's
point cloud moved by the ground-truth motion and rendered into the new
camera (the nearest point wins a pixel, holes are filled from their
neighbours, depth that left a sane range is replaced by fresh scene), so
the exact reprojection flow and the depth chain agree metrically along the
whole drive. Frames are a multi-octave texture carried along the flow the
same way. Each pair also gets a forward-backward inconsistency map with a
few rectangles of gross error, and its flow is corrupted inside them, so
keypoint selection has something to reject.

Motion is DF-VO's KITTI-like cruise (forward with curvature and speed
variation), or, where the traffic asks for stops, a run of frames with
zero motion at a seeded place in every chunk: no parallax, so two-view
geometry cannot hold and the PnP fallback takes those frames.

Everything but the per-pair motions (tiny, on the host) is made on the
device in float64 geometry with ``torch.Generator`` streams of the seed,
so one seed gives the same drive on one device and software stack.
"""

import json
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
KEY_BITS = 21  # pixel index bits of the z-buffer key (images up to 2**21 pixels)


def load_traffic(name):
    """The parameters of traffic mix ``name`` (``traffic/<name>.json``)."""
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def intrinsics(h, w):
    """A KITTI-like pinhole camera for an h x w image (focal 0.58 w across,
    1.92 h down: about 718 px at KITTI's full 370 x 1226)."""
    return np.array([[0.58 * w, 0, 0.5 * w], [0, 1.92 * h, 0.5 * h], [0, 0, 1]], np.float64)


def cruise_motion(i, speed):
    """Ground-truth T_cur2ref of cruise step ``i``: forward about ``speed``
    metres with lateral sway, yaw and pitch."""
    v = speed * (1.0 + 0.3 * math.sin(i / 3.0))
    yaw, pitch = 0.004 * math.sin(i / 5.0), 0.002 * math.cos(i / 7.0)
    cy, sy, cx, sx = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    T = np.eye(4)
    T[:3, :3] = Rx @ Ry
    T[:3, 3] = [0.05 * math.sin(i / 4.0), -0.02, v]
    return T


def plan_motions(traffic, chunk, seed):
    """(motions [n] T_cur2ref, stopped [n] bool) of the pool's n pairs, in
    ``traffic["chunks"]`` chunks of ``chunk``. A stop of ``stop_frames``
    pairs sits at a seeded place in every chunk; cruise steps are numbered
    over the moving pairs only."""
    chunks = traffic["chunks"]
    stop = traffic.get("stop_frames", 0)
    rng = np.random.default_rng([int(seed), 0x5709])
    stopped = np.zeros(chunk * chunks, bool)
    if stop:
        for c in range(chunks):
            # never the chunk's first pair: the pair before a stop moves
            at = int(rng.integers(1, chunk - stop + 1))
            stopped[c * chunk + at : c * chunk + at + stop] = True
    motions, step = [], 0
    for s in stopped:
        if s:
            motions.append(np.eye(4))
        else:
            motions.append(cruise_motion(step, traffic["speed"]))
            step += 1
    return np.stack(motions), stopped


def _generator(device, seed, stream):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + stream) % (2**63))
    return g


def smooth_field(g, h, w, coarse, lo, hi, n=1):
    """[n, h, w] smooth random fields in [lo, hi]: coarse uniform noise,
    bilinearly upsampled and stretched to the range."""
    dev = g.device
    f = F.interpolate(torch.rand(n, 1, *coarse, generator=g, device=dev, dtype=torch.float64),
                      size=(h, w), mode="bilinear", align_corners=True)[:, 0]
    mn = f.amin(dim=(1, 2), keepdim=True)
    mx = f.amax(dim=(1, 2), keepdim=True)
    return lo + (f - mn) / (mx - mn).clamp_min(1e-12) * (hi - lo)


def _fill_holes(d):
    """Holes (<= 0) take their 3 x 3 neighbourhood's maximum, 12 times;
    what is left takes the median of the filled pixels."""
    for _ in range(12):
        dil = F.max_pool2d(d[None, None], 3, 1, 1)[0, 0]
        d = torch.where(d <= 0, dil, d)
    med = torch.nanmedian(torch.where(d > 0, d, torch.nan))
    return torch.where(d > 0, d, torch.nan_to_num(med, nan=1.0))


def _render(depth, pix, z, h, w):
    """The z-buffer of points at pixel positions ``pix`` [h, w, 2] with
    depths ``z`` [h, w]: per target pixel, the index of the nearest point
    that lands there, or -1."""
    px, py = torch.round(pix[..., 0]).long(), torch.round(pix[..., 1]).long()
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
    src = torch.arange(h * w, device=depth.device)
    zkey = z.float().clamp_min(0).view(torch.int32).long()  # positive floats order as ints
    key = torch.where(ok.reshape(-1), (zkey.reshape(-1) << KEY_BITS) | src,
                      torch.iinfo(torch.int64).max)
    target = torch.where(ok, py * w + px, 0).reshape(-1)
    best = torch.full((h * w,), torch.iinfo(torch.int64).max, device=depth.device)
    best = best.scatter_reduce(0, target, key, "amin")
    hit = best != torch.iinfo(torch.int64).max
    return torch.where(hit, best & ((1 << KEY_BITS) - 1), -1)


def make_drive(traffic, chunk, seed, device):
    """The pool of one cell's traffic in chunks of ``chunk`` pairs, on
    ``device``.

    Returns a dict: ``frames`` [n+1, h, w, 3] uint8, ``depths`` [n+1, h, w],
    ``flows`` [n, h, w, 2] (ref -> cur, corrupted in the bad rectangles),
    ``flow_diff`` [n, h, w] float32 tensors; ``motions`` [n, 4, 4] float64
    and ``stopped`` [n] bool numpy arrays; ``K`` [3, 3] float64 numpy.
    """
    h, w = traffic["frame_hw"]
    if h * w >= 1 << KEY_BITS:
        raise ValueError(f"frames of {h}x{w} exceed the z-buffer key's {KEY_BITS} bits")
    motions, stopped = plan_motions(traffic, chunk, seed)
    n = len(motions)
    K = intrinsics(h, w)
    dev = torch.device(device)
    f64 = torch.float64
    g_scene, g_tex, g_diff = (_generator(dev, seed, s) for s in (1, 2, 3))
    Kt = torch.as_tensor(K, device=dev)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=f64),
                            torch.arange(w, device=dev, dtype=f64), indexing="ij")
    grid = torch.stack([xs, ys], -1)
    rays = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ torch.linalg.inv(Kt).T
    T_ref2cur = torch.linalg.inv(torch.as_tensor(motions, device=dev))
    lo, hi = traffic["depth_range"]

    tex = sum(a * smooth_field(g_tex, h, w, c, 0.0, 1.0, 3)
              for a, c in zip((0.4, 0.3, 0.2, 0.1), ((6, 20), (12, 40), (24, 80), (48, 160))))
    base = (tex / tex.amax() * 255).to(torch.uint8).permute(1, 2, 0).reshape(h * w, 3)

    depth = smooth_field(g_scene, h, w, (6, 20), lo, hi)[0]
    frame = base
    depths, frames, flows = [depth], [frame], []
    for i in range(n):
        pts = (rays * depth[..., None]) @ T_ref2cur[i, :3, :3].T + T_ref2cur[i, :3, 3]
        uv = pts @ Kt.T
        z = uv[..., 2]
        pix = uv[..., :2] / z.clamp_min(1e-9)[..., None]
        flows.append(pix - grid)
        won = _render(depth, pix, z, h, w)
        hit = won >= 0
        d_next = torch.where(hit, z.reshape(-1)[won.clamp_min(0)], 0.0).reshape(h, w)
        d_next = _fill_holes(d_next)
        stale = ~torch.isfinite(d_next) | (d_next < 2.0) | (d_next > 80.0)
        d_next = torch.where(stale, smooth_field(g_scene, h, w, (6, 20), lo, hi)[0], d_next)
        frame = torch.where(hit[:, None], frame[won.clamp_min(0)], base)
        depth = d_next
        depths.append(depth)
        frames.append(frame)

    bad = traffic["bad_regions"]
    diff = smooth_field(g_diff, h, w, (8, 24), *traffic["diff_good"], n)
    mask = torch.zeros(n, h, w, dtype=torch.bool, device=dev)
    for _ in range(bad):
        bh = torch.randint(h // 8, h // 3, (n, 1, 1), generator=g_diff, device=dev)
        bw = torch.randint(w // 8, w // 3, (n, 1, 1), generator=g_diff, device=dev)
        y0 = (torch.rand(n, 1, 1, generator=g_diff, device=dev) * (h - bh)).long()
        x0 = (torch.rand(n, 1, 1, generator=g_diff, device=dev) * (w - bw)).long()
        mask |= ((ys >= y0) & (ys < y0 + bh) & (xs >= x0) & (xs < x0 + bw))
    b_lo, b_hi = traffic["diff_bad"]
    diff = torch.where(mask, b_lo + (b_hi - b_lo) * torch.rand(
        n, h, w, generator=g_diff, device=dev, dtype=f64), diff)
    flows = torch.stack(flows)
    noise = torch.randn(n, h, w, 2, generator=g_diff, device=dev, dtype=f64)
    flows = torch.where(mask[..., None], flows + traffic["corrupt_px"] * noise, flows)
    return {
        "frames": torch.stack(frames).reshape(n + 1, h, w, 3),
        "depths": torch.stack(depths).float(),
        "flows": flows.float(),
        "flow_diff": diff.float(),
        "motions": motions,
        "stopped": stopped,
        "K": K,
    }
