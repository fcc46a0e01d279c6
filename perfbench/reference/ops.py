"""The plain formulas of the reference: the cost volume (A), the
regularization filter (B), the head conv (C), bilinear sampling and resize.

Each is a direct transcription of its definition in float32 (float64 for a
float64 input), with no kernel, no tiling and no fused path. Tensors are
NHWC.
"""

import torch
import torch.nn.functional as F


def _acc(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def correlation_plain(f1, f2, max_disp=3, stride=1):
    """A: out[n, y, x, (dy+D)(2D+1) + (dx+D)] =
    mean_c f1[n, ys, xs, c] * f2[n, ys + dy*s, xs + dx*s, c], f2 zero-padded,
    output ceil(H/s) x ceil(W/s)."""
    n, h, w, c = f1.shape
    d, pad = max_disp, max_disp * stride
    acc = _acc(f1.dtype)
    f1s = f1[:, ::stride, ::stride, :].to(acc)
    f2p = F.pad(f2.to(acc), (0, 0, pad, pad, pad, pad))
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            y0, x0 = pad + dy * stride, pad + dx * stride
            f2s = f2p[:, y0 : y0 + h : stride, x0 : x0 + w : stride, :]
            outs.append((f1s * f2s).mean(dim=-1))
    return torch.stack(outs, dim=-1).to(f1.dtype)


def reg_dist_filter_plain(raw, flow, wx, bx, wy, by, k):
    """B: dist = exp(-(raw^2) - max_j(-(raw_j^2))) over the k^2 taps, then
    out_x = (bx + sum_j dist_j wx_j flow_x(p + off_j)) / sum_j dist_j, and the
    same for y; flow zero-padded, taps ky-major."""
    n, h, w, kk = raw.shape
    p = (k - 1) // 2
    acc = _acc(flow.dtype)
    dist = -(raw.to(acc) ** 2)
    dist = torch.exp(dist - torch.amax(dist, dim=-1, keepdim=True))
    fp = F.pad(flow.to(acc), (0, 0, p, p, p, p))
    taps = torch.stack([fp[:, j // k : j // k + h, j % k : j % k + w] for j in range(kk)],
                       dim=3)  # [N,H,W,k^2,2]
    wts = torch.stack([wx.reshape(kk), wy.reshape(kk)], dim=-1).to(acc)  # [k^2,2]
    b = torch.stack([bx.reshape(()), by.reshape(())]).to(acc)
    num = b + (dist[..., None] * wts * taps).sum(dim=3)
    return (num / dist.sum(dim=-1, keepdim=True)).to(flow.dtype)


def head_conv_plain(x, kernel, bias=None, prepadded=False):
    """C: [N,H,W,Cin] x [k,k,Cin,Cout] stride-1 convolution, 'same' zero
    padding or none for an input padded by the caller."""
    k = kernel.shape[0]
    acc = _acc(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(acc), kernel.permute(3, 2, 0, 1).to(acc),
                 None if bias is None else bias.to(acc),
                 padding=0 if prepadded else (k - 1) // 2)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def coords_grid(h, w, dtype=torch.float32, device=None):
    """[H x W x 2] pixel grid holding [x, y]."""
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def flow_to_coords(flow):
    return flow + coords_grid(flow.shape[-3], flow.shape[-2], flow.dtype, flow.device)


def grid_sample(src, coords, padding_mode="zeros", frame_ids=None):
    """Bilinear sampling of ``src`` [N,H,W,C] at pixel coordinates ``coords``
    [B,...,2] ([x, y]), torch ``grid_sample(align_corners=True)`` semantics
    in pixel units; ``frame_ids`` [B] maps each row of ``coords`` to a frame
    of ``src``. Out-of-image corners read 0 ('zeros') or the clamped pixel
    ('border')."""
    if frame_ids is not None:
        src = src.index_select(0, frame_ids.long())
    n, h, w, c = src.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = src.reshape(n, h * w, c)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
            if padding_mode == "zeros":
                wgt = wgt * ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)).to(wgt.dtype)
            elif padding_mode != "border":
                raise ValueError(f"unknown padding_mode: {padding_mode}")
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(n, -1)
            val = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            out = out + val.reshape(*coords.shape[:-1], c) * wgt[..., None]
    return out


def warp_image_by_flow(img, flow, padding_mode="zeros", frame_ids=None):
    """Output pixel p takes ``img`` at p + flow(p)."""
    return grid_sample(img, flow_to_coords(flow), padding_mode, frame_ids)


def resize_bilinear(x, out_h, out_w, align_corners=False):
    """Bilinear resize of an NHWC tensor (``F.interpolate``, no antialias)."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)
