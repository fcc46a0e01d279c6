"""Bilinear sampling and flow-based warping.

Counterpart of ``dfvo_tpu/ops/warp.py`` with the semantics of its
``_grid_sample_gather4``: NHWC layout and sample coordinates in pixel units
([x, y]), which is torch ``grid_sample(align_corners=True)`` without the
[-1, 1] normalisation. The TPU's packed 2x2-patch tables are a gather-cost
workaround of that chip and are not carried over; they give the same values.
"""

import torch


def coords_grid(h, w, dtype=torch.float32, device=None):
    """[H x W x 2] pixel grid holding [x, y] per pixel."""
    x = torch.arange(w, dtype=dtype, device=device)
    y = torch.arange(h, dtype=dtype, device=device)
    yv, xv = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xv, yv], dim=-1)


def flow_to_coords(flow):
    """Flow ([...xHxWx2], [x, y]) -> absolute sample coordinates (pixels),
    in the flow's dtype."""
    h, w = flow.shape[-3], flow.shape[-2]
    return flow + coords_grid(h, w, flow.dtype, flow.device)


def grid_sample(src, coords, padding_mode="zeros", frame_ids=None):
    """Bilinear sampling of ``src`` at pixel coordinates ``coords``.

    Args:
        src: [N x H x W x C] source map.
        coords: [B x ... x 2] sample locations as [x, y] in pixels of
            ``src``. B == N unless ``frame_ids`` is given.
        padding_mode: 'zeros' (out-of-bounds corners read 0) or 'border'
            (clamped), as torch grid_sample's modes.
        frame_ids: optional [B] integer map from each coords batch row to a
            ``src`` frame, so several rows sample one frame without copies.

    Returns:
        [B x ... x C] sampled values.
    """
    n, h, w, c = src.shape
    out_shape = coords.shape[:-1]
    x = coords[..., 0]
    y = coords[..., 1]

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0

    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1

    if padding_mode == "zeros":
        def corner_mask(xi, yi):
            return (
                (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            ).to(src.dtype)

        masks = [
            corner_mask(x0, y0),
            corner_mask(x1, y0),
            corner_mask(x0, y1),
            corner_mask(x1, y1),
        ]
    elif padding_mode == "border":
        masks = [1.0, 1.0, 1.0, 1.0]
    else:
        raise ValueError(f"unknown padding_mode: {padding_mode}")

    x0c = x0.clamp(0, w - 1).long()
    x1c = x1.clamp(0, w - 1).long()
    y0c = y0.clamp(0, h - 1).long()
    y1c = y1.clamp(0, h - 1).long()

    src_flat = src.reshape(n * h * w, c)
    if frame_ids is None:
        frame = torch.arange(out_shape[0], device=src.device)
    else:
        frame = frame_ids.to(device=src.device, dtype=torch.long)
    base = (frame * (h * w)).reshape((out_shape[0],) + (1,) * (len(out_shape) - 1))

    def gather(yi, xi):
        # clamped like the JAX gather's mode="clip": a NaN coordinate must
        # not index outside the table
        idx = (base + yi * w + xi).reshape(-1).clamp(0, src_flat.shape[0] - 1)
        return src_flat.index_select(0, idx).reshape(out_shape + (c,))

    v00 = gather(y0c, x0c)
    v10 = gather(y0c, x1c)
    v01 = gather(y1c, x0c)
    v11 = gather(y1c, x1c)

    w00 = (wy0 * wx0 * masks[0])[..., None]
    w10 = (wy0 * wx1 * masks[1])[..., None]
    w01 = (wy1 * wx0 * masks[2])[..., None]
    w11 = (wy1 * wx1 * masks[3])[..., None]

    return v00 * w00 + v10 * w10 + v01 * w01 + v11 * w11


def warp_image_by_flow(img, flow, padding_mode="zeros", frame_ids=None):
    """Backward-warp ``img`` by ``flow`` ([BxHxWx2]): output pixel p takes
    the value of ``img`` at p + flow(p). ``img`` is [BxHxWxC], or unique
    source frames [MxHxWxC] addressed per batch row via ``frame_ids``."""
    return grid_sample(
        img, flow_to_coords(flow), padding_mode=padding_mode,
        frame_ids=frame_ids,
    )
