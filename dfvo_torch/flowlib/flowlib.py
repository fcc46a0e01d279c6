"""Optical-flow files, errors and visualisation.

Counterpart of ``dfvo_tpu/flowlib/flowlib.py`` (the reference's
``libs/flowlib/flowlib.py``): the Middlebury colour coding, ``.flo``, KITTI
16-bit PNG and PFM readers and writers, disparity files, the endpoint and
KITTI outlier errors, flips and resizing. Host numpy; cv2 and PIL are
imported by the functions that use them.
"""

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7
TAG_FLOAT = 202021.25


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


def read_flow(filename):
    """Read a flow file, dispatching on the extension (ref flowlib.py:32-51):

    * ``.flo``  -> [H x W x 2] Middlebury float flow;
    * ``.png``  -> [H x W x 3] KITTI flow with the validity mask as channel 2;
    * ``.pfm``  -> [H x W x 2] (first two channels of the color PFM).
    """
    if filename.endswith(".png"):
        flow, valid = read_kitti_png_flow(filename)
        return np.concatenate(
            [flow.astype(np.float32), valid[..., None].astype(np.float32)],
            axis=-1,
        )
    if filename.endswith(".pfm"):
        return read_pfm_file(filename)[:, :, :2].astype(np.float32)
    if not filename.endswith(".flo"):
        raise ValueError(f"invalid flow file format: {filename}")
    return read_flo_file(filename)


def read_flo_file(filename):
    """Read a Middlebury .flo file -> [H x W x 2] (ref flowlib.py:397-426)."""
    with open(filename, "rb") as f:
        tag = np.fromfile(f, np.float32, count=1)[0]
        if tag != TAG_FLOAT:
            raise ValueError(f"invalid .flo file: {filename}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(flow, filename):
    """Write a Middlebury .flo file (ref flowlib.py:428-451)."""
    with open(filename, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        h, w = flow.shape[:2]
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def write_kitti_png_flow(flow, filename, mask=None):
    """Write KITTI-format 16-bit PNG flow: (u, v) * 64 + 2^15, channel 3 =
    validity (ref flowlib.py:467-491 via tools/generate_flow_prediction.py)."""
    import cv2

    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3), np.uint16)
    out[..., 2] = np.clip(flow[..., 0] * 64.0 + 2**15, 0, 65535).astype(
        np.uint16
    )
    out[..., 1] = np.clip(flow[..., 1] * 64.0 + 2**15, 0, 65535).astype(
        np.uint16
    )
    out[..., 0] = 1 if mask is None else mask.astype(np.uint16)
    cv2.imwrite(filename, out)


def read_kitti_png_flow(filename):
    """Read KITTI-format 16-bit PNG flow -> ([H x W x 2] flow, [H x W] valid)."""
    import cv2

    raw = cv2.imread(filename, -1)
    flow = np.zeros(raw.shape[:2] + (2,), np.float64)
    flow[..., 0] = (raw[..., 2].astype(np.float64) - 2**15) / 64.0
    flow[..., 1] = (raw[..., 1].astype(np.float64) - 2**15) / 64.0
    return flow, raw[..., 0].astype(bool)


def read_pfm_file(filename):
    """Read a PFM image (ref flowlib.py:454-491): 'PF' = 3-channel color,
    'Pf' = single channel; a negative scale line marks little-endian data;
    rows are stored bottom-up, so the result is flipped vertically.

    Returns:
        [H x W x 3] (color) or [H x W] (grayscale) float array.
    """
    with open(filename, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {filename}")
        dims = f.readline().decode("ascii").split()
        if len(dims) != 2:
            raise ValueError(f"malformed PFM header: {filename}")
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if channels == 3 else (h, w)
    return np.flipud(data.reshape(shape))


def write_pfm_file(data, filename, scale=1.0):
    """Write a PFM image (inverse of read_pfm_file; always little-endian)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    elif data.ndim == 2 or (data.ndim == 3 and data.shape[2] == 1):
        header = b"Pf"
        data = data.reshape(data.shape[0], data.shape[1])
    else:
        raise ValueError(f"PFM needs HxW or HxWx3 data, got {data.shape}")
    with open(filename, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode("ascii"))
        f.write(f"{-abs(scale)}\n".encode("ascii"))
        np.flipud(data).astype("<f4").tofile(f)


def read_disp(filename):
    """Read a disparity file -> [H x W x 1 or 2] (ref flowlib.py:268-280):
    ``.pfm`` gives negated disparity with no mask channel; KITTI ``.png``
    gives disparity/256 with a (disp > 0) validity channel."""
    if filename.endswith(".pfm"):
        return np.expand_dims(-read_pfm_file(filename), axis=-1)
    if filename.endswith(".png"):
        import cv2

        raw = cv2.imread(filename, -1)
        mask = np.float32(raw > 0)
        return np.stack([np.float32(raw) / 256.0, mask], axis=-1)
    raise ValueError(f"invalid disp file format: {filename}")


def disp2flow(disp):
    """Disparity [H x W x 1(+mask)] -> flow [H x W x 2(+mask)] with u = -disp
    and v = 0 (ref flowlib.py:283-288)."""
    zeros = np.zeros(disp.shape[:2], np.float32)
    flow = np.stack([-disp[:, :, 0], zeros], axis=-1)
    if disp.shape[2] > 1:
        flow = np.append(flow, disp[:, :, 1:], axis=-1)
    return flow


def flow_error(tu, tv, u, v, mask=None):
    """Average endpoint error between ground-truth (tu, tv) and estimated
    (u, v) flow fields, ignoring unknown-flow pixels
    (ref flowlib.py:96-150)."""
    valid = (np.abs(tu) < UNKNOWN_FLOW_THRESH) & (
        np.abs(tv) < UNKNOWN_FLOW_THRESH
    )
    if mask is not None:
        valid &= mask.astype(bool)
    du = tu[valid] - u[valid]
    dv = tv[valid] - v[valid]
    epe = np.sqrt(du**2 + dv**2)
    return float(np.mean(epe)) if epe.size else 0.0


def flow_kitti_error(tu, tv, u, v, mask=None, tau=(3.0, 0.05)):
    """KITTI flow outlier ratio (Fl): fraction of valid pixels whose
    endpoint error exceeds tau[0] px AND tau[1] of the GT magnitude
    (ref flowlib.py:542-581)."""
    valid = (np.abs(tu) < UNKNOWN_FLOW_THRESH) & (
        np.abs(tv) < UNKNOWN_FLOW_THRESH
    )
    if mask is not None:
        valid &= mask.astype(bool)
    du = tu[valid] - u[valid]
    dv = tv[valid] - v[valid]
    epe = np.sqrt(du**2 + dv**2)
    mag = np.sqrt(tu[valid] ** 2 + tv[valid] ** 2) + 1e-5
    outliers = (epe > tau[0]) & (epe / mag > tau[1])
    return float(np.mean(outliers)) if epe.size else 0.0


def evaluate_flow(gt_flow, pred_flow):
    """Mean endpoint error over pixels with nonzero GT flow
    (ref flowlib.py:96-143 ``flow_error`` + :236-243 ``evaluate_flow``):
    unknown-flow pixels are zeroed in BOTH fields before the nonzero-GT
    selection, exactly as the reference does."""
    tu = gt_flow[:, :, 0].astype(np.float64).copy()
    tv = gt_flow[:, :, 1].astype(np.float64).copy()
    u = pred_flow[:, :, 0].astype(np.float64).copy()
    v = pred_flow[:, :, 1].astype(np.float64).copy()
    unknown = (np.abs(tu) > UNKNOWN_FLOW_THRESH) | (
        np.abs(tv) > UNKNOWN_FLOW_THRESH
    )
    tu[unknown] = 0
    tv[unknown] = 0
    u[unknown] = 0
    v[unknown] = 0
    nonzero = (np.abs(tu) > 0) | (np.abs(tv) > 0)
    epe = np.sqrt((tu - u) ** 2 + (tv - v) ** 2)[nonzero]
    return float(np.mean(epe)) if epe.size else 0.0


def evaluate_flow_file(gt_file, pred_file):
    """EPE between two flow files (ref flowlib.py:222-234)."""
    return evaluate_flow(read_flow(gt_file), read_flow(pred_file))


def _kitti_epe_acc(tu, tv, u, v, valid, tau=(3.0, 0.05)):
    """(mean EPE, accuracy = 1 - KITTI outlier fraction) over ``valid``
    pixels (ref flowlib.py:146-184 ``flow_kitti_error``)."""
    n_total = np.sum(valid)
    epe = np.sqrt((tu - u) ** 2 + (tv - v) ** 2)[valid]
    mag = (np.sqrt(tu**2 + tv**2) + 1e-5)[valid]
    err = (epe > tau[0]) & ((epe / mag) > tau[1])
    if n_total == 0:
        return 0.0, 1.0
    return float(np.mean(epe)), 1.0 - float(np.sum(err)) / float(n_total)


def evaluate_kitti_flow(gt_flow, pred_flow, rigid_flow=None):
    """KITTI (EPE, accuracy) for a GT flow with or without a validity
    channel (ref flowlib.py:246-257). ``rigid_flow`` is accepted for
    signature parity (the reference ignores it too)."""
    tu = gt_flow[:, :, 0].astype(np.float64)
    tv = gt_flow[:, :, 1].astype(np.float64)
    u = pred_flow[:, :, 0].astype(np.float64)
    v = pred_flow[:, :, 1].astype(np.float64)
    if gt_flow.shape[2] == 2:
        valid = np.ones(gt_flow.shape[:2], bool)
    else:
        valid = gt_flow[:, :, 2] != 0
    return _kitti_epe_acc(tu, tv, u, v, valid)


def flow_kitti_mask_error(tu, tv, gt_mask, u, v, pd_mask):
    """(EPE, accuracy) over pixels valid in BOTH masks
    (ref flowlib.py:542-581)."""
    valid = (np.asarray(gt_mask) != 0) & (np.asarray(pd_mask) != 0)
    return _kitti_epe_acc(
        np.asarray(tu, np.float64),
        np.asarray(tv, np.float64),
        np.asarray(u, np.float64),
        np.asarray(v, np.float64),
        valid,
    )


def horizontal_flip_flow(flow):
    """Mirror a flow field left-right, negating u (ref flowlib.py:513-516)."""
    flow = np.copy(np.fliplr(flow))
    flow[:, :, 0] *= -1
    return flow


def vertical_flip_flow(flow):
    """Mirror a flow field top-bottom, negating v (ref flowlib.py:519-522)."""
    flow = np.copy(np.flipud(flow))
    flow[:, :, 1] *= -1
    return flow


def remove_ambiguity_flow(flow_img, err_img, threshold_err=10.0):
    """Zero flow where the error map exceeds the threshold; returns the
    thresholded flow and a uint8 validity mask (ref flowlib.py:525-530).
    Mutates ``flow_img`` in place, like the reference."""
    mask_img = np.ones(err_img.shape, np.uint8)
    bad = err_img > threshold_err
    mask_img[bad] = 0
    flow_img[bad] = 0.0
    return flow_img, mask_img


def save_flow_image(flow, image_file):
    """Render a flow field to an image file (ref flowlib.py:72-82)."""
    from PIL import Image

    Image.fromarray(flow_to_image(flow)).save(image_file)


def flowfile_to_imagefile(flow_file, image_file):
    """Read a flow file and save its visualization (ref flowlib.py:85-94)."""
    save_flow_image(read_flow(flow_file), image_file)


def resize_flow(flow, new_h, new_w):
    """Resize flow with magnitude rescaling (ref flowlib.py:492-511)."""
    import cv2

    h, w = flow.shape[:2]
    out = cv2.resize(flow, (new_w, new_h))
    out[..., 0] *= new_w / w
    out[..., 1] *= new_h / h
    return out
