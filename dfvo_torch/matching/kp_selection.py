"""Correspondence (keypoint) selection as fixed-shape tensor code.

Counterpart of the ``local_bestN`` path of
``dfvo_tpu/matching/kp_selection.py``: the image is cut into a grid of
cells, and each cell contributes its best-n pixels by forward-backward flow
consistency. Outputs are fixed-size [N x 2] keypoint arrays plus validity
masks (padding slots carry ``valid=False``).

Cell geometry matches the reference DF-VO exactly, including its
off-by-one: the slice ``[int(h/R*r) : int(h/R*(r+1)) - 1]`` excludes the last
row/column of every cell and the image border.
"""

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _cell_geometry(h, w, num_row, num_col):
    """Reference cell bounds (with its off-by-one) plus the padded per-cell
    view shape."""
    y_bounds = tuple(
        (int(h / num_row * r), int(h / num_row * (r + 1)) - 1)
        for r in range(num_row)
    )
    x_bounds = tuple(
        (int(w / num_col * c), int(w / num_col * (c + 1)) - 1)
        for c in range(num_col)
    )
    hc = max(y1 - y0 for y0, y1 in y_bounds)
    wc = max(x1 - x0 for x0, x1 in x_bounds)
    return y_bounds, x_bounds, hc, wc


@functools.lru_cache(maxsize=None)
def cell_index_table(h, w, num_row, num_col):
    """Static numpy [n_cells x (Hc*Wc)] table of flat pixel indices per cell
    in the padded view layout of :func:`gather_cells_view`, -1 where a cell
    is smaller than Hc x Wc. Raster order within each cell."""
    y_bounds, x_bounds, hc, wc = _cell_geometry(h, w, num_row, num_col)
    table = np.full((num_row * num_col, hc * wc), -1, dtype=np.int64)
    for r, (y0, y1) in enumerate(y_bounds):
        for c, (x0, x1) in enumerate(x_bounds):
            ys, xs = np.mgrid[y0 : y0 + hc, x0 : x0 + wc]
            valid = (ys < y1) & (xs < x1)
            table[r * num_col + c] = np.where(valid, ys * w + xs, -1).ravel()
    table.setflags(write=False)
    return table


def gather_cells_view(values2d, h, w, num_row, num_col):
    """[H x W] map -> [n_cells x (Hc*Wc)] per-cell view by static slicing.
    Pad slots hold neighbouring pixels (or zeros past the image) and must be
    masked by the caller via ``table >= 0``."""
    y_bounds, x_bounds, hc, wc = _cell_geometry(h, w, num_row, num_col)
    rows = []
    for y0, _ in y_bounds:
        sl = values2d[y0 : y0 + hc]
        if sl.shape[0] < hc:  # bottom cells: pad reads past the image
            sl = torch.nn.functional.pad(sl, (0, 0, 0, hc - sl.shape[0]))
        rows.append(sl)
    stacked = torch.stack(rows)  # [R, Hc, W]
    cols = []
    for x0, _ in x_bounds:
        sl = stacked[:, :, x0 : x0 + wc]
        if sl.shape[2] < wc:
            sl = torch.nn.functional.pad(sl, (0, wc - sl.shape[2]))
        cols.append(sl)
    view = torch.stack(cols, dim=1)  # [R, C, Hc, Wc]
    return view.reshape(num_row * num_col, hc * wc)


class KPSelectionSpec:
    """Static configuration for keypoint selection (shapes, budget)."""

    def __init__(self, h, w, num_row=10, num_col=10, num_bestN=2000):
        self.h = h
        self.w = w
        self.num_row = num_row
        self.num_col = num_col
        self.num_bestN = num_bestN
        self.n_per_cell = math.floor(num_bestN / (num_row * num_col))
        self.table = cell_index_table(h, w, num_row, num_col)
        self._tables = {}

    def table_on(self, device):
        """The cell table as a tensor on ``device`` (built once per device)."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = torch.as_tensor(self.table.copy(), device=device)
        return self._tables[device]


def _select_best_per_cell(score_cells, valid_cells, k):
    """Per-cell smallest-k scores among valid entries, as k rounds of masked
    argmin extraction (first minimal index wins a tie; a cell with no valid
    entry left yields index 0, marked invalid).

    Returns (local_idx [n_cells x k], sel_valid [n_cells x k]).
    """
    scores = torch.where(
        valid_cells, score_cells, torch.full_like(score_cells, math.inf)
    )
    idx, val = [], []
    for _ in range(k):
        j = torch.argmin(scores, dim=1, keepdim=True)
        val.append(torch.gather(scores, 1, j)[:, 0])
        # scatter_ takes the value as a kernel argument; an indexed
        # assignment would copy it to the card and synchronise
        scores.scatter_(1, j, math.inf)
        idx.append(j[:, 0])
    return torch.stack(idx, dim=1), torch.isfinite(torch.stack(val, dim=1))


def _kp_outputs(spec, flow, table, local_idx, sel_valid):
    """Per-cell selections -> flat kp1/kp2 arrays + validity."""
    sel_flat_idx = torch.gather(table.clamp(min=0), 1, local_idx).reshape(-1)
    x = (sel_flat_idx % spec.w).to(flow.dtype)
    y = (sel_flat_idx // spec.w).to(flow.dtype)
    kp1 = torch.stack([x, y], dim=-1)
    kp2 = kp1 + flow.reshape(-1, 2)[sel_flat_idx]
    return kp1, kp2, sel_valid.reshape(-1)


def local_bestN(spec, flow, flow_diff, thre=0.1, score_method="flow",
                depth_diff=None, depth_diff_thre=0.05):
    """Best-N keypoints from uniformly divided regions.

    Args:
        spec: KPSelectionSpec (cell table, N).
        flow: [H x W x 2] forward flow (ref view -> cur view).
        flow_diff: [H x W] forward-backward flow inconsistency.
        thre: flow-consistency threshold.
        score_method: 'flow' | 'flow_ratio'.
        depth_diff: optional [H x W] depth inconsistency; selections then
            also require depth_diff < depth_diff_thre.

    Returns:
        dict with ``kp1`` [N x 2], ``kp2`` [N x 2], ``valid`` [N],
        ``good_kp_found`` (0-d bool: both insufficient-keypoint checks) and
        ``fb_flow_mask`` [H x W].
    """
    table = spec.table_on(flow.device)
    cells = functools.partial(
        gather_cells_view, h=spec.h, w=spec.w, num_row=spec.num_row,
        num_col=spec.num_col,
    )
    fd_cells = cells(flow_diff)
    if score_method == "flow":
        score_cells = fd_cells
    elif score_method == "flow_ratio":
        mag = torch.linalg.norm(flow, dim=-1)
        score_cells = fd_cells / torch.clamp(cells(mag), min=1e-12)
    else:
        raise ValueError(f"unknown score_method: {score_method}")

    valid_cells = (score_cells < thre) & (table >= 0)
    if depth_diff is not None:
        valid_cells &= cells(depth_diff) < depth_diff_thre

    local_idx, sel_valid = _select_best_per_cell(
        score_cells, valid_cells, spec.n_per_cell
    )
    kp1, kp2, valid = _kp_outputs(spec, flow, table, local_idx, sel_valid)

    # insufficient-keypoint case 1: too few sub-threshold pixels overall
    enough_pixels = torch.sum(flow_diff < thre) >= spec.num_bestN * 0.1
    # case 2: too few regions contribute any keypoint
    good_regions = torch.sum(torch.any(sel_valid, dim=1))
    diverse = good_regions >= spec.num_row * spec.num_col * 0.1

    fb_mask = (
        flow_diff
        if score_method == "flow"
        else flow_diff / torch.clamp(torch.linalg.norm(flow, dim=-1), min=1e-12)
    )
    return {
        "kp1": kp1,
        "kp2": kp2,
        "valid": valid,
        "good_kp_found": enough_pixels & diverse,
        "fb_flow_mask": fb_mask,
    }
