"""Operations and bytes of the work a chunk asks for, counted from shapes:
the published peaks of one H100, the hand-written kernels' least times
(their roofline), and the networks' operations (for the step's share of
the peak).

The kernel formulas are those of the port's card check (``chip_smoke.py``
``bound``, ``main_path_shapes``, ``hd3_corr_shapes`` and its timing cases),
copied here so that the yardstick stays fixed: each input byte read once
and each output byte written once against the HBM rate, the operations
against the peak rate of their unit.
"""

import torch

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, bf16 tensor-core and
# float32 CUDA-core operations/s (at the 700 W limit)
PEAK_BYTES, PEAK_BF16_TC, PEAK_F32 = 3.35e12, 989e12, 67e12
HD3_CHANNELS = (512, 512, 256, 128, 64)


def bound(nbytes, flops, peak_flops):
    """(seconds, 'bytes' or 'operations'): the least time the card could take."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_shapes(flow_hw, depth_hw):
    """LiteFlowNet's and the depth network's kernel shapes at their feed
    sizes: (corr, reg, lfn_heads, depth_heads). Level l of LiteFlowNet is at
    1/2^(l-1) of its feed. corr: (level, f1/f2 [H, W, C]); levels 3 and 2
    are the stride-2 subsamples of the level 3 and 2 maps. reg: (level,
    [H, W], k). Heads: (name, [H, W, Cin], Cout, k, prepadded); the
    disparity heads see the reflect-padded map."""
    lv = {lvl: (flow_hw[0] >> (lvl - 1), flow_hw[1] >> (lvl - 1)) for lvl in range(2, 7)}
    corr = ((6, (*lv[6], 192)), (5, (*lv[5], 128)), (4, (*lv[4], 96)), (3, (*lv[4], 64)),
            (2, (*lv[3], 64)))
    reg = tuple((lvl, lv[lvl], k) for lvl, k in ((2, 7), (3, 5), (4, 5), (5, 3), (6, 3)))
    lfn_heads = tuple((f"main_3 L{lvl}", (h, w, 32), 2, k, False) for lvl, (h, w), k in reg)
    depth_heads = tuple((f"dispconv_{s}", ((depth_hw[0] >> s) + 2, (depth_hw[1] >> s) + 2, c),
                         1, 3, True) for s, c in enumerate((16, 32, 64, 128)))
    return corr, reg, lfn_heads, depth_heads


def hd3_corr_shapes(feed):
    """HD3's cost-volume shapes, coarse to fine: level l at 1/2^(6-l) of
    the feed, with the encoder's channels there."""
    return tuple((l, (feed[0] >> (6 - l), feed[1] >> (6 - l), c))
                 for l, c in enumerate(HD3_CHANNELS))


def corr_cost(n, h, w, c, d):
    """(bytes, operations) of one cost volume: two bf16 maps in, (2D+1)^2
    channels out, a multiply-add per channel and tap."""
    kk = (2 * d + 1) ** 2
    return 2 * (2 * n * h * w * c + n * h * w * kk), 2 * n * h * w * kk * c


def reg_cost(n, h, w, k):
    """(bytes, operations) of one regularization filter in bf16: the raw
    logits and the flow in, the flow out; the normalisation, the divisor
    and three operations per tap and component, on the CUDA cores."""
    kk = k * k
    return 2 * (n * h * w * (kk + 4) + 2 * kk + 2), n * h * w * (11 * kk + 6)


def head_cost(n, h, w, cin, cout, k, pre):
    """(bytes, operations) of one head conv in bf16."""
    pad = 0 if pre else (k - 1) // 2
    oh, ow = h - 2 * ((k - 1) // 2 - pad), w - 2 * ((k - 1) // 2 - pad)
    return (2 * (n * h * w * cin + n * oh * ow * cout + k * k * cin * cout + cout),
            2 * n * oh * ow * k * k * cin * cout)


def chunk_kernels(flow_kind, flow_feed, depth_feed, pairs):
    """Every launch of the hand-written kernels in one chunk of ``pairs``
    pairs: a list of (kernel, label, bytes, operations, least seconds,
    'bytes' or 'operations'). LiteFlowNet runs on 2·pairs pair rows; the
    depth network on ``pairs`` frames."""
    n, rows = pairs, 2 * pairs
    out = []

    def add(kernel, label, cost, peak):
        t, by = bound(*cost, peak)
        out.append((kernel, label, *cost, t, by))

    if flow_kind == "hd3":
        for lvl, (h, w, c) in hd3_corr_shapes(flow_feed):
            add("correlation", f"L{lvl} D4 [{rows}, {h}, {w}, {c}]", corr_cost(rows, h, w, c, 4),
                PEAK_BF16_TC)
        heads = ()
    else:
        corr, reg, heads, _ = main_path_shapes(flow_feed, depth_feed)
        for lvl, (h, w, c) in corr:
            add("correlation", f"L{lvl} [{rows}, {h}, {w}, {c}]", corr_cost(rows, h, w, c, 3),
                PEAK_BF16_TC)
        for lvl, (h, w), k in reg:
            add("reg_dist_filter", f"L{lvl} k{k} [{rows}, {h}, {w}]", reg_cost(rows, h, w, k),
                PEAK_F32)
        # Matching's and Subpixel's trunks each end in a head conv
        heads = heads + heads
    for name, (h, w, cin), cout, k, pre in heads:
        add("head_conv", f"{name} [{rows}, {h}, {w}, {cin}]",
            head_cost(rows, h, w, cin, cout, k, pre), PEAK_BF16_TC)
    for name, (h, w, cin), cout, k, pre in main_path_shapes(flow_feed, depth_feed)[3]:
        add("head_conv", f"{name} [{n}, {h}, {w}, {cin}]", head_cost(n, h, w, cin, cout, k, pre),
            PEAK_BF16_TC)
    return out


def network_flops(ref_frontend, frames):
    """Operations of the reference networks on one chunk of ``frames``
    frames (frames - 1 pairs): every convolution and matrix product as
    ``torch.utils.flop_counter`` counts it on shapes alone (the meta device;
    the head convs are convolutions there), plus the cost volumes and
    filters by the formulas above, which it does not see."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.frontend import networks

    variables = {net: {k: torch.empty(t.shape, device="meta") for k, t in
                       m.state_dict().items()}
                 for net, m in networks(ref_frontend.flow_kind).items()}
    imgs = torch.empty(frames, ref_frontend.h, ref_frontend.w, 3, device="meta")
    block = ref_frontend.block
    ref_frontend.block = frames  # one block: the count is of the whole chunk
    try:
        with FlopCounterMode(display=False) as counter:
            ref_frontend.infer_chunk(variables, imgs)
    finally:
        ref_frontend.block = block
    extra = sum(ops for kernel, _, _, ops, _, _ in
                chunk_kernels(ref_frontend.flow_kind, ref_frontend.flow_feed,
                              ref_frontend.depth_feed, frames - 1)
                if kernel != "head_conv")
    return counter.get_total_flops() + extra
