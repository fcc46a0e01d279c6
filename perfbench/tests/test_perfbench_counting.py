"""The counting functions against counts worked out by hand at one shape,
and the per-chunk launches against the program's."""

import pytest

from perfbench import counting


def test_corr_cost_by_hand():
    # N=2, 4x5 map, C=8, D=3: 49 taps. Bytes: bf16 f1 and f2 in (2·160·2 B
    # each = 640 B each... 2 maps x 2·4·5·8 values) and 2·4·5·49 values out
    n, h, w, c = 2, 4, 5, 8
    nbytes, ops = counting.corr_cost(n, h, w, c, 3)
    assert nbytes == 2 * (2 * 320 + 1960) == 5200
    assert ops == 2 * 40 * 49 * 8 == 31360  # a multiply-add per channel and tap
    assert counting.corr_cost(n, h, w, c, 4)[1] == 2 * 40 * 81 * 8


def test_reg_cost_by_hand():
    # N=1, 3x4, k=3: 9 logits + 2 flow in + 2 out per pixel, 2·9 + 2 params
    nbytes, ops = counting.reg_cost(1, 3, 4, 3)
    assert nbytes == 2 * (12 * 13 + 20) == 352
    assert ops == 12 * (11 * 9 + 6) == 1260


def test_head_cost_by_hand():
    # 'same' 3x3, Cin 4, Cout 2 on N=1, 5x6: out 5x6x2
    nbytes, ops = counting.head_cost(1, 5, 6, 4, 2, 3, False)
    assert nbytes == 2 * (120 + 60 + 72 + 2) == 508
    assert ops == 2 * 30 * 9 * 4 * 2 == 4320
    # pre-padded: the output is 2 smaller each way
    assert counting.head_cost(1, 5, 6, 4, 2, 3, True)[1] == 2 * 12 * 9 * 4 * 2


def test_bound_picks_the_larger():
    t, by = counting.bound(3.35e12, 1.0, counting.PEAK_BF16_TC)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = counting.bound(1.0, 989e12, counting.PEAK_BF16_TC)
    assert by == "operations" and t == pytest.approx(1.0)


@pytest.mark.parametrize("kind,launches", [("liteflow", (5, 5, 14)), ("hd3", (5, 0, 4))])
def test_launches_per_chunk(kind, launches):
    ks = counting.chunk_kernels(kind, (192, 640), (192, 640), 32)
    got = tuple(sum(1 for k in ks if k[0] == op)
                for op in ("correlation", "reg_dist_filter", "head_conv"))
    assert got == launches


def test_least_time_matches_the_kernel_table():
    # PERF.md's kernel table, 192x640 per infer_chunk call: A 0.0902, B
    # 0.0731, C 0.1819 ms
    ks = counting.chunk_kernels("liteflow", (192, 640), (192, 640), 32)
    per = {op: 1e3 * sum(k[4] for k in ks if k[0] == op)
           for op in ("correlation", "reg_dist_filter", "head_conv")}
    assert per["correlation"] == pytest.approx(0.0902, abs=1e-4)
    assert per["reg_dist_filter"] == pytest.approx(0.0731, abs=1e-4)
    assert per["head_conv"] == pytest.approx(0.1819, abs=1e-4)


def test_network_flops_grow_with_the_chunk():
    from perfbench.reference.frontend import ReferenceFrontend

    ref = ReferenceFrontend("liteflow", 64, 96)
    f2, f3, f4 = (counting.network_flops(ref, m) for m in (2, 3, 4))
    assert f2 > 0 and f3 - f2 == pytest.approx(f4 - f3, rel=1e-9)
