"""The hand-written kernels' share of their roofline in the traced chunks:
the least time of every launch of the cost volume (A), the filter (B) and
the head conv (C), from the chunk's shapes (``counting.chunk_kernels``),
over their measured device time (layer: the kernels). The launches of the
trace must be the ones the shapes count."""

from perfbench.counting import chunk_kernels
from perfbench.reference.frontend import ReferenceFrontend


def read(run):
    if run.trace is None:
        return None
    ref = ReferenceFrontend(run.flow_kind, *run.traffic["frame_hw"])
    launches = chunk_kernels(run.flow_kind, ref.flow_feed, ref.depth_feed, run.chunk)
    expected = {op: sum(1 for k in launches if k[0] == op) * len(run.traced)
                for op in run.traced_launches}
    if expected != run.traced_launches:
        run.log(f"  hand-kernel launches {run.traced_launches}, the shapes count {expected}")
        return None
    measured = sum(sum(v) for v in run.trace.hand_kernel_events().values())
    least = sum(k[4] for k in launches) * len(run.traced)
    return 100.0 * least / measured if measured > 0 else None
