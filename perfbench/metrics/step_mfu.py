"""The whole step's share of the card's bf16 peak: the networks' operations
per tracked frame (counted once from the reference networks at the cell's
shapes, ``counting.network_flops``), times the frames per second of the
traced run's chunks that were not profiled (host clock), over 989 TFLOP/s.
The count does not depend on what implements the networks, so the metric
moves with the frame rate alone: it bounds what a kernel's roofline share
can claim."""

from perfbench.counting import PEAK_BF16_TC, network_flops
from perfbench.reference.frontend import ReferenceFrontend


def read(run):
    ref = ReferenceFrontend(run.flow_kind, *run.traffic["frame_hw"])
    per_frame = network_flops(ref, run.chunk + 1) / run.chunk
    return 100.0 * per_frame * run.untraced_frames_per_s() / PEAK_BF16_TC
