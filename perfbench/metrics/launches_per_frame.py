"""Kernels launched per tracked frame: the device kernel events of the
traced chunks over their frames (layer: the chunk step's host launch path).
The trace counts only when it holds every launch of the hand-written
kernels that their counters saw."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.kernels()) / (len(run.traced) * run.chunk)
