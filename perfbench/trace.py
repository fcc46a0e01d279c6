"""torch.profiler over a few chunks of the window, read from the raw
events: the device operations, the busy share of the traced span, the idle
gaps named by what the host was doing, and the hand-written kernels'
launches and time.

Reading the profiler's raw events takes a fraction of a second for a few
chunks; ``key_averages()`` first builds a tree of every host op, about a
millisecond per kernel on the card's host (the port's card check measured
887.8 s with it against 447.9 s without, over its traces). Every trace
opens with spin kernels: torch.profiler can drop a trace's first device
events late in a process (``scripts/profiler_trace_check.py`` of the port
measures the drops), so the spins take that loss and are left out.
"""

import bisect
import time

import torch

SPIN = "spin_kernel"
LEAD_IN = 32
# the hand-written kernels (dfvo_torch/csrc) by the ops' counter names
HAND_KERNELS = {
    "correlation": ("correlation_tc_kernel", "correlation_rt_kernel"),
    "reg_dist_filter": ("reg_dist_filter_kernel",),
    "head_conv": ("headconv_tc_kernel", "headconv_rt_kernel"),
}
# host ranges the harness opens, innermost wins when a gap is named
MARK = "perfbench."
WALK = 4096


def hand_kernel(name):
    """The counter name of a hand-written kernel's device event, or None."""
    for op, kernels in HAND_KERNELS.items():
        if any(k in name for k in kernels):
            return op
    return None


def short_name(name):
    """A device op's name without its template arguments and parameters."""
    if len(name) > 1:
        name = torch._C._demangle(name)
    name = name.removeprefix("void ")
    if "<" in name:
        name = name[: name.index("<")]
    elif name.endswith(")") and "(" in name:
        name = name[: name.rindex("(")]
    return name.strip()[:120]


class Trace:
    """The events of one profiled run of ``fn``: device ops (name, start,
    end in ns) without the lead-in, host ops (name, start, end), and the
    traced span (the host range ``perfbench.traced``)."""

    def __init__(self, fn):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            with torch.profiler.record_function(MARK + "traced"):
                fn()
                torch.cuda.synchronize()
        self.device, self.host, self.span, self.spins = [], [], None, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if getattr(e, "is_hidden_event", lambda: False)():
                    continue
                if SPIN in e.name():
                    self.spins += 1
                    continue
                if e.name().startswith(MARK):  # a host range mirrored on the stream
                    continue
                self.device.append((e.name(), e.start_ns(), e.end_ns()))
            else:
                self.host.append((e.name(), e.start_ns(), e.end_ns()))
                if e.name() == MARK + "traced":
                    self.span = (e.start_ns(), e.end_ns())
        self.device.sort(key=lambda x: x[1])

    def kernels(self):
        """Device events that are kernels (not copies or memsets)."""
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def window_s(self):
        return (self.span[1] - self.span[0]) / 1e9

    def busy_intervals(self):
        """The union of the device ops' intervals, clipped to the span."""
        lo, hi = self.span
        merged = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ops(self, top=10):
        """[[name, seconds], ...] of the device ops that took most time."""
        by = {}
        for name, s, e in self.device:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[[what the host was doing, seconds], ...]: the device's idle
        gaps inside the span, each named by the innermost harness range and
        the innermost host op open at its middle, summed by name."""
        lo, hi = self.span
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        marks = [h for h in self.host if h[0].startswith(MARK) and h[0] != MARK + "traced"]
        ops = sorted((h for h in self.host if not h[0].startswith(MARK)), key=lambda x: x[1])
        starts = [h[1] for h in ops]
        by = {}
        for s, e in gaps:
            mid = (s + e) // 2
            inner = [m for m in marks if m[1] <= mid < m[2]]
            where = max(inner, key=lambda m: m[1])[0][len(MARK):] if inner else "outside"
            # the innermost host op open at mid: the latest started that has
            # not ended (looked for among the last WALK started)
            what = "python"
            i = bisect.bisect_right(starts, mid)
            for h in reversed(ops[max(0, i - WALK): i]):
                if h[2] > mid:
                    what = h[0]
                    break
            key = f"{where}/{what}"
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def hand_kernel_events(self):
        """{op: [seconds of each launch]} of the hand-written kernels."""
        out = {op: [] for op in HAND_KERNELS}
        for name, s, e in self.device:
            op = hand_kernel(name)
            if op:
                out[op].append((e - s) / 1e9)
        return out


def warm_profiler():
    """One short trace, so the profiler's own start-up (CUPTI) is paid in
    the set-up and not inside the window."""
    t0 = time.perf_counter()
    Trace(lambda: torch.cuda._sleep(1000))
    return time.perf_counter() - t0
