#!/usr/bin/env python3
"""Does a torch.profiler trace hold every kernel its calls launched?

For every kernel of chip_smoke.py's timing table (its kernel, plain and
library calls at 192x640 and at 370x1226), on one NVIDIA GPU:

* the device events of traces of 1 call and of 20 calls, against the
  events of one call, and the device ms per call of each 20-call trace;
* the same 20-call traces held open 50 ms after the calls have
  finished; opened 50 ms before the calls start; and opened with 32
  launches of a spin kernel (not counted) before the calls;
* CUDA-event ms per call over 20 calls back to back (host gaps included)
  and over the replay of a CUDA graph of 20 calls (no host gaps).

    python3 scripts/profiler_trace_check.py [--out build/trace_check.jsonl]

Prints one line per case and writes one JSON object per case to ``--out``.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRACES = 5
REPS = 20


def trace(fn, calls, hold_s=0.0, wait_s=0.0, spins=0):
    """(device ms, device events) of one trace of ``calls`` calls, opened
    ``wait_s`` before them and after ``spins`` spin kernels (left out of
    the sums), and held open ``hold_s`` after they finish."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(spins):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(wait_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if hold_s:
            time.sleep(hold_s)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def graph_ms(fn, reps):
    """CUDA-event ms per call over the replay of a CUDA graph of ``reps``
    calls (median of 5 replays), or None where the call cannot be captured."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:120]
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples), None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "trace_check.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_trace_check: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    cs.build_phase()
    chk = cs.Checker(cs.SEED)
    t0 = time.perf_counter()
    sizes = (("192x640", cs.main_path_shapes((192, 640), (192, 640))),
             ("370x1226", cs.main_path_shapes((384, 1248), (384, 1248))))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        for size, shapes in sizes:
            for case in cs.timing_cases(chk, shapes):
                for kind in ("kfn", "pfn", "lfn"):
                    fn = case[kind]
                    if fn is None:
                        continue
                    reps = 3 if kind == "pfn" else REPS
                    fn()
                    torch.cuda.synchronize()
                    one = [trace(fn, 1)[1] for _ in range(TRACES)]
                    many = [trace(fn, reps) for _ in range(TRACES)]
                    held = [trace(fn, reps, hold_s=0.05) for _ in range(TRACES)]
                    waited = [trace(fn, reps, wait_s=0.05) for _ in range(TRACES)]
                    spun = [trace(fn, reps, spins=32) for _ in range(TRACES)]
                    spun_1 = [trace(fn, 1, spins=32)[1] for _ in range(TRACES)]
                    g_ms, g_err = graph_ms(fn, reps)
                    row = {"size": size, "kernel": case["kernel"], "shape": case["shape"],
                           "call": kind, "reps": reps, "events_1": one,
                           "events_n": [n for _, n in many],
                           "ms_n": [ms / reps for ms, _ in many],
                           "events_n_held": [n for _, n in held],
                           "ms_n_held": [ms / reps for ms, _ in held],
                           "events_n_waited": [n for _, n in waited],
                           "events_n_spun": [n for _, n in spun],
                           "ms_n_spun": [ms / reps for ms, _ in spun],
                           "events_1_spun": spun_1,
                           "event_ms": cs.time_cuda(fn, reps), "graph_ms": g_ms,
                           "graph_error": g_err, "bound_ms": case["bound"][0],
                           "t_s": time.perf_counter() - t0}
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                    print(f"{size:8s} {case['kernel']:15s} {case['shape']:30s} {kind} "
                          f"1-call events {one}; {reps}-call events {row['events_n']} "
                          f"held {row['events_n_held']} waited {row['events_n_waited']} "
                          f"spun {row['events_n_spun']} (1 call {spun_1}); ms "
                          f"{[round(x, 4) for x in row['ms_n']]} held "
                          f"{[round(x, 4) for x in row['ms_n_held']]} spun "
                          f"{[round(x, 4) for x in row['ms_n_spun']]}; event "
                          f"{row['event_ms']:.4f} graph "
                          f"{'-' if g_ms is None else f'{g_ms:.4f}'} bound "
                          f"{row['bound_ms']:.4f}", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
