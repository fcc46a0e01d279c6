"""One run of one cell: set-up, the measured window, the traced chunks, the
output check and the result line.

The window is an offline closed loop over one synthetic drive: the next
chunk is sent when the last one's poses reach the host. Each chunk goes
through ``dfvo_torch.pipeline.scan_runner.make_chunk_step``'s
``chunk_step`` exactly as ``ScanRunner.run`` drives it: its uint8 frames
and step keys are uploaded, the step runs (here with the drive's oracle
depths, flows and inconsistency maps, so tracking sees coherent geometry
while the networks run in full), and the poses are read with ``.cpu()``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``limits/<workload>.json``.
"""

import contextlib
import functools
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import oracle
from .reference import ops as reference_ops
from .reference.frontend import Float8Mode, ReferenceFrontend, make_variables, to_float8

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dfvo_tpu")
CONFIG_META = ("source", "reduced", "assumed", "why")
TRACKING_MODES = {"essential": 1, "pnp": 2}
TRACED_CHUNKS = 3
SAMPLED_CHUNKS = 2
# the hand-written kernels where the networks call them: (modules of
# dfvo_torch.models whose global the kernel is, the global's name, the
# formula in reference/ops.py, how many leading arguments are batched)
KERNELS = {
    "cost_volume": (("liteflownet", "hd3"), "correlation", "correlation_plain", 2),
    "filter": (("liteflownet",), "reg_dist_filter", "reg_dist_filter_plain", 2),
    "head_conv": (("layers",), "head_conv", "head_conv_plain", 1),
}


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_benchmark(workload, path=ROOT / "BENCHMARK.json"):
    """(cell, configuration entry, end-to-end metrics, per-layer metrics)
    of ``workload``: the metrics that list it, or list no cells."""
    with open(path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    return cell, config, [m for m in bench["end_to_end"] if mine(m)], \
        [m for m in bench["per_layer"] if mine(m)]


def program_config(config_file, traffic):
    """The program's configuration: the configuration file without its
    description, at the traffic's frame size."""
    from dfvo_torch.utils.attrdict import AttrDict

    with open(ROOT / config_file) as f:
        d = {k: v for k, v in json.load(f).items() if k not in CONFIG_META}
    h, w = traffic["frame_hw"]
    d["image"] = dict(d.get("image", {}), height=h, width=w)
    return AttrDict(d)


def load_limits(workload):
    with open(BENCH_DIR / "limits" / f"{workload}.json") as f:
        return {k: v["limit"] for k, v in json.load(f)["limits"].items()}


def reader(metric):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rotation_deg(Ra, Rb):
    """The angle of Ra^T Rb in degrees (accurate near zero)."""
    R = Ra.T @ Rb
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.degrees(np.arctan2(s, (np.trace(R) - 1.0) / 2.0)))


def relative(got, want, dims):
    """||got - want|| / ||want|| over ``dims`` (None: all), inf for NaN."""
    err = torch.linalg.vector_norm(got - want, dim=dims)
    return torch.nan_to_num(err / torch.linalg.vector_norm(want, dim=dims).clamp_min(1e-30),
                            nan=math.inf)


def quantile(values, q):
    """The q-quantile of ``values`` (``statistics.quantiles``, inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[round(q * 100) - 1]


class Spans:
    """CUDA events around the calls into each layer, one list per layer of
    (window chunk, start event, end event); no synchronisation until read."""

    def __init__(self):
        self.events, self.chunk = {}, None

    def wrap(self, name, fn):
        from torch.profiler import record_function

        events = self.events.setdefault(name, [])

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with record_function("perfbench." + name):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            events.append((self.chunk, start, end))
            return out

        return wrapped

    def reset(self):
        """Forget every span; the wrappers keep recording into the same
        lists."""
        for events in self.events.values():
            events.clear()

    def per_chunk_ms(self, name, skip=()):
        """{window chunk: ms} of layer ``name`` (summed within a chunk),
        leaving out the chunks in ``skip``."""
        out = {}
        for chunk, s, e in self.events.get(name, []):
            if chunk not in skip:
                out[chunk] = out.get(chunk, 0.0) + s.elapsed_time(e)
        return out


class Run:
    """One run of one cell on ``device``.

    Args:
        workload: the cell's name in BENCHMARK.json.
        seed: the run's seed; the drive, the weights and the sampled chunks
            come from it.
        device: "cuda" (the benchmark) or "cpu" (the tests).
        overrides: test-only changes: ``traffic`` and ``config`` dicts
            merged into the files' values.
    """

    def __init__(self, workload, seed, device="cuda", overrides=None, log=None):
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self.workload, self.seed = workload, int(seed)
        self.cell, self.config_entry, self.e2e, self.per_layer = load_benchmark(workload)
        overrides = overrides or {}
        self.traffic = dict(oracle.load_traffic(self.cell["traffic"]), **overrides.get("traffic", {}))
        self.cfg = program_config(self.config_entry["file"], self.traffic)
        for group, values in overrides.get("config", {}).items():
            self.cfg[group].update(values)
        self.device = torch.device(device)
        self.chunk = int(self.cfg.tpu.scan_chunk)
        self.limits = load_limits(workload)
        self.setup_parts = {}
        self.captured = {}
        self.spans = None
        self.mark = contextlib.nullcontext

    # -- set-up ----------------------------------------------------------------
    def _lap(self, part, t0):
        t = time.perf_counter()
        self.setup_parts[part] = self.setup_parts.get(part, 0.0) + t - t0
        return t

    def setup(self, trace=False):
        """Import and start the program, build its kernels (first run in a
        checkout), make the weights and the drive on the device, and warm
        up every chunk of the pool once."""
        t = time.perf_counter()
        from dfvo_torch.ops import cuda_lib
        from dfvo_torch.pipeline import scan_runner
        from dfvo_torch.pipeline.frontend import DeepFrontend
        from dfvo_torch.pipeline.tracking import TrackingConfig
        from dfvo_torch.utils import prng
        from dfvo_torch.utils.device import upload

        self.scan_runner, self.upload = scan_runner, upload
        torch.zeros(1, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t = self._lap("import_and_context", t)
        if self.device.type == "cuda":
            cuda_lib.load()
            t = self._lap("load_kernels" if cuda_lib.build_seconds is None else "build", t)

        self.fe = DeepFrontend(self.cfg, self.device)
        self.flow_kind = self.fe.flow_kind
        self.tcfg = TrackingConfig.from_cfg(self.cfg)
        self.variables = make_variables(self.fe.flow_kind, self.seed * 2 + 1, self.device,
                                        self.fe.dtype)
        self.prepared = self.fe.prepare_variables(self.variables)
        self._sync()
        t = self._lap("weights", t)

        T, n_chunks = self.chunk, self.traffic["chunks"]
        drive = oracle.make_drive(self.traffic, T, self.seed, self.device)
        self.motions, self.stopped = drive["motions"], drive["stopped"]
        self.frames_host = drive["frames"].cpu().numpy()
        self.frame0 = drive["frames"][0]
        self.depth0 = drive["depths"][0]
        self.oracle = [{"depths": drive["depths"][1 + c * T: 1 + (c + 1) * T],
                        "flow_fwd": drive["flows"][c * T: (c + 1) * T],
                        "flow_diff": drive["flow_diff"][c * T: (c + 1) * T]}
                       for c in range(n_chunks)]
        key_seed = self.seed % 2**32
        self.keys = [prng.step_keys(key_seed, range(1 + c * T, 1 + (c + 1) * T)).astype(np.int64)
                     for c in range(n_chunks)]
        self.K = torch.as_tensor(drive["K"], dtype=torch.float32, device=self.device)
        self.K_inv = torch.linalg.inv(self.K.double()).float()
        del drive
        self._sync()
        t = self._lap("drive", t)

        self.step, _ = scan_runner.make_chunk_step(self.fe, self.tcfg)
        infer_chunk = self.fe.infer_chunk
        if trace:
            from torch.profiler import record_function

            from .trace import warm_profiler

            self.mark = lambda name: record_function("perfbench." + name)
            self.spans = Spans()
            infer_chunk = self.spans.wrap("infer_chunk", infer_chunk)
            for name in ("tracking_step_chunk", "pnp_fallback"):
                setattr(scan_runner, name, self.spans.wrap(name, getattr(scan_runner, name)))
        self.fe.infer_chunk = self._capturing(infer_chunk)
        self.capture_as = None
        self._tap_kernels()
        warm = []
        for c in range(n_chunks):
            t0 = time.perf_counter()
            self.run_chunk(c)
            warm.append(time.perf_counter() - t0)
        self.warm_chunk_s = min(warm)
        if trace:
            warm_profiler()
        t = self._lap("warm_up", t)
        if self.spans:  # the warm-up's spans are not the window's
            self.spans.reset()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _capturing(self, infer_chunk):
        """``infer_chunk`` that keeps a copy of its outputs for the chunks
        the check samples."""
        def wrapped(variables, all_imgs):
            out = infer_chunk(variables, all_imgs)
            if self.capture_as is not None:
                self.captured[self.capture_as] = {k: v.clone() for k, v in out.items()}
            return out

        return wrapped

    def _tap_kernels(self):
        """Wrap kernels A, B and C where the networks call them: in the
        chunks the check samples, every call keeps one seeded element of its
        batch, inputs and output, for ``kernel_numbers``."""
        self.kernel_calls = {name: [] for name in KERNELS}
        self.tapped = []
        rng = np.random.default_rng([self.seed, 0x7A95])
        for name, (modules, glob, _, batched) in KERNELS.items():
            for module in modules:
                mod = importlib.import_module(f"dfvo_torch.models.{module}")
                fn = getattr(mod, glob)
                self.tapped.append((mod, glob, fn))
                setattr(mod, glob, self._tap(name, fn, batched, rng))

    def _tap(self, name, fn, batched, rng):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.capture_as is not None:
                b = int(rng.integers(out.shape[0]))
                keep = [a[b:b + 1].clone() if i < batched else a for i, a in enumerate(args)]
                self.kernel_calls[name].append((keep, kwargs, out[b:b + 1].clone()))
            return out

        return wrapped

    def run_chunk(self, c):
        """Track pool chunk ``c`` as ``ScanRunner.run`` tracks a chunk:
        upload, step, poses to the host. Chunk 0 starts the drive afresh."""
        T = self.chunk
        if c == 0:
            self.carry = (self.frame0, self.depth0,
                          torch.eye(4, dtype=torch.float32, device=self.device), np.float32(1.0))
        with self.mark("upload"):
            imgs = self.upload(self.frames_host[1 + c * T: 1 + (c + 1) * T], self.device)
            keys = self.upload(self.keys[c], self.device)
        poses, modes, self.carry = self.step(self.prepared, imgs, self.carry, keys, self.K,
                                             self.K_inv, oracle=self.oracle[c])
        with self.mark("host_read"):
            poses = poses.cpu().numpy()
        return poses, modes

    # -- the window --------------------------------------------------------------
    def window(self, seconds, trace=False):
        """Run whole chunks until ``seconds`` have passed; the window ends
        when the chunk running at the deadline has its poses on the host."""
        rng = np.random.default_rng([self.seed, 0xC4EC])
        # chunks the check samples: drawn from those that any window of this
        # length holds (at half the warm-up's pace)
        reach = max(1, int(seconds / (2 * self.warm_chunk_s)))
        self.sample_at = sorted(set(int(u * reach) for u in rng.random(SAMPLED_CHUNKS)))
        self.records, self.chunk_s = [], []
        # the traced chunks sit in the middle of the window; a trace that
        # lost events is taken again from the next chunk, three times at most
        traced_at = max(0, int(seconds / self.warm_chunk_s) // 2 - 1) if trace else None
        self.trace, self.traced, attempts = None, [], 0
        self.window_start = time.perf_counter()
        deadline = self.window_start + seconds
        i = 0
        while True:
            if i == traced_at:
                i = self._traced_chunks(i)
                attempts += 1
                traced_at = i if self.trace is None and attempts < 3 else None
            else:
                self._timed_chunk(i)
                i += 1
            if time.perf_counter() >= deadline and i > max(self.sample_at):
                break
        self.window_s = time.perf_counter() - self.window_start
        self._sync()
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)

    def _timed_chunk(self, i):
        c = i % self.traffic["chunks"]
        self.capture_as = (i, c) if i in self.sample_at else None
        if self.spans:
            self.spans.chunk = i
        t0 = time.perf_counter()
        poses, modes = self.run_chunk(c)
        self.chunk_s.append(time.perf_counter() - t0)
        self.records.append((i, c, poses, np.asarray(modes)))
        self.capture_as = None

    def _traced_chunks(self, i):
        """Profile TRACED_CHUNKS chunks from window chunk ``i``; keep the
        trace only if it holds every launch of the hand-written kernels that
        their counters saw. Returns the next chunk's index."""
        from .trace import Trace

        before = self._launches()
        span = range(i, i + TRACED_CHUNKS)
        tr = Trace(lambda: [self._timed_chunk(j) for j in span])
        counted = {op: n - before[op] for op, n in self._launches().items()}
        seen = {op: len(v) for op, v in tr.hand_kernel_events().items()}
        if tr.spins and seen == counted and tr.span:
            self.trace, self.traced, self.traced_launches = tr, list(span), counted
        else:
            self.log(f"  trace of chunks {list(span)} dropped: {tr.spins} lead-in spins, "
                     f"hand-kernel events {seen} against counters {counted}")
        return i + TRACED_CHUNKS

    @staticmethod
    def _launches():
        from dfvo_torch.ops.headconv import head_conv_cuda
        from dfvo_torch.ops.pallas_corr import correlation_cuda
        from dfvo_torch.ops.regfilter import reg_dist_filter_cuda

        return {"correlation": correlation_cuda.launches,
                "reg_dist_filter": reg_dist_filter_cuda.launches,
                "head_conv": head_conv_cuda.launches}

    # -- metrics -------------------------------------------------------------------
    def frames_per_s(self):
        return len(self.records) * self.chunk / self.window_s

    def untraced_frames_per_s(self):
        """Frames per second of the window's chunks that were not profiled
        (the profiler slows the host's launches)."""
        times = [s for (i, *_), s in zip(self.records, self.chunk_s) if i not in self.traced]
        return len(times) * self.chunk / sum(times)

    def end_to_end(self):
        chunk_ms = [1e3 * s for s in self.chunk_s]
        self.log(f"  window {self.window_s:.3f} s: {len(chunk_ms)} chunks of {self.chunk} frames "
                 f"(chunk_ms_p90 over {len(chunk_ms)} chunks; median {statistics.median(chunk_ms):.2f}"
                 f" ms)")
        return {
            "frames_per_s": self.frames_per_s(),
            "chunk_ms_p90": quantile(chunk_ms, 0.9),
            "peak_mem_gib": self.memory_peak / 2**30,
            "setup_s": self.setup_s,
        }

    def per_layer_values(self):
        values = {}
        for m in self.per_layer:
            value = reader(m["name"])(self)
            if value is not None:
                values[m["name"]] = value
        return values

    # -- the check -----------------------------------------------------------------
    def free_program(self):
        """Drop the program's state before the reference runs."""
        for name in ("fe", "step", "prepared", "oracle", "carry", "frame0", "depth0"):
            self.__dict__.pop(name, None)
        for mod, glob, fn in reversed(self.__dict__.pop("tapped", [])):
            setattr(mod, glob, fn)
        if self.spans:
            for name in ("tracking_step_chunk", "pnp_fallback"):
                fn = getattr(self.scan_runner, name)
                setattr(self.scan_runner, name, fn.__wrapped__ if hasattr(fn, "__wrapped__") else fn)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def geometry_numbers(self):
        """Over every tracked frame of the window: ``wrong_modes``, the
        frames whose mode the motion rules out (a stopped frame off PnP, a
        moving frame on neither E nor PnP; GRIC may send a slow moving frame
        to PnP, whose pose the pose numbers judge), the worst rotation error
        (deg) and the worst translation error (m, per metre of the traffic's
        speed) against the generated motion; ``moving_on_pnp``, the moving
        frames that PnP tracked (not compared)."""
        T, speed = self.chunk, self.traffic["speed"]
        wrong = rot = trans = on_pnp = 0.0
        bad_frames = 0
        for _, c, poses, modes in self.records:
            for j in range(T):
                gt = self.motions[c * T + j]
                if self.stopped[c * T + j]:
                    miss = int(modes[j] != TRACKING_MODES["pnp"])
                else:
                    miss = int(modes[j] not in TRACKING_MODES.values())
                    on_pnp += int(modes[j] == TRACKING_MODES["pnp"])
                r = rotation_deg(poses[j][:3, :3].astype(np.float64), gt[:3, :3])
                t = float(np.linalg.norm(poses[j][:3, 3] - gt[:3, 3])) / speed
                if not np.isfinite(r):
                    r = math.inf
                if not np.isfinite(t):
                    t = math.inf
                wrong += miss
                rot, trans = max(rot, r), max(trans, t)
                bad_frames += bool(miss or r > self.limits["rotation_deg"]
                                   or t > self.limits["translation_per_m"])
        return {"wrong_modes": wrong, "rotation_deg": rot, "translation_per_m": trans,
                "moving_on_pnp": on_pnp}, bad_frames

    def network_numbers(self, precision="float32", captured=None, detail=False):
        """Per output of ``infer_chunk`` (depths, flow_fwd, flow_diff): the
        worst frame's relative error ||out - ref|| / ||ref|| over the
        sampled chunks, against the float32 reference on the same frames
        and weights (``precision`` "float8": the control, the reference
        itself in float8, in the program's place). With ``detail`` also the
        error over each chunk's frames together and the median frame's."""
        captured = self.captured if captured is None else captured
        ref = ReferenceFrontend(self.flow_kind, *self.traffic["frame_hw"])
        ctl = ReferenceFrontend(self.flow_kind, *self.traffic["frame_hw"], precision=precision) \
            if precision != "float32" else None
        T = self.chunk
        numbers = {}
        for (_, c), out in sorted(captured.items()):
            imgs = torch.from_numpy(self.frames_host[c * T: (c + 1) * T + 1]).to(self.device)
            imgs = imgs.float() / 255.0
            want = ref.infer_chunk(self.variables, imgs)
            got = ctl.infer_chunk(self.variables, imgs) if ctl else out
            for k in ("depths", "flow_fwd", "flow_diff"):
                g, r = got[k].float(), want[k]
                frame = relative(g, r, tuple(range(1, r.dim())))
                found = {f"{k}_rel_err": float(frame.max())}
                if detail:
                    found[f"{k}_chunk"] = float(relative(g, r, None))
                    found[f"{k}_frame_median"] = float(frame.median())
                for name, v in found.items():
                    numbers[name] = max(numbers.get(name, 0.0), v)
        return numbers

    def kernel_numbers(self, precision="float32"):
        """Per hand-written kernel that ran: ``<kernel>_rel_err``, the worst
        call's ||out - ref|| / ||ref|| over the batch elements that the
        sampled chunks kept, ``ref`` the formula of ``reference/ops.py`` in
        float32 (TF32 off) on the same inputs. ``precision`` "float8": the
        control, the formula on inputs rounded to float8 and with every
        intermediate so rounded, in the kernel's place."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        numbers = {}
        try:
            for name, calls in self.kernel_calls.items():
                formula = getattr(reference_ops, KERNELS[name][2])
                for args, kwargs, out in calls:
                    args = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                            for a in args]
                    want = formula(*args, **kwargs)
                    if precision == "float8":
                        with Float8Mode():
                            got = formula(*[to_float8(a) if torch.is_tensor(a)
                                            and a.is_floating_point() else a for a in args],
                                          **kwargs)
                    else:
                        got = out
                    err = float(relative(got.float(), want, None))
                    key = f"{name}_rel_err"
                    numbers[key] = max(numbers.get(key, 0.0), err)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return numbers

    def check(self, detail=False):
        """(correct, attempted, failed, {number: (value, limit)}); with
        ``detail`` the numbers not compared include the worst and the
        median frame's errors (``network_numbers``)."""
        geo, bad_frames = self.geometry_numbers()
        self.free_program()
        numbers = dict(geo)
        if self.captured:
            numbers.update(self.network_numbers(detail=detail))
        numbers.update(self.kernel_numbers())
        self.numbers = numbers
        for k in sorted(set(numbers) - set(self.limits)):
            self.log(f"  {k} {numbers[k]!r} (not compared in this cell)")
        checks = {k: (numbers.get(k, math.inf), lim) for k, lim in self.limits.items()}
        correct = all(v <= lim for v, lim in checks.values())
        attempted = len(self.records) * self.chunk
        return correct, attempted, bad_frames, checks


def device_info(run, trace):
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
           "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s()
    return dev


def main(args):
    """Run one cell as ``run.py`` was asked; returns the exit code."""
    log = (lambda msg: print(msg, file=sys.stderr, flush=True))
    run = Run(args.workload, args.seed, "cuda", log=log)
    run.setup_parts["interpreter_and_imports"] = time.perf_counter() - args.t_start
    run.setup(trace=bool(args.trace))
    run.setup_s = time.perf_counter() - args.t_start
    log(f"  setup_s {run.setup_s:.3f}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()))
    run.window(args.seconds, trace=bool(args.trace))
    units = {m["name"]: m["unit"] for m in run.e2e + run.per_layer}
    e2e = run.end_to_end()
    if args.trace:
        values = run.per_layer_values()
    else:
        values = {m["name"]: e2e[m["name"]] for m in run.e2e}
    device = device_info(run, args.trace)
    breakdown = None
    if args.trace and run.trace is not None:
        breakdown = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    correct, attempted, failed, checks = run.check()
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in the measuring process: {found}")
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": device}
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0
