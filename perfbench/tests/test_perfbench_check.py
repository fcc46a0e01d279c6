"""The output check: a sound run of each cell comes out correct, and the
same run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (``faults.py``: a step that returns its
state unchanged; half of the batch left out, the mean of the rest in its
place; an answer altered where it is produced: a depth, a pose, or the
output of kernel A, B or C; the exchange between chips does not exist on one
chip); and so does the control, the float32 reference put in the
program's place in float8.

The runs skip the harness's look for a card and run on the CPU, where the
port runs its kernels' plain versions: float32 (so a sound run reads about
1e-6 against the reference), 192 x 640, chunks of 4, a window of one chunk.
The card-marked test runs a whole cell through ``run.py``.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.core import ROOT, Run
from perfbench.faults import FAULTS, ONLY_FOR

CELLS = ("lfn-full-cruise", "hd3-cruise", "lfn-stops")
SEED = 2**31 + 101


def cpu_run(workload, seed=SEED):
    traffic = {"frame_hw": [192, 640], "chunks": 2}
    if workload == "lfn-stops":
        traffic["stop_frames"] = 2
    run = Run(workload, seed, "cpu", overrides={
        "traffic": traffic, "config": {"tpu": {"scan_chunk": 4, "dtype": "float32"}}},
        log=lambda msg: None)
    run.setup()
    run.window(0.01)
    return run


def failing(checks):
    return sorted(k for k, (v, lim) in checks.items() if not v <= lim)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(workload):
    from dfvo_torch.models import hd3, layers, liteflownet

    run = cpu_run(workload)
    correct, attempted, failed, checks = run.check()
    assert correct and failed == 0 and attempted == 4, checks
    # the kernels' taps are gone once the check has freed the program
    for mod, name in ((liteflownet, "correlation"), (hd3, "correlation"),
                      (liteflownet, "reg_dist_filter"), (layers, "head_conv")):
        assert not hasattr(getattr(mod, name), "__wrapped__"), (mod, name)
    control = run.network_numbers(precision="float8")
    assert any(v > run.limits[k] for k, v in control.items() if k in run.limits), control
    kernels = run.kernel_numbers(precision="float8")
    assert any(v > run.limits[k] for k, v in kernels.items()), kernels


FLOW_KIND = {"lfn-full-cruise": "liteflow", "hd3-cruise": "hd3", "lfn-stops": "liteflow"}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in sorted(FAULTS) if ONLY_FOR.get(f, FLOW_KIND[w]) == FLOW_KIND[w]])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    run = cpu_run(workload)
    correct, _, _, checks = run.check()
    assert not correct, checks
    assert failing(checks)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    """One short run of the cell through run.py: a correct result line."""
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                          "--seed", str(SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["frames_per_s"]["value"])


class FakeEvent:
    """A CUDA event stand-in: ``elapsed_time`` is the count of records
    between the two, in ms."""
    clock = 0

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_spans_survive_the_warm_up_reset(monkeypatch):
    """Spans recorded after ``reset`` (as the set-up calls it after the
    warm-up) are the ones read, per window chunk, skipping the traced."""
    from perfbench.core import Spans

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    spans = Spans()
    fn = spans.wrap("layer", lambda x: x + 1)
    assert fn(1) == 2  # a warm-up call
    spans.reset()
    for chunk in range(3):
        spans.chunk = chunk
        fn(chunk)
        fn(chunk)
    ms = spans.per_chunk_ms("layer", skip=[1])
    assert sorted(ms) == [0, 2] and all(v == 2.0 for v in ms.values())
    assert fn.__wrapped__(1) == 2
