"""No module that a run imports, and no module under perfbench/, has the
top-level name jax, jaxlib, flax or dfvo_tpu; the reference imports nothing
of the measured program. Names are compared whole: ``dfvo_torch`` begins
with the letters of ``dfvo_tpu`` and is allowed."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import core

BENCH = Path(core.__file__).resolve().parent


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_forbidden_import_in_sources(path):
    assert not top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "dfvo_torch" not in top_level_imports(path)
    assert "perfbench" not in top_level_imports(path)  # relative imports only


def test_forbidden_modules_compares_whole_names(monkeypatch):
    before = core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dfvo_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxy", object())
    monkeypatch.setitem(sys.modules, "dfvo_tpux.sub", object())
    assert core.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "dfvo_tpu.models", object())
    assert "dfvo_tpu" in core.forbidden_modules()


def test_a_run_loads_no_jax():
    """What a cell's run imports (the harness, the reference, the metric
    readers and the program's modules on the timed path), in a fresh
    process, leaves no forbidden module behind."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from perfbench import core, calibrate, counting, oracle, trace;"
        "from perfbench.reference import frontend;"
        "import dfvo_torch.pipeline.scan_runner, dfvo_torch.pipeline.frontend;"
        "import dfvo_torch.ops.cuda_lib, dfvo_torch.utils.attrdict;"
        "[core.reader(m) for m in ('launches_per_frame', 'infer_chunk_ms', 'tracking_ms',"
        " 'pnp_ms', 'hand_kernels_roofline', 'device_idle_pct', 'step_mfu')];"
        "print(core.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
