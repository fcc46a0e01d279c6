"""Build and load the port's CUDA kernels as one shared library.

The sources in ``dfvo_torch/csrc/`` export plain C functions. They are
compiled with ``nvcc`` for Hopper (``sm_90a``) into one ``.so`` at first use,
under ``build/dfvo_torch_kernels/`` in the checkout, and loaded with
``ctypes``. The library's file name carries a hash of the sources, so an
edited kernel is rebuilt and a stale library is never loaded. Nothing is
built or imported from CUDA when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "dfvo_torch_kernels"
SOURCES = ("correlation.cu", "regfilter.cu", "headconv.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # f1, f2, out, n, h, w, c, max_disp, dtype, stream
    "dfvo_correlation": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # dist, flow, wts, out, n, h, w, k, dtype, stream
    "dfvo_regfilter": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, cout, pad,
    # dtype, stream
    "dfvo_headconv": (_P, _P, _P, _P) + (_I,) * 10 + (_P,),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran (None: cached)


def _source_hash():
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + NVCC_FLAGS:
        h.update(name.encode())
        path = CSRC_DIR / name
        if path.suffix in (".cu", ".cuh"):
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path():
    return BUILD_DIR / f"libdfvo_kernels_{_source_hash()}.so"


def nvcc_executable():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the dfvo_torch CUDA "
            "kernels are built with the CUDA toolkit at first use"
        )
    return path


def build_command(out_path):
    """The nvcc command line that builds every kernel into ``out_path``."""
    return (
        [nvcc_executable(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out_path)]
        + [str(CSRC_DIR / s) for s in SOURCES]
    )


def _build(out_path):
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        build_command(tmp), capture_output=True, text=True, check=False
    )
    (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out_path)
    build_seconds = time.perf_counter() - t0


def load():
    """Build (once, if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def dtype_code(dtype):
    if dtype not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name, *tensors):
    """Raise unless every tensor is on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(
            f"{name}: CUDA kernel needs all tensors on one CUDA device, got "
            f"{sorted(str(d) for d in devs)}"
        )


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
