"""Build and load the port's CUDA kernels as one shared library.

The sources in ``dfvo_torch/csrc/`` export plain C functions. They are
compiled with ``nvcc`` for Hopper (``sm_90a``), one process per source, all
started together, and linked into one ``.so`` at first use,
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

from .kernel_grad import records_grad

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "dfvo_torch_kernels"
SOURCES = ("correlation.cu", "correlation_bwd.cu", "regfilter.cu", "regfilter_bwd.cu",
           "headconv.cu", "headconv_bwd.cu")
HEADERS = ("common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # f1, s1n, s1h, s1w, f2, s2n, s2h, s2w, out, n, h, w, c, max_disp, dtype,
    # stream
    "dfvo_correlation": (_P, _L, _L, _L, _P, _L, _L, _L, _P) + (_I,) * 6 + (_P,),
    # the same without dtype (bf16 only)
    "dfvo_correlation_tc": (_P, _L, _L, _L, _P, _L, _L, _L, _P) + (_I,) * 5 + (_P,),
    # raw, flow, wx, bx, wy, by, wdtype, out, n, h, w, k, dtype, stream
    "dfvo_reg_dist_filter": (_P,) * 6 + (_I, _P) + (_I,) * 5 + (_P,),
    # n, h, w, k -> rows of the parameter-gradient workspace (one per tile)
    "dfvo_reg_dist_filter_bwd_parts": (_I,) * 4,
    # raw, flow, wx, bx, wy, by, wdtype, g, sgn, sgh, sgw, sgc, draw, dflow,
    # part, dwx, dbx, dwy, dby, n, h, w, k, dtype, stream
    "dfvo_reg_dist_filter_bwd": (_P,) * 6 + (_I, _P) + (_L,) * 4 + (_P,) * 7 + (_I,) * 5
    + (_P,),
    # x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, cout, pad,
    # dtype, stream
    "dfvo_headconv": (_P, _P, _P, _P) + (_I,) * 10 + (_P,),
    # x, sxn, sxh, sxw, wts, sw0..sw3, bias, out, n, in_h, in_w, cin, out_h,
    # out_w, k, cout, pad, stream (bf16 only)
    "dfvo_headconv_tc": (_P, _L, _L, _L, _P, _L, _L, _L, _L, _P, _P)
    + (_I,) * 9 + (_P,),
    # f1, s1n, s1h, s1w, f2, s2n, s2h, s2w, g, df1, d1n, d1h, d1w, df2, d2n,
    # d2h, d2w, n, h, w, c, max_disp, dtype, stream
    "dfvo_correlation_bwd": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _L, _L, _L, _P, _L, _L, _L)
    + (_I,) * 6 + (_P,),
    # n, in_h, in_w -> rows of the weight-gradient workspace
    "dfvo_headconv_bwd_parts": (_I,) * 3,
    # x, sxn, sxh, sxw, wts, sw0..sw3, g, dx, part, n, in_h, in_w, cin, out_h,
    # out_w, k, cout, pad, need_dw, need_db, dtype, stream
    "dfvo_headconv_bwd": (_P, _L, _L, _L, _P, _L, _L, _L, _L, _P, _P, _P) + (_I,) * 12 + (_P,),
    # part, nparts, dw, sw0..sw3, wdtype, db, bdtype, k, cin, cout, stream
    "dfvo_headconv_bwd_reduce": (_P, _I, _P, _L, _L, _L, _L, _I, _P) + (_I,) * 4 + (_P,),
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


def build_commands(out_path):
    """The nvcc command lines that build every kernel into ``out_path``: one
    compile per source (run in parallel), then the link."""
    nvcc = nvcc_executable()
    objs = [out_path.with_name(f"{out_path.name}.{Path(s).stem}.o") for s in SOURCES]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o), str(CSRC_DIR / s)]
        for s, o in zip(SOURCES, objs)
    ]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_path), *map(str, objs)]
    return compiles, link


def _build(out_path):
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    compiles, link = build_commands(tmp)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in compiles]
    logs = [p.communicate()[0] for p in procs]
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, check=False)
        logs.append(proc.stdout)
        rcs.append(proc.returncode)
    log = "".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    if any(rcs):
        raise RuntimeError(f"nvcc failed ({rcs}):\n{log}")
    os.replace(tmp, out_path)
    for c in compiles:
        Path(c[c.index("-o") + 1]).unlink(missing_ok=True)
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


def forbid_grad(name, *tensors):
    """Raise when autograd is recording and an input requires grad: a raw
    kernel wrapper records no gradient (its output carries no ``grad_fn``,
    so a caller's gradient would be dropped without an error). The
    dispatchers ``correlation``, ``reg_dist_filter`` and ``head_conv`` call
    it through their autograd Functions, which run it unrecorded."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{name}: the raw CUDA kernel wrapper has no backward pass; call it under "
            "torch.no_grad(), or call the op's dispatcher, whose autograd Function "
            "runs the backward kernel"
        )


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
