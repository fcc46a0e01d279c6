"""Frame prefetchers: decode and resize frames ahead of the tracking loop.

Counterpart of ``dfvo_tpu/utils/native_loader.py``. The native loader is
``native/frame_loader.cpp`` (libjpeg/libpng decode and a cv2-style
bilinear resize on a C++ worker pool), compiled with ``g++`` at first use
into ``build/dfvo_torch_native/`` in the checkout (git-ignored; the file
name carries a hash of the source) and bound with ``ctypes``. Hosts
without ``g++`` or the libjpeg/libpng headers use a thread that decodes
with cv2. :func:`make_prefetcher` says which one it chose and raises,
naming what is missing, when neither can run. This is host decoding; the
device path starts at the uint8 frame.
"""

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "frame_loader.cpp"
BUILD_DIR = ROOT / "build" / "dfvo_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-pthread")
N_THREADS = 3  # native decode workers
QUEUE_DEPTH = 8  # frames decoded ahead

_lock = threading.Lock()
_lib = None
_lib_error = None  # why the native loader cannot run on this host


def library_path():
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libframe_loader_{h.hexdigest()[:16]}.so"


def _build(so):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS],
                         capture_output=True, text=True)
    if res.returncode != 0:
        lines = res.stderr.strip().splitlines()
        raise RuntimeError(f"g++ failed: {lines[0] if lines else res.returncode}")
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file


def load_library():
    """The native loader's library, built at first use; None (with the
    reason in ``_lib_error``) when this host cannot build it."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            so = library_path()
            if not so.is_file():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError) as e:
            _lib_error = str(e)
            return None
        lib.fl_create.restype = ctypes.c_void_p
        lib.fl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p)] + [ctypes.c_int] * 5
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.fl_destroy.restype = None
        lib.fl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeFramePrefetcher:
    """Ordered frame stream decoded by the C++ worker pool."""

    name = "native"

    def __init__(self, paths, out_h, out_w):
        self._handle = None
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native frame loader unavailable: {_lib_error}")
        self._lib = lib
        self._paths = [os.fspath(p).encode() for p in paths]  # kept alive for C
        self._arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h, self._w = out_h, out_w
        self._handle = lib.fl_create(self._arr, len(self._paths), out_h, out_w,
                                     N_THREADS, QUEUE_DEPTH)
        self._buf = ctypes.create_string_buffer(out_h * out_w * 3)

    def next(self):
        """-> (index, [H x W x 3] uint8 RGB), or (None, None) at the end."""
        idx = self._lib.fl_next(self._handle, self._buf)
        if idx == -1:
            return None, None
        if idx == -2:
            raise IOError("native frame loader: decode failed")
        img = np.frombuffer(self._buf.raw, np.uint8).reshape(self._h, self._w, 3)
        return idx, img.copy()

    def close(self):
        if self._handle:
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class ThreadedFramePrefetcher:
    """The same stream decoded with cv2 on one thread (cv2 releases the
    interpreter lock while it decodes, so decoding overlaps the loop)."""

    name = "cv2-thread"

    def __init__(self, paths, out_h, out_w):
        self._paths = list(paths)
        self._h, self._w = out_h, out_w
        self._q = queue.Queue(maxsize=QUEUE_DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self):
        import cv2

        for i, p in enumerate(self._paths):
            if self._stop.is_set():
                return
            img = cv2.imread(os.fspath(p), 1)
            if img is not None:
                img = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), (self._w, self._h))
            self._put((i, img))
        self._put((None, None))

    def next(self):
        idx, img = self._q.get()
        if idx is not None and img is None:
            raise IOError(f"cannot read image: {self._paths[idx]}")
        return idx, img

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)


def _has_cv2():
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def make_prefetcher(paths, out_h, out_w):
    """The native prefetcher where it builds, else the cv2 thread; prints
    which one runs. Raises RuntimeError naming both missing pieces when
    neither can run."""
    if load_library() is not None:
        prefetcher = NativeFramePrefetcher(paths, out_h, out_w)
    elif _has_cv2():
        prefetcher = ThreadedFramePrefetcher(paths, out_h, out_w)
    else:
        raise RuntimeError(
            "no frame decoder on this host: the native loader needs g++ with "
            f"jpeglib.h and png.h ({_lib_error}), the fallback needs cv2 (not installed)"
        )
    print(f"==> Frame loader: {prefetcher.name}"
          + ("" if prefetcher.name == "native" else f" (native loader: {_lib_error})"))
    return prefetcher
