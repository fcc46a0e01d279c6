#!/usr/bin/env python3
"""What a host offers the port's frame decoding and result writing.

    python3 scripts/probe_host_io.py

Prints one JSON object: the Python modules the host side may use (cv2,
PIL, tqdm, matplotlib, yaml), the C++ compiler, whether a translation
unit including <jpeglib.h> and one including <png.h> compile and link
(-ljpeg, -lpng), and the versions of Python, torch and CUDA. Builds in a
temporary directory and leaves nothing behind.
"""

import importlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path


def module_version(name):
    try:
        mod = importlib.import_module(name)
    except Exception as e:  # a broken install counts as absent
        return f"absent ({type(e).__name__})"
    return str(getattr(mod, "__version__", "present"))


def compiles(cxx, header, lib, tmp):
    src = Path(tmp) / f"probe_{lib}.cpp"
    src.write_text(f"#include <cstdio>\n#include <{header}>\nint main() {{ return 0; }}\n")
    out = Path(tmp) / f"probe_{lib}"
    res = subprocess.run([cxx, str(src), "-o", str(out), f"-l{lib}"],
                         capture_output=True, text=True, timeout=120)
    if res.returncode == 0:
        return "yes"
    return "no: " + (res.stderr.strip().splitlines() or ["?"])[0][:160]


def main():
    report = {"python": sys.version.split()[0]}
    for name in ("torch", "numpy", "yaml", "cv2", "PIL", "tqdm", "matplotlib", "scipy"):
        report[name] = module_version(name)
    try:
        import torch

        report["cuda"] = torch.version.cuda
        report["cuda_available"] = torch.cuda.is_available()
    except Exception:
        pass
    cxx = shutil.which("g++")
    report["g++"] = cxx
    if cxx:
        ver = subprocess.run([cxx, "--version"], capture_output=True, text=True)
        report["g++_version"] = ver.stdout.splitlines()[0] if ver.stdout else None
        with tempfile.TemporaryDirectory() as tmp:
            report["jpeglib.h"] = compiles(cxx, "jpeglib.h", "jpeg", tmp)
            report["png.h"] = compiles(cxx, "png.h", "png", tmp)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
