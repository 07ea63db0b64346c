"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The first call to
`load()` compiles every source whose library is missing, all `nvcc`
processes started together, into `_build/` next to this file (listed in
.gitignore). Library names carry a hash of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. A build
that fails raises: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flat_scan", "ivf_scan", "experts")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset (each wrapper adds one
# where it launches its kernel, and nowhere else)
launch_counts: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256(Path(CSRC, f"{stem}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library in parallel; return seconds spent."""
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for stem in todo:
            out = _lib_path(stem)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs.append((stem, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for stem, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{stem}.cu:\n{log.decode(errors='replace')}")
                continue
            os.replace(tmp, out)          # atomic: concurrent builders agree
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(stem: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<stem>.cu`, built on first use."""
    with _lock:
        if stem not in _libs:
            if not _lib_path(stem).exists():
                build_all()
            _libs[stem] = ctypes.CDLL(str(_lib_path(stem)))
        return _libs[stem]


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
