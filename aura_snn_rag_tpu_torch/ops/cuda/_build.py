"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The first call to
`load()` compiles every source whose library is missing, all `nvcc`
processes started together, into `_build/` next to this file (listed in
.gitignore). Library names carry a hash of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. A build
that fails raises: nothing falls back to the plain PyTorch versions.

Every C entry point is called through an `Entry`, which the module that
wraps its kernel declares at import (its library, symbol and argument
types, all in `ENTRIES`, which a CPU test holds against the sources'
`extern "C"` signatures), and every wrapper checks its tensors with
`check_inputs` before it passes their pointers.
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
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flat_scan", "ivf_scan", "experts", "adamw", "kda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset (an `Entry` adds one
# where it launches its kernel, and nothing else does)
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


# the letters of a declared signature: a pointer (or None for null), an
# int, a long, a float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_long,
           "f": ctypes.c_float}

# symbol -> its declaration, and its ctypes function once bound
ENTRIES: Dict[str, "Entry"] = {}
_bound: Dict[str, Callable[..., int]] = {}


class Entry:
    """A C entry point of `csrc/<stem>.cu`, declared once by the module
    that wraps it and bound on its first call. A `*_launch` symbol takes
    the current stream as its last argument (appended here, not declared)
    and returns a CUDA error code: a call raises on a non-zero code and
    adds one to `launch_counts` under each of `counts` (by default the
    symbol without `_launch`). Any other symbol is a query whose result a
    call returns."""

    def __init__(self, stem: str, symbol: str, args: str,
                 restype: str = "i", counts: Sequence[str] = ()):
        self.stem, self.symbol = stem, symbol
        self.name = symbol.removesuffix("_launch")
        self.launches = symbol.endswith("_launch")
        self.argtypes = tuple(_CTYPES[a] for a in args.replace(" ", "")) + (
            (ctypes.c_void_p,) if self.launches else ())
        self.restype = _CTYPES[restype]
        self.counts = tuple(counts) or (self.name,)
        ENTRIES[symbol] = self

    def _bind(self):
        lib = load(self.stem)
        with _lock:
            fn = getattr(lib, self.symbol)
            fn.argtypes, fn.restype = self.argtypes, self.restype
            _bound[self.symbol] = fn
        return fn

    def __call__(self, *args, counts: Sequence[str] = ()):
        """Tensors pass as their data pointers, None as null."""
        fn = _bound.get(self.symbol)
        if fn is None:
            fn = self._bind()
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        if not self.launches:
            return fn(*args)
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{rc}")
        for name in counts or self.counts:
            launch_counts[name] += 1


def check_inputs(name: str, *pairs: Tuple[torch.Tensor, torch.dtype],
                 aligned: Optional[int] = None,
                 whole_rows: bool = False) -> None:
    """Raise unless each (tensor, dtype) of `pairs` has that dtype
    (TypeError) and is contiguous and on the first tensor's device
    (ValueError). The first `aligned` of them (all by default), which
    the kernel reads 16 bytes at a time, must start 16-byte aligned, and
    with `whole_rows` their rows must be whole 16-byte chunks
    (ValueError)."""
    dev = pairs[0][0].device
    for i, (t, dt) in enumerate(pairs):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: inputs must be contiguous and on "
                             f"one device")
        if (aligned is None or i < aligned) and (
                t.data_ptr() % 16
                or whole_rows and t.shape[-1] * t.element_size() % 16):
            raise ValueError(f"{name}: a {tuple(t.shape)} {t.dtype} input "
                             f"must start 16-byte aligned"
                             + (" in whole 16-byte rows" if whole_rows
                                else ""))
