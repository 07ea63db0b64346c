"""Loader of the native host library (ctypes ABI, no pybind11): the port's
counterpart of `aura_snn_rag_tpu/_native.py`.

One shared object holds every native host kernel (hash embedder, spill
rerank, ...), built with `g++ -O3 -shared -fPIC` from the repo's
`native/*.cpp` into `_native_build/` beside this file (git-ignored;
`native/` is only read). It is rebuilt when a source is newer than the
library; the build writes a temporary file and moves it into place, so
two processes building at once agree. `load()` returns None when the
library cannot be built or loaded, and the callers take their numpy
paths.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_native_build"
SO_PATH = BUILD_DIR / "libaura_native.so"

logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_loaded = False


def _build(sources) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = SO_PATH.with_suffix(f".{os.getpid()}.tmp")
    # portable baseline ISA (no -march=native), as the JAX package builds
    # it: these kernels are hash- and memory-bound, not SIMD-bound
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                        *map(str, sources)], check=True,
                       capture_output=True, text=True, timeout=180)
        os.replace(tmp, SO_PATH)
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> Optional[ctypes.CDLL]:
    """Build (if missing or stale) and load the library; None on failure
    (the reason is logged)."""
    global _lib, _loaded
    with _lock:
        if _loaded:
            return _lib
        _loaded = True
        sources = sorted(NATIVE_DIR.glob("*.cpp"))
        if not sources:
            return None
        if (not SO_PATH.exists()
                or any(s.stat().st_mtime > SO_PATH.stat().st_mtime
                       for s in sources)):
            try:
                _build(sources)
            except subprocess.CalledProcessError as e:
                logger.warning("native build failed: %s", e.stderr)
            except (OSError, subprocess.TimeoutExpired) as e:
                logger.warning("native build failed: %s", e)
            if not SO_PATH.exists():
                return None
        try:
            _lib = ctypes.CDLL(str(SO_PATH))
        except OSError as e:
            logger.warning("native library did not load: %s", e)
        return _lib
