"""Profiling hooks over `torch.profiler` and NVTX (counterpart of
`aura_snn_rag_tpu/utils/trace.py`, which runs over `jax.profiler`):

- `trace(log_dir)`: a profiler trace of the enclosed block (host ops and,
  with a card, its CUDA kernels), written under `log_dir` as a Chrome
  trace that Perfetto and chrome://tracing read;
- `annotate(name)`: a named range in that trace (`record_function`) and,
  with a card, an NVTX range;
- `StepTimer`: host-clock step times, fenced on the card.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a profiler trace of the enclosed block:

        with trace("runs/trace"):
            trainer.train_step(ids, ids)

    Writes `trace_<pid>_<n>.json` (n counts this process's traces) under
    `log_dir` (default: `aura_trace` in the temporary directory) when the
    block exits; yields `log_dir`. With a card the trace holds the device
    kernels by their CUDA function names."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "aura_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    n = sum(name.startswith(f"trace_{os.getpid()}_")
            for name in os.listdir(log_dir))
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: a `record_function` scope in the profiler's trace
    and, with a card, an NVTX range (for Nsight)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if torch.is_tensor(tree):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


class StepTimer:
    """Host-clock step timing. PyTorch returns before the card finishes,
    so `measure(fence_output)` waits, when `fence_output` (a tensor or a
    structure of them) lies on a card, for every kernel queued on that
    card (`torch.cuda.synchronize`) before it reads the clock; a CPU
    tensor is ready when its op returns."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, fence_output=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        leaf = _first_tensor(fence_output)
        if leaf is not None and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self.times:
            return {"n": 0}
        arr = np.asarray(self.times)
        return {"n": len(arr), "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3)}
