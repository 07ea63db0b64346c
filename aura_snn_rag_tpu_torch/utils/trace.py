"""Profiling hooks over `torch.profiler` and NVTX (counterpart of
`aura_snn_rag_tpu/utils/trace.py`, which runs over `jax.profiler`):

- `trace(log_dir)`: a profiler trace of the enclosed block (host ops and,
  with a card, its CUDA kernels), written under `log_dir` as a Chrome
  trace that Perfetto and chrome://tracing read;
- `annotate(name)`: a named range in that trace (`record_function`) and,
  with a card, an NVTX range;
- `span(name)`: the program's own stages (`aura:<name>` in the trace),
  recorded only while spans are on (`enable_spans`, or inside `trace`);
  off, a span is one flag test and a shared no-op context;
- `counters`, `count(name)`, `host_sync(site)`: always-on event counts
  (which retrieval path ran, aux builds, each place where the host waits
  for the device), one dict increment each and no device work. DeepSeek-
  V3's block records spans `mla.project`, `mla.core`, `moe.route`,
  `moe.dispatch`, `moe.experts`, `moe.combine`, `moe.shared` and, on
  autograd's thread, `moe.experts_bwd`, and counts `path.mla` and
  `path.moe_grouped` (`path.moe_loop` on the CPU) once a layer's
  forward; the optimizer counts `path.adamw_fused` once an update on the
  card;
- `StepTimer`: host-clock step times, fenced on the card.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
from typing import ContextManager, Iterator, Optional

import numpy as np
import torch

try:        # a profiler event at a fraction of `record_function`'s cost
    from torch._C._profiler import _RecordFunctionFast as _record
except ImportError:                                       # pragma: no cover
    _record = torch.profiler.record_function

SPAN_PREFIX = "aura:"

# event name -> count in this process: `path.<retrieval path>`,
# `aux_build`, `sync.<site>`; read as differences around a window
counters: collections.Counter = collections.Counter()

_spans_on = False
_NO_SPAN = contextlib.nullcontext()


def enable_spans(on: bool) -> bool:
    """Turn the program's spans on or off for the whole process; returns
    the previous setting. A span is recorded by a running profiler
    (`torch.profiler`, or `trace`) on its host timeline, which shares the
    clock of the device activity it records."""
    global _spans_on
    was, _spans_on = _spans_on, bool(on)
    return was


def span(name: str) -> ContextManager:
    """The program's stage `name`, as `aura:<name>` on the profiler's host
    timeline while spans are on; one shared no-op context while off."""
    if not _spans_on:
        return _NO_SPAN
    return _record(SPAN_PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to `counters[name]`."""
    counters[name] += n


def host_sync(site: str) -> ContextManager:
    """Around a call that makes the host wait for the work queued on the
    device (a read of a device value, a copy from pageable host memory):
    counts `sync.<site>` and, while spans are on, records the wait as span
    `sync.<site>`."""
    name = "sync." + site
    count(name)
    return span(name)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a profiler trace of the enclosed block:

        with trace("runs/trace"):
            trainer.train_step(ids, ids)

    Writes `trace_<pid>_<n>.json` (n counts this process's traces) under
    `log_dir` (default: `aura_trace` in the temporary directory) when the
    block exits; yields `log_dir`. With a card the trace holds the device
    kernels by their CUDA function names, and the program's spans, which
    are on for the block."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "aura_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = enable_spans(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
    finally:
        enable_spans(was)
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
