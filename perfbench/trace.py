"""The traced run's profiler and what is read from it.

`Profiler` wraps `torch.profiler` (host and device activity) over a
bounded steady part of a run's window. Its events are read raw from
`kineto_results` (sorting them into `key_averages` takes seconds per ten
thousand launches). `Trace` holds the device operations (kernels,
memsets, copies) and the harness's spans (host events whose name starts
with `bench:`), and computes the device's busy time as the union of the
operations' intervals, so operations that overlap count once.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "bench:"
NO_SPAN = "outside any span"

Interval = Tuple[str, int, int]          # (name, start ns, end ns)


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, as sorted disjoint ones."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """Device operations and harness spans of one traced window of
    `window_s` seconds (host clock, between two device syncs)."""

    def __init__(self, ops: List[Interval], spans: List[Interval],
                 window_s: float):
        self.ops = sorted(ops, key=lambda x: x[1])
        self.spans = sorted(spans, key=lambda x: x[1])
        self.window_s = float(window_s)
        self.union = merge([(s, e) for _, s, e in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union) / 1e9

    def idle_share(self) -> Optional[float]:
        if not self.ops or self.window_s <= 0:
            return None
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def device_s(self, match: Callable[[str], bool] = lambda n: True
                 ) -> float:
        """Summed device seconds of the operations whose name matches."""
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e9

    def count(self, match: Callable[[str], bool] = lambda n: True) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def span_s(self, name: str) -> float:
        """Host seconds inside the harness's spans `name` (without the
        prefix), nested ones once."""
        full = SPAN_PREFIX + name
        ivs = merge([(s, e) for n, s, e in self.spans if n == full])
        return sum(e - s for s, e in ivs) / 1e9

    def span_count(self, name: str) -> int:
        full = SPAN_PREFIX + name
        return sum(1 for n, _, _ in self.spans if n == full)

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals between the device's busy intervals."""
        return [(a[1], b[0]) for a, b in zip(self.union, self.union[1:])
                if b[0] > a[1]]

    def labels(self, times: List[int]) -> List[str]:
        """The innermost harness span open on the host at each of the
        sorted `times` (spans on one thread nest, so a sweep with a stack
        finds it)."""
        spans = sorted(self.spans, key=lambda x: (x[1], -x[2]))
        out, stack, j = [], [], 0
        for t in times:
            while j < len(spans) and spans[j][1] <= t:
                while stack and stack[-1][2] <= spans[j][1]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            out.append(stack[-1][0][len(SPAN_PREFIX):] if stack
                       else NO_SPAN)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time
        between them by what the host was doing, each the `top` largest,
        in seconds."""
        by_op: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            by_op[n[:120]] += (e - s) / 1e9
        by_gap: Dict[str, float] = defaultdict(float)
        gaps = self.gaps()
        for (s, e), name in zip(gaps, self.labels([s for s, _ in gaps])):
            by_gap[name] += (e - s) / 1e9
        ops = sorted(by_op.items(), key=lambda x: -x[1])[:top]
        gaps = sorted(by_gap.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}


def _device_events(prof) -> Tuple[List[Interval], List[Interval]]:
    from torch.autograd import DeviceType
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        iv = (e.name(), s, s + e.duration_ns())
        if e.name().startswith(SPAN_PREFIX):
            # a span's copy on the device's timeline is no operation
            if e.device_type() != DeviceType.CUDA:
                spans.append(iv)
        elif e.device_type() == DeviceType.CUDA:
            ops.append(iv)
    return ops, spans


class Profiler:
    """`start()` / `stop()` around the traced part of a window; a no-op
    when the run is not traced. Each end waits for the device, so the
    window's host time covers the device work it enqueued."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self._prof = None
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[Trace]:
        if not self.enabled or self._prof is None:
            return None
        self._sync()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        ops, spans = _device_events(self._prof)
        self._prof = None
        return Trace(ops, spans, window)
