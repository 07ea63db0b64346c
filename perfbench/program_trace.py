"""The program's own spans and counters in a traced run, on the device
trace's clock.

The port records spans where its engine and trainer do their work
(`aura:<name>` host events, `aura_snn_rag_tpu_torch/utils/trace.span`,
on while the program's spans are turned on) and always-on counters
(`utils/trace.counters`: `path.<retrieval path>`, `aux_build`,
`sync.<site>` per host wait). The profiler puts host events
and device activity on one clock, so a device operation can be put down
to the program span open when it was launched. This module holds:

- `ProgramTrace`: a `trace.Trace` that also keeps the program's spans,
  the host time of each device operation's launch (the CUDA runtime or
  driver call with the operation's correlation id) and the counters'
  rise over the window; its idle gaps are labelled by the innermost span
  of either kind, a program span keeping its `aura:` prefix;
- `SpanProfiler`: a `trace.Profiler` that turns the program's spans on
  for the traced part of the window (or leaves them off, `spans=False`)
  and keeps the counters' rise over it;
- readers of six per-layer quantities over a run's `core.Outcome`, each
  None where the run recorded nothing of the kind;
- `main`: one traced run of a cell with `SpanProfiler` in the drivers'
  `trace.Profiler`'s place, printing its result line, then one line of
  the readings, the window's counters and each program span's host and
  device time:

    python3 perfbench/program_trace.py --workload <cell> --seed <n> \\
        [--spans 0|1]

No cell's result line reads these yet: the drivers build
`trace.Profiler`, whose trace keeps the harness's `bench:` spans only.
"""

from __future__ import annotations

import bisect
import functools
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import core, trace  # noqa: E402
from perfbench.trace import (  # noqa: E402
    SPAN_PREFIX, Interval, Trace, merge)

PROGRAM_PREFIX = "aura:"
SYNC = "sync."
LaunchedOp = Tuple[str, int, int, Optional[int]]   # + launch ns, or None


class ProgramTrace(Trace):
    """A window's device operations with their launch times, the
    harness's spans, the program's spans (full names, `aura:` kept) and
    the counters' rise (`counts`)."""

    def __init__(self, ops: List[LaunchedOp], spans: List[Interval],
                 window_s: float, program: List[Interval] = (),
                 counts: Optional[Dict[str, int]] = None):
        ops = sorted(ops, key=lambda x: x[1])
        super().__init__([op[:3] for op in ops], spans, window_s)
        self.launches = [op[3] for op in ops]
        self.unlaunched = sum(1 for t in self.launches if t is None)
        self.program_spans = sorted(program, key=lambda x: x[1])
        self.counts = None if counts is None else dict(counts)

    def _program(self, match) -> List[Tuple[int, int]]:
        return merge([(s, e) for n, s, e in self.program_spans
                      if match(n[len(PROGRAM_PREFIX):])])

    def program_span_s(self, name: str) -> float:
        """Host seconds inside program span `name`, nested ones once."""
        ivs = self._program(lambda n: n == name)
        return sum(e - s for s, e in ivs) / 1e9

    def program_span_count(self, name: str) -> int:
        full = PROGRAM_PREFIX + name
        return sum(1 for n, _, _ in self.program_spans if n == full)

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched while program span
        `name` was open, at any depth (operations whose launch was not
        found are left out and counted in `unlaunched`)."""
        ivs = self._program(lambda n: n == name)
        starts = [s for s, _ in ivs]
        total = 0
        for (_, s, e), t in zip(self.ops, self.launches):
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ivs[i][1]:
                total += e - s
        return total / 1e9

    def sync_s(self) -> float:
        """Host seconds inside any `sync.<site>` span, overlaps once."""
        return sum(e - s for s, e in self._program(
            lambda n: n.startswith(SYNC))) / 1e9

    def labels(self, times: List[int]) -> List[str]:
        """The innermost span of either kind open on the host at each of
        the sorted `times`: a harness span by its name without `bench:`,
        a program span by its full name (`Trace.labels` over both, the
        program's spans named as harness spans would be)."""
        both = self.spans + [(SPAN_PREFIX + n, s, e)
                             for n, s, e in self.program_spans]
        return Trace([], both, self.window_s).labels(times)


def program_events(prof) -> Tuple[List[LaunchedOp], List[Interval],
                                  List[Interval]]:
    """(device operations with their launch ns, harness spans, program
    spans) from a stopped `torch.profiler.profile`."""
    from torch.autograd import DeviceType
    ops, spans, program, launch_at = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        iv = (name, s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            # a span's copy on the device's timeline is no operation
            if not name.startswith((SPAN_PREFIX, PROGRAM_PREFIX)):
                ops.append(iv + (e.correlation_id(),))
        elif name.startswith(SPAN_PREFIX):
            spans.append(iv)
        elif name.startswith(PROGRAM_PREFIX):
            program.append(iv)
        elif name.startswith("cu"):        # a CUDA runtime or driver call
            launch_at[e.correlation_id()] = s
    return ([(n, s, e, launch_at.get(c)) for n, s, e, c in ops], spans,
            program)


def _program_tracing():
    """The program's `(counters, enable_spans)`, or None for a program
    that has neither."""
    try:
        from aura_snn_rag_tpu_torch.utils.trace import (counters,
                                                        enable_spans)
    except ImportError:
        return None
    return counters, enable_spans


class SpanProfiler(trace.Profiler):
    """`trace.Profiler` with the program's spans on between `start()` and
    `stop()` (left off with `spans=False`), and the counters' rise over
    the same part of the window kept in the trace. On a program without
    spans or counters it records what `trace.Profiler` does (`counts`
    None)."""

    def __init__(self, enabled: bool, device, spans: bool = True):
        super().__init__(enabled, device)
        self.spans = spans
        self._program = None
        self._c0: Dict[str, int] = {}
        self._was = False

    def start(self) -> None:
        if not self.enabled:
            return
        super().start()
        self._program = _program_tracing()
        if self._program is not None:
            counters, enable_spans = self._program
            self._c0 = dict(counters)
            self._was = enable_spans(self.spans)

    def stop(self) -> Optional[ProgramTrace]:
        if not self.enabled or self._prof is None:
            return None
        self._sync()
        window = time.perf_counter() - self._t0
        counts = None
        if self._program is not None:
            counters, enable_spans = self._program
            enable_spans(self._was)
            counts = {k: v - self._c0.get(k, 0) for k, v in counters.items()
                      if v != self._c0.get(k, 0)}
        self._prof.stop()
        ops, spans, program = program_events(self._prof)
        self._prof = None
        return ProgramTrace(ops, spans, window, program, counts)


# ----------------------------------------------------------------------
# readers over a run's `core.Outcome` (its `attempted`: the window's
# requests or steps); shares in percent
# ----------------------------------------------------------------------

def _program_trace(out) -> Optional[ProgramTrace]:
    tr = out.trace
    return tr if isinstance(tr, ProgramTrace) else None


def host_syncs_per_call(out) -> Optional[float]:
    """The program's counted host waits (`sync.*`) per request or step
    of the window."""
    tr = _program_trace(out)
    if tr is None or tr.counts is None or not out.attempted:
        return None
    return sum(v for k, v in tr.counts.items()
               if k.startswith(SYNC)) / out.attempted


def aux_builds_per_call(out) -> Optional[float]:
    """IVF aux sidecars built (`aux_build`) per request of the window."""
    tr = _program_trace(out)
    if tr is None or tr.counts is None or not out.attempted:
        return None
    return tr.counts.get("aux_build", 0) / out.attempted


def annex_device_ms(out) -> Optional[float]:
    """Device ms per call of the operations launched inside
    `engine.annex` (the annex's coarse scores, top-k, rerank, merge)."""
    tr = _program_trace(out)
    if tr is None or not out.attempted or not tr.ops \
            or not tr.program_span_count("engine.annex"):
        return None
    return 1e3 * tr.span_device_s("engine.annex") / out.attempted


def sync_wait_share(out) -> Optional[float]:
    """Host time inside the program's `sync.*` spans over the window."""
    tr = _program_trace(out)
    if tr is None or tr.window_s <= 0 or not any(
            n.startswith(PROGRAM_PREFIX + SYNC)
            for n, _, _ in tr.program_spans):
        return None
    return 100.0 * tr.sync_s() / tr.window_s


def retrieve_span_share(out) -> Optional[float]:
    """Host time inside `engine.retrieve_auto` over the window."""
    tr = _program_trace(out)
    if tr is None or tr.window_s <= 0 \
            or not tr.program_span_count("engine.retrieve_auto"):
        return None
    return 100.0 * tr.program_span_s("engine.retrieve_auto") / tr.window_s


READERS = {"host_syncs_per_call": host_syncs_per_call,
           "aux_builds_per_call": aux_builds_per_call,
           "annex_device_ms": annex_device_ms,
           "sync_wait_share": sync_wait_share,
           "retrieve_span_share": retrieve_span_share}


def summary(out) -> dict:
    """The readings, the window's rate and counters, and each program
    span's count, host seconds and device seconds."""
    tr = _program_trace(out)
    line = {name: read(out) for name, read in READERS.items()}
    if tr is None:
        return line
    names = sorted({n[len(PROGRAM_PREFIX):] for n, _, _ in
                    tr.program_spans})
    line.update(
        calls_per_s=out.attempted / tr.window_s if tr.window_s else None,
        window_s=tr.window_s, counts=tr.counts,
        unlaunched_ops=tr.unlaunched, ops=len(tr.ops),
        program_spans={n: [tr.program_span_count(n), tr.program_span_s(n),
                   tr.span_device_s(n)] for n in names})
    return line


def main(argv=None, device=None, sizes=None) -> int:
    """One traced run (`--spans 1`: the program's spans on; 0: off, the
    counters kept). `device` and `sizes` are for the tests, as in
    `run.main`."""
    import argparse
    import torch
    ap = argparse.ArgumentParser(prog="perfbench/program_trace.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cell = core.load_cell(core.load_spec(), args.workload)
    if device is None:
        core.require_cuda(cell.chips)
        device = torch.device("cuda", 0)
    run = core.Run(cell, args.seed, args.seconds, True,
                   torch.device(device), time.perf_counter(),
                   dict(sizes or {}))
    stock = trace.Profiler
    trace.Profiler = functools.partial(SpanProfiler,
                                       spans=bool(args.spans))
    try:
        out = core.load_driver(cell.traffic["driver"]).run(run)
    finally:
        trace.Profiler = stock
    line = core.result_line(cell, out, core.device_info(
        run.device, cell.chips, out.memory_peak_bytes), True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"spans_on": bool(args.spans), **summary(out)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
