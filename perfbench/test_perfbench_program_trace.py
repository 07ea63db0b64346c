"""`program_trace`: the program's spans and launches on a synthetic
trace, the same `breakdown` as `trace.Trace` where the program recorded
no span, the readers, and traced runs of every cell with the program's
spans on (here on the CPU at small sizes; on the card, marked `cuda`).
"""

import json

import pytest
import torch

from perfbench import core, program_trace
from perfbench.program_trace import ProgramTrace
from perfbench.test_perfbench_run import CELLS, SIZES
from perfbench.test_perfbench_trace import MS, synthetic
from perfbench.trace import NO_SPAN


def programmed():
    """Device: kernels A [0, 2), B [4, 5), C [8, 9), one whose launch was
    not recorded [9, 10); host: harness span outer [0, 10), program
    spans retrieve [1, 7) > annex [3, 6) > sync [5, 6), and a second
    annex [7.5, 8); launches at 0.5 (A, outside the program's spans),
    3.5 (B, in the annex), 7.6 (C, in the second annex)."""
    ops = [("kernA", 0, 2 * MS, MS // 2), ("kernB", 4 * MS, 5 * MS,
                                           7 * MS // 2),
           ("kernC", 8 * MS, 9 * MS, 76 * MS // 10),
           ("kernD", 9 * MS, 10 * MS, None)]
    spans = [("bench:outer", 0, 10 * MS)]
    program = [("aura:engine.retrieve", 1 * MS, 7 * MS),
               ("aura:engine.annex", 3 * MS, 6 * MS),
               ("aura:sync.dispatch", 5 * MS, 6 * MS),
               ("aura:engine.annex", 75 * MS // 10, 8 * MS)]
    return ProgramTrace(ops, spans, 0.010, program,
                        {"sync.dispatch": 2, "aux_build": 1, "path.x": 2})


def test_program_spans_and_the_device_time_they_launched():
    tr = programmed()
    assert tr.program_span_s("engine.retrieve") == pytest.approx(0.006)
    assert tr.program_span_s("engine.annex") == pytest.approx(0.0035)
    assert tr.program_span_count("engine.annex") == 2
    assert tr.span_device_s("engine.annex") == pytest.approx(0.002)
    assert tr.span_device_s("engine.retrieve") == pytest.approx(0.001)
    assert tr.span_device_s("missing") == 0
    assert tr.unlaunched == 1
    assert tr.sync_s() == pytest.approx(0.001)


def test_gaps_labelled_by_the_innermost_span_of_either_kind():
    tr = programmed()
    assert tr.gaps() == [(2 * MS, 4 * MS), (5 * MS, 8 * MS)]
    assert tr.labels([2 * MS, 5 * MS, 6 * MS, 7 * MS + MS // 2,
                      11 * MS]) == [
        "aura:engine.retrieve", "aura:sync.dispatch",
        "aura:engine.retrieve", "aura:engine.annex", NO_SPAN]
    assert tr.breakdown()["idle_gaps"] == [
        ["aura:sync.dispatch", pytest.approx(0.003)],
        ["aura:engine.retrieve", pytest.approx(0.002)]]


def test_without_program_spans_the_breakdown_is_trace_s():
    base = synthetic()
    tr = ProgramTrace([op + (None,) for op in base.ops], base.spans,
                      base.window_s)
    assert tr.breakdown() == base.breakdown()
    assert tr.labels([3 * MS, 6 * MS, 11 * MS]) == base.labels(
        [3 * MS, 6 * MS, 11 * MS])
    assert (tr.busy_s, tr.idle_share(), tr.count()) == (
        base.busy_s, base.idle_share(), base.count())


def test_readers():
    out = core.Outcome({}, [], attempted=2, failed=0, memory_peak_bytes=0,
                       trace=programmed())
    assert program_trace.host_syncs_per_call(out) == pytest.approx(1.0)
    assert program_trace.aux_builds_per_call(out) == pytest.approx(0.5)
    assert program_trace.annex_device_ms(out) == pytest.approx(1.0)
    assert program_trace.sync_wait_share(out) == pytest.approx(10.0)
    assert program_trace.retrieve_span_share(out) is None
    # a program without spans or counters (the parent's), a trace of
    # `trace.Profiler`, or none at all
    base = synthetic()
    for tr in (ProgramTrace([op + (None,) for op in base.ops], base.spans,
                            base.window_s), base, None):
        out = core.Outcome({}, [], 2, 0, 0, trace=tr)
        assert all(read(out) is None
                   for read in program_trace.READERS.values())


def traced(capsys, cell, spans, device):
    rc = program_trace.main(["--workload", cell, "--seed", "7",
                             "--spans", str(spans)], device=device,
                            sizes=SIZES[cell])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-2]), json.loads(out[-1])


def check_against_counters(cell, line, prog):
    """The readings against the counters and spans they read."""
    assert line["correct"] is True
    n = line["attempted"]
    counts = prog["counts"]
    syncs = sum(v for k, v in counts.items() if k.startswith("sync."))
    assert prog["host_syncs_per_call"] == pytest.approx(syncs / n)
    spans = prog["program_spans"]
    if cell.startswith("lm-"):
        assert spans["trainer.step"][0] == n
        assert counts["sync.trainer.replay"] == 2 * n
        assert counts["sync.trainer.metrics"] == n
        assert prog["retrieve_span_share"] == pytest.approx(
            100 * spans["engine.retrieve_auto"][1] / prog["window_s"])
        assert prog["sync_wait_share"] > 0
    else:
        entry = "engine.retrieve_auto" if cell.endswith("auto-small") \
            else "engine.retrieve"
        assert spans[entry][0] == n
        assert sum(v for k, v in counts.items()
                   if k.startswith("path.")) == n
        assert prog["aux_builds_per_call"] == pytest.approx(
            counts.get("aux_build", 0) / n)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_with_the_program_s_spans(capsys, cell):
    line, prog = traced(capsys, cell, 1, "cpu")
    check_against_counters(cell, line, prog)
    line, off = traced(capsys, cell, 0, "cpu")
    assert off["program_spans"] == {} and off["counts"]
    assert off["sync_wait_share"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(capsys, cell):
    """Every device operation's launch found; the annex's device time
    read in the IVF cell; the idle gaps named by program spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, prog = traced(capsys, cell, 1, None)
    check_against_counters(cell, line, prog)
    assert prog["ops"] > 0 and prog["unlaunched_ops"] == 0, prog
    assert any(n.startswith("aura:")
               for n, _ in line["breakdown"]["idle_gaps"])
    if cell == "engine-1m.ivf-b1024":
        assert 0 < prog["annex_device_ms"] <= 1e3 * prog["program_spans"][
            "engine.retrieve"][2] / line["attempted"]


def test_main_leaves_the_drivers_profiler_as_it_was(capsys):
    from perfbench import trace
    stock = trace.Profiler
    traced(capsys, "engine-1m.auto-small", 1, "cpu")
    assert trace.Profiler is stock
