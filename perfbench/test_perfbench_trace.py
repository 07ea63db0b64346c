"""Idle share, busy time, span shares and `breakdown` from a synthetic
trace, and the readers that use them."""

import pytest

from perfbench import core, readers
from perfbench.trace import NO_SPAN, Trace, merge

MS = 1_000_000          # ns


def synthetic():
    # device: [0, 2) kernel A, [1, 3) ivf kernel (overlaps), [5, 6) A,
    # [9, 10) memset; host spans: outer [0, 10), inner [3, 6)
    ops = [("kernA", 0, 2 * MS), ("ivf_select", 1 * MS, 3 * MS),
           ("kernA", 5 * MS, 6 * MS), ("Memset", 9 * MS, 10 * MS)]
    spans = [("bench:outer", 0, 10 * MS), ("bench:inner", 3 * MS, 6 * MS)]
    return Trace(ops, spans, window_s=0.010)


def test_merge_unions_overlaps():
    assert merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


def test_busy_and_idle_from_the_union():
    tr = synthetic()
    assert tr.busy_s == pytest.approx(0.005)          # [0,3) [5,6) [9,10)
    assert tr.idle_share() == pytest.approx(0.5)
    assert tr.device_s() == pytest.approx(0.006)      # summed, overlap twice
    assert tr.device_s(readers.is_ivf) == pytest.approx(0.002)
    assert tr.count() == 4


def test_gaps_labelled_by_innermost_open_span():
    tr = synthetic()
    assert tr.gaps() == [(3 * MS, 5 * MS), (6 * MS, 9 * MS)]
    assert tr.labels([3 * MS, 6 * MS, 11 * MS]) == ["inner", "outer",
                                                     NO_SPAN]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["kernA", pytest.approx(0.003)]
    assert b["idle_gaps"] == [["outer", pytest.approx(0.003)],
                              ["inner", pytest.approx(0.002)]]


def test_span_time_and_share():
    tr = synthetic()
    assert tr.span_s("inner") == pytest.approx(0.003)
    assert tr.span_count("outer") == 1
    out = core.Outcome({}, [], 0, 0, 0, trace=tr)
    assert readers.span_share(out, "inner") == pytest.approx(30.0)
    assert readers.span_share(out, "missing") is None


def test_readers_use_counts_and_bounds():
    tr = synthetic()
    out = core.Outcome({}, [], 0, 0, 0, trace=tr,
                       counts={"calls": 2, "kernel_b_calls": 2,
                               "model_flops": 989e12 * 0.010 * 0.25},
                       info={"kernel_counts": {"kernel_b_bound_s": 0.0005,
                                               "call_bound_s": 0.001}})
    # kernel B: 2 ms over 2 calls = 1 ms a call against a 0.5 ms bound
    assert readers.kernel_b_roofline(out) == pytest.approx(50.0)
    assert readers.nonkernel_device_ms(out) == pytest.approx(2.0)
    assert readers.call_mfu(out) == pytest.approx(20.0)
    assert readers.launches_per_call(out) == pytest.approx(2.0)
    assert readers.idle_share(out) == pytest.approx(50.0)
    assert readers.model_mfu(out) == pytest.approx(25.0)


def test_readers_find_nothing_without_a_trace():
    out = core.Outcome({}, [], 0, 0, 0)
    for read in (readers.kernel_b_roofline, readers.nonkernel_device_ms,
                 readers.call_mfu, readers.idle_share,
                 readers.launches_per_call, readers.model_mfu):
        assert read(out) is None
