"""What the per-layer metrics read from a run's `core.Outcome`: its
trace (`trace.Trace`), the driver's counts and its computed bounds. Each
function returns None where the run has nothing to read (no trace, or no
operation of the kind), and the metric is then left out of the line.
Shares are in percent.
"""

from __future__ import annotations

from typing import Optional


def is_ivf(name: str) -> bool:
    """Kernel B's device functions (`csrc/ivf_scan.cu`, `ivf_*`)."""
    return "ivf_" in name


def kernel_b_roofline(out) -> Optional[float]:
    """Kernel B's bound per call (`counts.ivf.kernel_b`) over its device
    time per call (its launches' summed device time over the calls that
    retrieve)."""
    tr, calls = out.trace, out.counts.get("kernel_b_calls", 0)
    bound = out.info.get("kernel_counts", {}).get("kernel_b_bound_s")
    if tr is None or not calls or bound is None:
        return None
    dev_s = tr.device_s(is_ivf)
    if dev_s <= 0:
        return None
    return 100.0 * bound / (dev_s / calls)


def nonkernel_device_ms(out) -> Optional[float]:
    """Device ms per call of every operation that is not kernel B."""
    tr, calls = out.trace, out.counts.get("calls", 0)
    if tr is None or not calls or not tr.ops:
        return None
    return 1e3 * tr.device_s(lambda n: not is_ivf(n)) / calls


def call_mfu(out) -> Optional[float]:
    """The whole call's bound (`counts.ivf.retrieve_call`) over its wall
    time per call in the traced window."""
    tr, calls = out.trace, out.counts.get("calls", 0)
    bound = out.info.get("kernel_counts", {}).get("call_bound_s")
    if tr is None or not calls or bound is None or not tr.ops:
        return None
    return 100.0 * bound / (tr.window_s / calls)


def idle_share(out) -> Optional[float]:
    """The device's idle share of the traced window: 1 - the union of its
    operations' intervals over the window."""
    if out.trace is None:
        return None
    share = out.trace.idle_share()
    return None if share is None else 100.0 * share


def launches_per_call(out) -> Optional[float]:
    """Device operations (kernels, memsets, copies) per call."""
    tr, calls = out.trace, out.counts.get("calls", 0)
    if tr is None or not calls or not tr.ops:
        return None
    return tr.count() / calls


def span_share(out, span: str) -> Optional[float]:
    """Host time inside the harness's `span` spans over the traced
    window."""
    tr = out.trace
    if tr is None or not tr.span_count(span) or tr.window_s <= 0:
        return None
    return 100.0 * tr.span_s(span) / tr.window_s


def model_mfu(out) -> Optional[float]:
    """The model FLOPs of the traced window's work (`counts.lm`) over its
    wall time, against the card's bf16 peak."""
    from perfbench.counts.peaks import BF16_FLOPS
    tr, flops = out.trace, out.counts.get("model_flops")
    if tr is None or not flops or not tr.ops:
        return None
    return 100.0 * flops / tr.window_s / BF16_FLOPS
