"""The harness's plumbing: the spec in `BENCHMARK.json`, the run's
context, the compared numbers, the device check and the result line.

Nothing here imports the port: the drivers do, inside their functions.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "aura_snn_rag_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result: the process exits non-zero and
    prints no result line."""


# ----------------------------------------------------------------------
# the spec
# ----------------------------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(path: Path = SPEC_FILE) -> dict:
    if not path.exists():
        raise BenchError(f"{path} not found")
    return load_json(path)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclass
class Cell:
    """One entry of `workloads`, with its configuration and traffic files
    read, and the metrics it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether a metric belongs to a cell: its `workloads` list names the
    cell, or, without one, the cell reports the end-to-end metric it
    moves (an end-to-end metric without the list belongs to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(spec: dict, name: str) -> Cell:
    w = find(spec["workloads"], name, "workload")
    cfg_entry = find(spec["configs"], w["config"], "config")
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if applies(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def load_driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def load_reader(metric: str) -> Callable:
    """`perfbench/metrics/<metric>.py`'s `read(run)`; loaded by path, as
    metric names carry dots."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        raise BenchError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------
# a run
# ----------------------------------------------------------------------

@dataclass
class Check:
    """One compared number: correct iff `value <= limit` (`rule` "max")
    or `value >= limit` ("min"). A value that is not a finite number
    fails."""
    name: str
    value: float
    limit: float
    rule: str = "max"

    @property
    def ok(self) -> bool:
        v = float(self.value)
        if not math.isfinite(v):
            return False
        return v <= self.limit if self.rule == "max" else v >= self.limit


@dataclass
class Outcome:
    """What a driver hands back: end-to-end values by name, the numbers
    compared, request counts, the device memory peak, and what the
    per-layer readers read (`trace`, `counts`, `info`)."""
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None
    counts: Dict[str, float] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


@dataclass
class Run:
    """The context a driver gets: the cell, the arguments, the device,
    and the clock the set-up time is read from."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    sizes: Dict[str, Any] = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return dict(self.cell.traffic, **self.sizes.get("traffic", {}))

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start

    def span(self, name: str):
        """A harness span around a call into a layer, recorded by the
        profiler in traced runs only."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def quiet_gc() -> None:
    """Before a window: collect, then freeze what set-up left, so the
    window's collections walk only what the window allocates."""
    gc.collect()
    gc.freeze()


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one of a run's independent streams (rows, queries,
    samples), below 2**63 for any run seed."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)


def p95(values: List[float]) -> float:
    """The 95th percentile (`statistics.quantiles`, exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[94]


# ----------------------------------------------------------------------
# device and isolation checks
# ----------------------------------------------------------------------

def require_cuda(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: the "
                         "benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def forbidden_loaded() -> List[str]:
    """Modules in `sys.modules` whose whole top-level name is JAX's,
    flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def device_info(device, count: int, peak: int) -> dict:
    import torch
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": int(peak)}


# ----------------------------------------------------------------------
# the result
# ----------------------------------------------------------------------

def result_line(cell: Cell, out: Outcome, dev: dict, trace: bool) -> dict:
    """The last line of standard output. With `trace` the metrics are the
    cell's per-layer ones (a reader that finds nothing is left out), else
    its end-to-end ones. The compared numbers come last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"])(out)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        tr = out.trace
        if tr is not None:
            dev = dict(dev, busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        for m in cell.end_to_end:
            if m["name"] not in out.end_to_end:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": float(c.value), "limit": c.limit,
                               "rule": c.rule, "ok": c.ok}
                      for c in out.checks}
    return line


def checks_text(checks: List[Check]) -> str:
    return "\n".join(
        f"check {c.name}: {c.value!r} {'<=' if c.rule == 'max' else '>='} "
        f"{c.limit!r} {'ok' if c.ok else 'FAILED'}" for c in checks)
