"""Spiking against dense energy estimates of the spiking FFN's layers
(counterpart of `benchmarks/bench_energy_tracking.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_energy_tracking
        [--device cuda]

The JAX script's study: a GIF layer (8 levels) over [8, 16, 256] normal
currents and a sparse LIF-like layer whose spikes are uniform draws
below 0.1, each recorded by `EnergyTracker` at a fan-out of 256; prints
the per-component picojoule report and the summary, rounded to 2
places. JAX draws its inputs from threefry keys, which torch cannot
make: here they come from CPU `torch.Generator`s seeded 0 and 1 (the
currents normal, the sparse layer's draws uniform), unless `run` is
given them.
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple, Optional, Sequence

import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.ops.neurons import gif_params, gif_scan
from aura_snn_rag_tpu_torch.utils.energy import EnergyTracker

SHAPE = (8, 16, 256)
FAN_OUT = 256


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_energy_tracking",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap


class EnergyResult(NamedTuple):
    line: dict                    # the JSON line
    tracker: EnergyTracker


def run(argv: Optional[Sequence[str]] = None,
        currents: Optional[torch.Tensor] = None,
        uniform: Optional[torch.Tensor] = None) -> EnergyResult:
    """The study at the flags in `argv`, on `currents` (the GIF layer's
    input) and `uniform` (the sparse layer's draws) when given."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if currents is None:
        currents = torch.randn(SHAPE, generator=torch.Generator()
                               .manual_seed(0))
    if uniform is None:
        uniform = torch.rand(SHAPE, generator=torch.Generator()
                             .manual_seed(1))
    tracker = EnergyTracker()
    spikes, _ = gif_scan(gif_params(levels=8), currents.to(dev))
    tracker.record("gif_layer", spikes, fan_out=FAN_OUT)
    lif_spikes = (uniform.to(dev) < 0.1).to(torch.float32)
    tracker.record("sparse_lif_layer", lif_spikes, fan_out=FAN_OUT)
    report = tracker.energy_pj()
    summary = tracker.summary()
    line = {
        "per_component": {k: {kk: round(vv, 2) for kk, vv in v.items()}
                          for k, v in report.items()},
        "summary": {k: round(v, 2) for k, v in summary.items()},
    }
    return EnergyResult(line, tracker)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the study and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
