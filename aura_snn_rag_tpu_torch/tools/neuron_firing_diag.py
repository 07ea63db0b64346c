"""Firing-rate curves of the neuron models across input drives
(counterpart of `tools/neuron_firing_diag.py`).

    python -m aura_snn_rag_tpu_torch.tools.neuron_firing_diag
        [--device cuda]

The JAX script's drives and models: constant drives 0.1, 0.5, 1, 2, 5
and 10 for 200 steps into 8 neurons of LIF, GIF (8 levels), Izhikevich
regular spiking (x 3) and AdEx (x 8), each one's mean spike; then the
spike counts of the first eight Izhikevich presets at a drive of 10 for
400 steps. Prints the report (indented JSON) and a warning for each model
that is silent at every drive.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.ops.izhikevich_presets import (
    IZHIKEVICH_PRESETS, get_preset)
from aura_snn_rag_tpu_torch.ops.neurons import (
    adex_params, adex_scan, gif_params, gif_scan, izhikevich_scan,
    lif_params, lif_scan)

DRIVES = (0.1, 0.5, 1.0, 2.0, 5.0, 10.0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.tools.neuron_firing_diag",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap


class DiagResult(NamedTuple):
    report: dict
    warnings: List[str]
    spikes: Dict[str, torch.Tensor]    # "<model>@<drive>" -> spikes


def run(argv: Optional[Sequence[str]] = None) -> DiagResult:
    """The diagnostic at the flags in `argv`; prints its report."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    report, spikes = {}, {}
    for drive in DRIVES:
        x = torch.ones((1, 200, 8), device=dev) * drive
        runs = (("lif", lif_scan(lif_params(8, device=dev), x)[0]),
                ("gif", gif_scan(gif_params(levels=8), x)[0]),
                ("izhikevich_rs",
                 izhikevich_scan(get_preset("regular_spiking"), x * 3)[0]),
                ("adex", adex_scan(adex_params(), x * 8)[0]))
        for model, s in runs:
            report.setdefault(model, {})[str(drive)] = float(s.mean())
            spikes[f"{model}@{drive}"] = s

    # the presets' firing patterns at one drive
    x = torch.ones((1, 400, 1), device=dev) * 10.0
    patterns = {}
    for name in list(IZHIKEVICH_PRESETS)[:8]:
        s, _ = izhikevich_scan(get_preset(name), x)
        patterns[name] = float(s.sum())
        spikes[f"pattern:{name}"] = s
    report["izhikevich_pattern_spike_counts"] = patterns

    print(json.dumps(report, indent=2), flush=True)
    warnings = []
    for model, curve in report.items():
        if isinstance(curve, dict) and all(
                isinstance(v, float) and v == 0.0 for v in curve.values()):
            warnings.append(f"WARNING: {model} silent across all drives")
            print(warnings[-1], flush=True)
    return DiagResult(report, warnings, spikes)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the diagnostic (it prints its report); returns the report."""
    return run(argv).report


if __name__ == "__main__":
    main()
