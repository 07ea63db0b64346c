"""Izhikevich firing-pattern presets (counterpart of
`aura_snn_rag_tpu/ops/izhikevich_presets.py`): the canonical (a, b, c, d)
parameter sets of Izhikevich's "Which Model to Use for Cortical Spiking
Neurons?" (2004) and the standard cortical cell classes, `get_preset`,
and loaders for presets in CSV (name, a, b, c, d) and in the JSON layout
{"models": {"1_izhikevich": {name: {a, b, c, d}}}}.
"""

from __future__ import annotations

import csv
import json
from typing import Dict

from aura_snn_rag_tpu_torch.ops.neurons import (
    IzhikevichParams, izhikevich_params)

# name -> dict(a, b, c, d)
IZHIKEVICH_PRESETS: Dict[str, Dict[str, float]] = {
    # cortical cell classes
    "regular_spiking":        dict(a=0.02, b=0.2, c=-65.0, d=8.0),
    "intrinsically_bursting": dict(a=0.02, b=0.2, c=-55.0, d=4.0),
    "chattering":             dict(a=0.02, b=0.2, c=-50.0, d=2.0),
    "fast_spiking":           dict(a=0.1, b=0.2, c=-65.0, d=2.0),
    "low_threshold_spiking":  dict(a=0.02, b=0.25, c=-65.0, d=2.0),
    "thalamo_cortical":       dict(a=0.02, b=0.25, c=-65.0, d=0.05),
    "resonator":              dict(a=0.1, b=0.26, c=-65.0, d=2.0),
    # figure-1 taxonomy (2004 paper)
    "tonic_spiking":          dict(a=0.02, b=0.2, c=-65.0, d=6.0),
    "phasic_spiking":         dict(a=0.02, b=0.25, c=-65.0, d=6.0),
    "tonic_bursting":         dict(a=0.02, b=0.2, c=-50.0, d=2.0),
    "phasic_bursting":        dict(a=0.02, b=0.25, c=-55.0, d=0.05),
    "mixed_mode":             dict(a=0.02, b=0.2, c=-55.0, d=4.0),
    "spike_frequency_adaptation": dict(a=0.01, b=0.2, c=-65.0, d=8.0),
    "class_1":                dict(a=0.02, b=-0.1, c=-55.0, d=6.0),
    "class_2":                dict(a=0.2, b=0.26, c=-65.0, d=0.0),
    "spike_latency":          dict(a=0.02, b=0.2, c=-65.0, d=6.0),
    "subthreshold_oscillations": dict(a=0.05, b=0.26, c=-60.0, d=0.0),
    "resonator_2":            dict(a=0.1, b=0.26, c=-60.0, d=-1.0),
    "integrator":             dict(a=0.02, b=-0.1, c=-55.0, d=6.0),
    "rebound_spike":          dict(a=0.03, b=0.25, c=-60.0, d=4.0),
    "rebound_burst":          dict(a=0.03, b=0.25, c=-52.0, d=0.0),
    "threshold_variability":  dict(a=0.03, b=0.25, c=-60.0, d=4.0),
    "bistability":            dict(a=0.1, b=0.26, c=-60.0, d=0.0),
    "depolarizing_after_potential": dict(a=1.0, b=0.2, c=-60.0, d=-21.0),
    "accommodation":          dict(a=0.02, b=1.0, c=-55.0, d=4.0),
    "inhibition_induced_spiking": dict(a=-0.02, b=-1.0, c=-60.0, d=8.0),
    "inhibition_induced_bursting": dict(a=-0.026, b=-1.0, c=-45.0, d=-2.0),
}


def get_preset(name: str, dt: float = 0.2) -> IzhikevichParams:
    if name not in IZHIKEVICH_PRESETS:
        raise KeyError(f"unknown Izhikevich preset {name!r}; "
                       f"available: {sorted(IZHIKEVICH_PRESETS)}")
    p = IZHIKEVICH_PRESETS[name]
    return izhikevich_params(p["a"], p["b"], p["c"], p["d"], dt)


def load_presets_csv(path: str) -> Dict[str, Dict[str, float]]:
    """Presets from CSV columns (name or pattern, a, b, c, d)."""
    out = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            name = row.get("name") or row.get("pattern")
            if not name:
                continue
            out[name] = {k: float(row[k]) for k in ("a", "b", "c", "d")
                         if k in row}
    return out


def load_presets_json(path: str) -> Dict[str, Dict[str, float]]:
    """Presets from the JSON layout models['1_izhikevich'] (or a flat
    {name: {a, b, c, d}} mapping); other keys of an entry are ignored."""
    with open(path) as f:
        data = json.load(f)
    models = data.get("models", data)
    izh = models.get("1_izhikevich", models)
    out = {}
    for name, params in izh.items():
        if isinstance(params, dict) and "a" in params:
            out[name] = {k: float(params[k]) for k in ("a", "b", "c", "d")}
    return out
