"""Neuromorphic energy accounting: spike counts per component turned into
picojoule estimates at published per-event costs, beside the dense-MAC
equivalent (counterpart of `aura_snn_rag_tpu/utils/energy.py`)."""

from __future__ import annotations

from typing import Dict

import torch

# energy per operation (picojoules), as in the JAX package
PJ_PER_SPIKE_EVENT = 1.0      # neuromorphic synaptic event (~Loihi class)
PJ_PER_MAC_8BIT = 0.03        # 8-bit MAC, 7nm-class digital
PJ_PER_MAC_BF16 = 0.25        # bf16 MAC


class EnergyTracker:
    """Accumulates spike counts per component and estimates energy."""

    def __init__(self):
        self.spike_counts: Dict[str, float] = {}
        self.synapse_counts: Dict[str, int] = {}
        self.dense_macs: Dict[str, float] = {}

    def record(self, component: str, spikes: torch.Tensor,
               fan_out: int) -> None:
        """Record a spike tensor and its synaptic fan-out (reads the
        spike count back to the host)."""
        n = float(spikes.sum())
        self.spike_counts[component] = \
            self.spike_counts.get(component, 0.0) + n
        self.synapse_counts[component] = fan_out
        # dense equivalent: every element would be a MAC
        self.dense_macs[component] = (
            self.dense_macs.get(component, 0.0)
            + float(spikes.numel()) * fan_out)

    def energy_pj(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for comp, n_spikes in self.spike_counts.items():
            fan_out = self.synapse_counts.get(comp, 1)
            spike_pj = n_spikes * fan_out * PJ_PER_SPIKE_EVENT
            dense_pj = self.dense_macs.get(comp, 0.0) * PJ_PER_MAC_BF16
            out[comp] = {
                "spike_events": n_spikes * fan_out,
                "spiking_pj": spike_pj,
                "dense_pj": dense_pj,
                "efficiency_ratio": dense_pj / spike_pj if spike_pj else 0.0,
            }
        return out

    def summary(self) -> Dict[str, float]:
        e = self.energy_pj()
        return {
            "total_spiking_pj": sum(v["spiking_pj"] for v in e.values()),
            "total_dense_pj": sum(v["dense_pj"] for v in e.values()),
            "components": len(e),
        }
