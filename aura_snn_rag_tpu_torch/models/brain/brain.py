"""EnhancedBrain, the LiquidBrain online-learning pipeline, the central
nervous system, memory interpolation and homeostasis repair (counterpart
of `aura_snn_rag_tpu/models/brain/brain.py`):

- `EnhancedBrain` (alias `Brain`): brain zones (`zone_<name>`) behind a
  global `LiquidMoERouter` (`router`); each row's top-k routing weights
  are scattered into per-zone gains (`scatter_add_`), and the output is
  x + sum_z gain_z * zone_z(x);
- `LiquidBrain`: hash embedding -> running whitener -> Oja layer with
  neurogenesis (the "hippocampus") -> the NLMS expert of the lowest RMSE
  (the "cortex") -> the central nervous system's stress update; the
  whitener and the Oja state live on the brain's device, the experts on
  the host (numpy);
- `CentralNervousSystem`: stress EMA, consciousness levels and hormone
  levels derived from them (host);
- `TemporalMemoryInterpolator`: linear, Fourier, Hilbert (scipy's
  analytic signal) and Hamiltonian (phase-space rotation) interpolation
  of two vectors (numpy);
- `fix_neuromorphic_crisis`: resets the bias of zones whose last recorded
  firing rate ran away (> 0.5) or fell silent (< 0.01).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.encoders.hash_embedder import FastHashEmbedder
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import LiquidMoERouter
from aura_snn_rag_tpu_torch.models.layers import draw_device, initialize
from aura_snn_rag_tpu_torch.training.online import (
    NLMSExpert, OjaState, WhitenerState, init_oja, init_whitener,
    oja_forward, oja_step, whiten, whiten_update)
from aura_snn_rag_tpu_torch.zones.brain_zone import (
    BrainZoneConfig, NeuromorphicBrainZone)


class EnhancedBrain(nn.Module):
    """Zones + global Liquid-MoE routing with a weighted residual sum."""

    def __init__(self, zone_configs: Sequence[BrainZoneConfig],
                 d_model: int = 64, top_k: int = 2, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.zone_configs = tuple(zone_configs)
        n = len(self.zone_configs)
        self.router = LiquidMoERouter(d_model, min(128, d_model), n,
                                      top_k=min(top_k, n), device=draw)
        initialize(self.router, generator)
        for zc in self.zone_configs:
            self.add_module(f"zone_{zc.name}",
                            NeuromorphicBrainZone(zc, draw, generator))
        self.to(dev)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """x [B, D] -> (output [B, D], {"routing", "zone_stats"})."""
        routing = self.router(x)
        gains = torch.zeros(x.shape[0], len(self.zone_configs),
                            dtype=x.dtype, device=x.device).scatter_add_(
            1, routing["indices"], routing["weights"].to(x.dtype))
        out = x
        stats = {}
        for i, zc in enumerate(self.zone_configs):
            zone_out, zstats = getattr(self, f"zone_{zc.name}")(x)
            out = out + gains[:, i][:, None] * zone_out
            stats[zc.name] = zstats
        return out, {"routing": routing, "zone_stats": stats}


Brain = EnhancedBrain


class CentralNervousSystem:
    """Host-side stress / consciousness controller."""

    def __init__(self, stress_alpha: float = 0.95):
        self.stress = 0.0
        self.stress_alpha = stress_alpha
        self.consciousness = "alert"

    def update(self, error: float) -> Dict[str, float]:
        self.stress = (self.stress_alpha * self.stress
                       + (1 - self.stress_alpha) * min(abs(error), 10.0))
        if self.stress > 2.0:
            self.consciousness = "overwhelmed"
        elif self.stress > 0.5:
            self.consciousness = "stressed"
        elif self.stress > 0.1:
            self.consciousness = "alert"
        else:
            self.consciousness = "calm"
        return {
            "stress": self.stress,
            "cortisol": max(0.0, self.stress - 0.5),
            "norepinephrine": self.stress * 0.5,
            "dopamine": max(0.0, 0.5 - self.stress),
        }


class LiquidBrain:
    """Online-learning pipeline: hash embed -> whiten -> Oja -> NLMS
    cortex. The Oja weights come from a `torch.Generator` seeded `seed`
    on the brain's device (`models/convert.load_liquid_brain` carries a
    JAX brain's state across)."""

    def __init__(self, input_dim: int = 256, n_components: int = 16,
                 max_components: int = 256, n_experts: int = 4,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.embedder = FastHashEmbedder(dim=input_dim)
        self.whitener: WhitenerState = init_whitener(input_dim, self.device)
        self.hippocampus: OjaState = init_oja(
            torch.Generator(device=self.device).manual_seed(seed),
            input_dim, n_components, max_components, self.device)
        self.cortex: List[NLMSExpert] = [
            NLMSExpert(max_components) for _ in range(n_experts)]
        self.cns = CentralNervousSystem()
        self.steps = 0

    def _embed(self, text: str) -> torch.Tensor:
        return torch.as_tensor(self.embedder.embed(text),
                               device=self.device)[None, :]

    def learn_text(self, text: str, target: float) -> Dict[str, Any]:
        """One online step: embed, whiten, Oja features, NLMS prediction
        by the expert of the lowest recent error."""
        self.whitener, xw = whiten_update(self.whitener, self._embed(text))
        self.hippocampus, y = oja_step(self.hippocampus, xw)
        features = y[0].cpu().numpy()
        expert_idx = int(np.argmin([e.rmse for e in self.cortex]))
        err = self.cortex[expert_idx].update(features, target)
        hormones = self.cns.update(err)
        self.steps += 1
        return {"error": float(err), "expert": expert_idx,
                "K": int(self.hippocampus.K), "hormones": hormones,
                "consciousness": self.cns.consciousness}

    def predict_text(self, text: str) -> float:
        xw = whiten(self.whitener, self._embed(text))
        y = oja_forward(self.hippocampus, xw)[0].cpu().numpy()
        expert_idx = int(np.argmin([e.rmse for e in self.cortex]))
        return self.cortex[expert_idx].predict(y)


class TemporalMemoryInterpolator:
    """Interpolate between two memory vectors in several geometries."""

    MODES = ("linear", "fourier", "hilbert", "hamiltonian")

    def interpolate(self, a: np.ndarray, b: np.ndarray, t: float,
                    mode: str = "linear") -> np.ndarray:
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if mode == "linear":
            return ((1 - t) * a + t * b).astype(np.float32)
        if mode == "fourier":
            fa, fb = np.fft.rfft(a), np.fft.rfft(b)
            return np.fft.irfft((1 - t) * fa + t * fb,
                                n=len(a)).astype(np.float32)
        if mode == "hilbert":
            from scipy.signal import hilbert
            ha, hb = hilbert(a), hilbert(b)
            return np.real((1 - t) * ha + t * hb).astype(np.float32)
        if mode == "hamiltonian":
            # symplectic phase-space interpolation: (value, gradient) as
            # conjugate coordinates, rotated between the states
            pa = np.gradient(a)
            pb = np.gradient(b)
            theta = t * np.pi / 2.0
            q = np.cos(theta) * a + np.sin(theta) * b
            p = -np.sin(theta) * pa + np.cos(theta) * pb
            return (q + 0.0 * p).astype(np.float32)
        raise ValueError(f"unknown mode {mode!r}; expected {self.MODES}")


def fix_neuromorphic_crisis(plasticity_engine, stats_collector,
                            target_rate: float = 0.1) -> Dict[str, Any]:
    """Nudge the bias of runaway (> 0.5) and silent (< 0.01) zones by
    their last recorded firing rate."""
    repaired = []
    if stats_collector.history:
        last = stats_collector.history[-1]
        for zone, rate in last.zone_firing_rates.items():
            if rate > 0.5 or rate < 0.01:
                plasticity_engine.update(zone, rate)
                repaired.append(zone)
    return {"repaired_zones": repaired, "target_rate": target_rate}
