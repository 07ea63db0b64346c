"""Neuromorphic telemetry: firing rates, gradient health, stability
(counterpart of `aura_snn_rag_tpu/zones/stats.py`).

Per-zone firing rates, surrogate-slope distribution, membrane stats,
gradient-flow health per module, training-stability classification
with history, JSON save/load and recommendation heuristics. Where the
JAX package walks a flax parameter tree, the port walks a module's
`named_parameters()` (or any iterable of (name, tensor) pairs or a
{name: tensor} dict); a tensor is read to the host once, where it is
used.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _named(params):
    """(name, tensor) pairs from a module, a dict or an iterable of pairs."""
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    if isinstance(params, dict):
        return list(params.items())
    return list(params)


@dataclass
class BrainStats:
    zone_firing_rates: Dict[str, float] = field(default_factory=dict)
    slope_stats: Dict[str, float] = field(default_factory=dict)
    membrane_stats: Dict[str, float] = field(default_factory=dict)
    grad_health: Dict[str, float] = field(default_factory=dict)
    stability: str = "unknown"
    step: int = 0
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "zone_firing_rates": self.zone_firing_rates,
            "slope_stats": self.slope_stats,
            "membrane_stats": self.membrane_stats,
            "grad_health": self.grad_health,
            "stability": self.stability,
            "step": self.step,
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BrainStats":
        return cls(**{k: d.get(k, v) for k, v in
                      cls().__dict__.items()})


class StatsCollector:
    """Accumulates BrainStats over training; classifies stability.

    Live-activity depth (reference snn_brain_stats.py:204-392): zone
    forwards report firing rate + membrane stats per call
    (`update_zone_activity`), the collector keeps firing-rate and
    stability histories for trend analysis, and `health_summary()` /
    `get_recommendations()` reproduce the reference's silent/hyperactive/
    gradient-flow heuristics.
    """

    # zone health bands (snn_brain_stats.py zone_health_status semantics)
    SILENT_RATE = 0.001
    LOW_RATE = 0.01
    HIGH_RATE = 0.5
    HYPERACTIVE_RATE = 0.8

    def __init__(self, history_len: int = 100):
        self.history: deque = deque(maxlen=history_len)
        self.current = BrainStats()
        self.firing_rate_history: deque = deque(maxlen=1000)
        self.stability_history: deque = deque(maxlen=1000)
        self.loss_history: deque = deque(maxlen=1000)

    # ------------------------------------------------------------------
    def update_firing_rates(self, rates: Dict[str, float]) -> None:
        self.current.zone_firing_rates.update(
            {k: float(v) for k, v in rates.items()})

    def update_zone_activity(self, zone: str,
                             stats: Dict[str, Any]) -> None:
        """Ingest one zone forward's activity dict (the zone returns
        avg_firing_rate / spike_count / membrane_mean / membrane_std as
        device scalars — fetch once, here)."""
        if "avg_firing_rate" in stats:
            rate = float(_to_numpy(stats["avg_firing_rate"]))
            self.current.zone_firing_rates[zone] = rate
        if "membrane_mean" in stats:
            self.current.membrane_stats[f"{zone}_mean"] = float(
                _to_numpy(stats["membrane_mean"]))
        if "membrane_std" in stats:
            self.current.membrane_stats[f"{zone}_std"] = float(
                _to_numpy(stats["membrane_std"]))

    @property
    def avg_firing_rate(self) -> float:
        rates = self.current.zone_firing_rates
        return float(np.mean(list(rates.values()))) if rates else 0.0

    def zone_health_status(self) -> Dict[str, str]:
        """'silent' | 'low' | 'healthy' | 'high' | 'hyperactive' per zone."""
        out = {}
        for zone, rate in self.current.zone_firing_rates.items():
            if rate < self.SILENT_RATE:
                out[zone] = "silent"
            elif rate < self.LOW_RATE:
                out[zone] = "low"
            elif rate > self.HYPERACTIVE_RATE:
                out[zone] = "hyperactive"
            elif rate > self.HIGH_RATE:
                out[zone] = "high"
            else:
                out[zone] = "healthy"
        return out

    def update_loss(self, loss: float) -> None:
        self.loss_history.append(float(loss))

    def update_from_params(self, params) -> None:
        """Extract surrogate-slope distribution stats from the parameters
        whose name holds "slope"."""
        slopes = [_to_numpy(t).ravel() for name, t in _named(params)
                  if "slope" in name]
        if slopes:
            s = np.concatenate(slopes)
            self.current.slope_stats = {
                "mean": float(s.mean()), "std": float(s.std()),
                "min": float(s.min()), "max": float(s.max()),
            }

    def update_grad_health(self, grads) -> None:
        """Per-top-level-module gradient norms + vanishing/exploding flags.

        `grads`: (name, gradient) pairs, a {name: gradient} dict or a
        module (its parameters' `.grad`). A top-level module is the first
        component of the name, and the index too for a `ModuleList` entry
        ("layers.3"). Also records the total-norm classification: stable
        between 1e-3 and 100, 'exploding' above 100, 'vanishing' below
        1e-3.
        """
        if isinstance(grads, torch.nn.Module):
            grads = [(n, p.grad) for n, p in grads.named_parameters()
                     if p.grad is not None]
        by_layer: Dict[str, float] = {}
        for name, leaf in _named(grads):
            parts = name.split(".")
            key = ".".join(parts[:2]) if (len(parts) > 2
                                          and parts[1].isdigit()) \
                else parts[0]
            g = float((torch.as_tensor(leaf).float() ** 2).sum())
            by_layer[key] = by_layer.get(key, 0.0) + g
        self.current.grad_health = {
            k: float(np.sqrt(v)) for k, v in by_layer.items()}
        total = float(np.sqrt(sum(by_layer.values())))
        self.current.grad_health["__total__"] = total
        if total > 100.0:
            flow = "exploding"
        elif total < 1e-3:
            flow = "vanishing"
        else:
            flow = "stable"
        self.stability_history.append(flow)

    def update_membrane(self, mems: Dict[str, torch.Tensor]) -> None:
        for name, m in mems.items():
            arr = _to_numpy(m)
            self.current.membrane_stats[f"{name}_mean"] = float(arr.mean())
            self.current.membrane_stats[f"{name}_std"] = float(arr.std())

    # ------------------------------------------------------------------
    def classify_stability(self, recent_losses: List[float]) -> str:
        """'stable' | 'improving' | 'oscillating' | 'diverging'."""
        if len(recent_losses) < 4:
            label = "unknown"
        else:
            arr = np.asarray(recent_losses, np.float64)
            if not np.all(np.isfinite(arr)):
                label = "diverging"
            else:
                half = len(arr) // 2
                delta = arr[half:].mean() - arr[:half].mean()
                rel_std = arr.std() / (abs(arr.mean()) + 1e-9)
                if delta > 0.1 * abs(arr[:half].mean()):
                    label = "diverging"
                elif rel_std > 0.5:
                    label = "oscillating"
                elif delta < -1e-4:
                    label = "improving"
                else:
                    label = "stable"
        self.current.stability = label
        return label

    def commit(self, step: int) -> BrainStats:
        self.current.step = step
        self.current.timestamp = time.time()
        if self.current.zone_firing_rates:
            self.firing_rate_history.append(self.avg_firing_rate)
        snapshot = BrainStats.from_dict(self.current.to_dict())
        self.history.append(snapshot)
        self.current = BrainStats()
        return snapshot

    # ------------------------------------------------------------------
    def health_summary(self) -> Dict[str, Any]:
        """Overall health + concerns + recommendations
        (snn_brain_stats.py:318-356 semantics)."""
        summary: Dict[str, Any] = {"overall_health": "good",
                                   "concerns": [], "recommendations": []}
        status = self.zone_health_status()
        silent = [z for z, s in status.items() if s == "silent"]
        hyper = [z for z, s in status.items() if s == "hyperactive"]
        if silent:
            summary["concerns"].append(f"silent zones: {silent}")
            summary["recommendations"].append(
                "increase surrogate slopes / input gain for silent zones")
            summary["overall_health"] = "concerning"
        if hyper:
            summary["concerns"].append(f"hyperactive zones: {hyper}")
            summary["recommendations"].append(
                "decrease surrogate slopes / add inhibition for "
                "hyperactive zones")
            summary["overall_health"] = "concerning"
        if self.stability_history:
            flow = self.stability_history[-1]
            if flow in ("exploding", "vanishing"):
                summary["concerns"].append(f"gradient flow: {flow}")
                summary["recommendations"].append(
                    "reduce LR + clip" if flow == "exploding"
                    else "raise LR / check connectivity")
                summary["overall_health"] = ("critical"
                                             if flow == "exploding"
                                             else "concerning")
        if len(self.firing_rate_history) > 10:
            trend = np.polyfit(
                range(10), list(self.firing_rate_history)[-10:], 1)[0]
            if trend < -0.01:
                summary["concerns"].append("decreasing firing-rate trend")
                summary["recommendations"].append(
                    "monitor for activity degradation")
        return summary

    def get_recommendations(self) -> List[str]:
        recs = []
        # live-activity heuristics (snn_brain_stats.py:358-392)
        rates = (self.history[-1].zone_firing_rates if self.history
                 else self.current.zone_firing_rates)
        if rates:
            avg = float(np.mean(list(rates.values())))
            if avg < self.LOW_RATE:
                recs.append("overall firing rate too low — increase "
                            "surrogate slopes")
            elif avg > 0.7:
                recs.append("overall firing rate too high — decrease "
                            "surrogate slopes")
        last = self.history[-1] if self.history else self.current
        for zone, rate in last.zone_firing_rates.items():
            if rate < self.LOW_RATE:
                recs.append(f"zone '{zone}' nearly silent "
                            f"(rate {rate:.3f}) — lower thresholds or "
                            "raise input gain")
            elif rate > self.HIGH_RATE:
                recs.append(f"zone '{zone}' saturated (rate {rate:.3f}) — "
                            "raise thresholds / add inhibition")
        for layer, g in last.grad_health.items():
            if layer == "__total__":
                continue
            if g < 1e-7:
                recs.append(f"vanishing gradients in '{layer}'")
            elif g > 1e3:
                recs.append(f"exploding gradients in '{layer}' — clip or "
                            "lower LR")
        if last.stability == "diverging":
            recs.append("training diverging — reduce LR / check data")
        elif last.stability == "oscillating":
            recs.append("loss oscillating — reduce LR or increase batch")
        recent = list(self.stability_history)[-5:]
        if recent.count("exploding") > 2:
            recs.append("frequent gradient explosion — reduce LR "
                        "significantly")
        elif recent.count("vanishing") > 2:
            recs.append("frequent vanishing gradients — raise LR or revisit "
                        "initialization")
        return recs

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([s.to_dict() for s in self.history], f)

    def load(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path) as f:
            self.history = deque(
                [BrainStats.from_dict(d) for d in json.load(f)],
                maxlen=self.history.maxlen)
