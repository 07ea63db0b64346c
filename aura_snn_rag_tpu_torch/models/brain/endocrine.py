"""Endocrine system: hormone-based homeostatic training control (a copy
of `aura_snn_rag_tpu/models/brain/endocrine.py`, which imports no JAX;
the port keeps its own so it imports nothing of the JAX package).

Six hormones with half-life decay and capped release, EMA metrics
(accuracy, utilization, stress), and control laws: cortisol on stress >
0.5, dopamine on accuracy > 0.8, growth hormone on utilization < 0.4,
norepinephrine in proportion to stress. The trainer reads `lr_scale`
(clamped to [0.9, 1.1]) and `memory_gate` (clamped to [0.8, 1.2]).
Host-side Python: scalar math between steps, on a logical step clock.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict


class HormoneType(Enum):
    CORTISOL = "cortisol"
    GROWTH_HORMONE = "growth_hormone"
    THYROID = "thyroid"
    INSULIN = "insulin"
    DOPAMINE = "dopamine"
    NOREPINEPHRINE = "norepinephrine"


@dataclass
class Hormone:
    half_life: float = 3600.0
    max_concentration: float = 10.0
    concentration: float = 0.0

    def update(self, dt: float, release: float) -> float:
        self.concentration *= math.exp(-dt / self.half_life)
        self.concentration = min(self.concentration + release,
                                 self.max_concentration)
        return self.concentration


@dataclass
class SystemMetrics:
    prediction_accuracy: float = 0.0
    expert_utilization: float = 0.0
    stress_level: float = 0.0

    def update(self, accuracy: float, gate_diversity: float,
               energy: float, alpha: float = 0.9) -> None:
        self.prediction_accuracy = (alpha * self.prediction_accuracy
                                    + (1 - alpha) * accuracy)
        self.expert_utilization = (alpha * self.expert_utilization
                                   + (1 - alpha) * gate_diversity)
        current_stress = (1.0 - accuracy) * (1.0 + energy)
        self.stress_level = (alpha * self.stress_level
                             + (1 - alpha) * current_stress)


class EndocrineSystem:
    """Homeostatic hormone controller driven by training metrics."""

    def __init__(self, step_dt: float = 1.0):
        self.metrics = SystemMetrics()
        self.hormones: Dict[HormoneType, Hormone] = {
            h: Hormone() for h in HormoneType}
        self.step_dt = step_dt
        self.target_accuracy = 0.95
        self.target_utilization = 0.8

    def step(self, metrics_dict: Dict[str, float]) -> Dict[str, float]:
        acc = metrics_dict.get("accuracy", 0.5)
        div = metrics_dict.get("gate_diversity", 0.5)
        eng = metrics_dict.get("energy", 0.1)
        self.metrics.update(acc, div, eng)

        releases = {h: 0.0 for h in HormoneType}
        m = self.metrics
        if m.stress_level > 0.5:
            releases[HormoneType.CORTISOL] = (m.stress_level - 0.5) * 2.0
        if m.prediction_accuracy > 0.8:
            releases[HormoneType.DOPAMINE] = \
                (m.prediction_accuracy - 0.8) * 2.0
        if m.expert_utilization < 0.4:
            releases[HormoneType.GROWTH_HORMONE] = \
                (0.4 - m.expert_utilization) * 2.0
        releases[HormoneType.NOREPINEPHRINE] = m.stress_level * 0.5

        return {
            h.value: self.hormones[h].update(self.step_dt,
                                             releases[h] * 0.1)
            for h in HormoneType
        }

    @staticmethod
    def lr_scale(levels: Dict[str, float]) -> float:
        """LR modulation, clamped to [0.9, 1.1]."""
        s = 1.0 + 0.01 * (levels.get("dopamine", 0.0)
                          - levels.get("cortisol", 0.0)
                          + 0.5 * levels.get("thyroid", 0.0))
        return max(0.9, min(1.1, s))

    @staticmethod
    def memory_gate(levels: Dict[str, float]) -> float:
        """Memory gate, clamped to [0.8, 1.2]."""
        s = (1.0 + 0.2 * levels.get("norepinephrine", 0.0)
             - 0.2 * levels.get("cortisol", 0.0))
        return max(0.8, min(1.2, s))
