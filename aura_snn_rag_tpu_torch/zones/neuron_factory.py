"""Per-neuron biological metadata objects and their factory (counterpart of
`aura_snn_rag_tpu/zones/neuron_factory.py`, a numpy copy): neurons that
carry maturation, fatigue and gene-expression metadata and a seeded
weight vector, and a factory keyed by neuron type. No compute path runs
them; they serve the brain-simulation bookkeeping API.

Each neuron seeds its weights from Python's `hash` of its id, which
changes from process to process unless PYTHONHASHSEED is set, as in the
JAX package: two neurons of one id agree within one process.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np


class NeuronType(Enum):
    LIF = "lif"
    IZHIKEVICH = "izhikevich"
    ADEX = "adex"
    GIF = "gif"


class MaturationStage(Enum):
    PROGENITOR = "progenitor"
    IMMATURE = "immature"
    MATURE = "mature"
    SENESCENT = "senescent"


@dataclass
class NeuronalState:
    maturation: MaturationStage = MaturationStage.IMMATURE
    fatigue: float = 0.0
    gene_expression: Dict[str, float] = field(default_factory=dict)
    firing_count: int = 0


@dataclass
class Neuron:
    neuron_id: str
    neuron_type: NeuronType
    n_inputs: int
    state: NeuronalState = field(default_factory=NeuronalState)
    weights: Optional[np.ndarray] = None
    threshold: float = 0.6

    def __post_init__(self):
        if self.weights is None:
            rng = np.random.RandomState(abs(hash(self.neuron_id)) % (2**31))
            self.weights = (rng.randn(self.n_inputs)
                            / np.sqrt(self.n_inputs)).astype(np.float32)

    def stimulate(self, inputs: np.ndarray) -> bool:
        """Scalar integrate-and-fire step with fatigue accounting."""
        drive = float(np.dot(self.weights, inputs))
        fired = drive * (1.0 - self.state.fatigue) > self.threshold
        if fired:
            self.state.firing_count += 1
            self.state.fatigue = min(1.0, self.state.fatigue + 0.05)
        else:
            self.state.fatigue = max(0.0, self.state.fatigue - 0.01)
        return fired

    def mature(self) -> None:
        stages = list(MaturationStage)
        i = stages.index(self.state.maturation)
        if i < len(stages) - 1:
            self.state.maturation = stages[i + 1]


class NeuronFactory:
    """Creates and tracks per-neuron objects by type."""

    def __init__(self, seed: int = 0):
        self._count = 0
        self.created: Dict[str, Neuron] = {}
        self.seed = seed

    def create(self, neuron_type: str = "lif", n_inputs: int = 16,
               **kw) -> Neuron:
        nid = f"{neuron_type}-{self._count}"
        self._count += 1
        n = Neuron(nid, NeuronType(neuron_type), n_inputs, **kw)
        self.created[nid] = n
        return n

    def create_population(self, n: int, neuron_type: str = "lif",
                          n_inputs: int = 16) -> List[Neuron]:
        return [self.create(neuron_type, n_inputs) for _ in range(n)]

    def stats(self) -> Dict[str, int]:
        by_type: Dict[str, int] = {}
        for n in self.created.values():
            by_type[n.neuron_type.value] = \
                by_type.get(n.neuron_type.value, 0) + 1
        return {"total": len(self.created), **by_type}
