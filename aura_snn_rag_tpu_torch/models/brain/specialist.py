"""Topic specialists: an NLMS-expert registry keyed by topic slug
(counterpart of `aura_snn_rag_tpu/models/brain/specialist.py`; numpy,
over the port's `NLMSExpert`)."""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from aura_snn_rag_tpu_torch.training.online import NLMSExpert


def slugify(topic: str) -> str:
    s = re.sub(r"[^a-z0-9]+", "-", topic.lower()).strip("-")
    return s or "topic"


class Specialist:
    """One topic expert: an NLMS head plus usage metadata."""

    def __init__(self, topic: str, in_dim: int, lr: float = 0.5):
        self.topic = topic
        self.slug = slugify(topic)
        self.expert = NLMSExpert(in_dim, lr=lr)
        self.updates = 0

    def predict(self, x: np.ndarray) -> float:
        return self.expert.predict(x)

    def update(self, x: np.ndarray, target: float) -> float:
        self.updates += 1
        return self.expert.update(x, target)

    @property
    def rmse(self) -> float:
        return self.expert.rmse


class SpecialistRegistry:
    """Slug-keyed registry with ensure-from-topics semantics."""

    def __init__(self, in_dim: int, lr: float = 0.5):
        self.in_dim = in_dim
        self.lr = lr
        self._specialists: Dict[str, Specialist] = {}

    def __len__(self) -> int:
        return len(self._specialists)

    def __contains__(self, topic: str) -> bool:
        return slugify(topic) in self._specialists

    def get(self, topic: str) -> Optional[Specialist]:
        return self._specialists.get(slugify(topic))

    def ensure(self, topic: str) -> Specialist:
        slug = slugify(topic)
        if slug not in self._specialists:
            self._specialists[slug] = Specialist(topic, self.in_dim, self.lr)
        return self._specialists[slug]

    def ensure_from_topics(self, topics: List[str]) -> List[Specialist]:
        return [self.ensure(t) for t in topics]

    def best_for(self, x: np.ndarray) -> Optional[Specialist]:
        """The specialist with the largest prediction magnitude."""
        if not self._specialists:
            return None
        return max(self._specialists.values(),
                   key=lambda s: abs(s.predict(x)))

    def topics(self) -> List[str]:
        return [s.topic for s in self._specialists.values()]
