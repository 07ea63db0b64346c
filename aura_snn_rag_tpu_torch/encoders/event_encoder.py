"""Keyword-driven event-pattern encoder (a copy of
`aura_snn_rag_tpu/encoders/event_encoder.py`, host numpy; the port keeps
its own): keyword -> event-pattern vectors, from a file or drawn from
`np.random.RandomState(seed)`, compiled-regex keyword matching, event
weights and an analysis helper. `save` writes the JAX package's format,
an `.npz` with the event names, the patterns and a pickled
`keyword_map`, so either package loads the other's file.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

DEFAULT_EVENTS = {
    "motion": ("run", "walk", "move", "jump", "fly"),
    "communication": ("say", "tell", "speak", "write", "ask"),
    "cognition": ("think", "know", "believe", "understand", "remember"),
    "emotion": ("love", "hate", "fear", "enjoy", "worry"),
    "creation": ("make", "build", "create", "design", "produce"),
    "destruction": ("break", "destroy", "damage", "remove", "delete"),
}


class FastEventPatternEncoder:
    """Keyword -> event-pattern features with compiled-regex matching."""

    def __init__(self, d_model: int = 64,
                 pattern_file: Optional[str] = None, seed: int = 0):
        self.d_model = d_model
        if pattern_file and os.path.exists(pattern_file):
            data = np.load(pattern_file, allow_pickle=True)
            self.event_names = list(data["event_names"])
            self.patterns = np.asarray(data["patterns"], np.float32)
            self.keyword_to_event = dict(data["keyword_map"].item())
        else:
            rng = np.random.RandomState(seed)
            self.event_names = list(DEFAULT_EVENTS)
            self.patterns = rng.randn(
                len(self.event_names), d_model).astype(np.float32)
            self.patterns /= np.linalg.norm(
                self.patterns, axis=1, keepdims=True)
            self.keyword_to_event = {
                kw: i for i, (ev, kws) in enumerate(DEFAULT_EVENTS.items())
                for kw in kws}
        self.event_weights = np.ones(len(self.event_names), np.float32)
        self._regex = re.compile(
            r"\b(" + "|".join(map(re.escape, self.keyword_to_event)) + r")\b",
            re.IGNORECASE)

    def extract_events(self, text: str) -> np.ndarray:
        """Per-event activation counts [n_events]."""
        counts = np.zeros(len(self.event_names), np.float32)
        for m in self._regex.finditer(text or ""):
            counts[self.keyword_to_event[m.group(0).lower()]] += 1.0
        return counts

    def encode(self, text: str) -> np.ndarray:
        """Text -> [d_model] weighted event-pattern feature vector (unit
        norm, or zeros when no keyword matches)."""
        counts = self.extract_events(text) * self.event_weights
        feat = counts @ self.patterns
        norm = np.linalg.norm(feat)
        return feat / norm if norm > 0 else feat

    def get_event_analysis(self, text: str) -> Dict[str, float]:
        counts = self.extract_events(text)
        total = counts.sum()
        return {ev: float(c / total) if total else 0.0
                for ev, c in zip(self.event_names, counts)}

    def save(self, path: str) -> None:
        np.savez(path, event_names=np.asarray(self.event_names),
                 patterns=self.patterns,
                 keyword_map=np.asarray(self.keyword_to_event))
