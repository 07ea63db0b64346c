"""Content routing and the neuromorphic processing runtime (counterpart of
`aura_snn_rag_tpu/zones/processor.py`):

- `ContentRouter`: keywords -> `ContentType` -> zones, and an external
  lexicon loaded from *.txt / *.jsonl / *.csv files whose names carry the
  zone hint;
- `NeuromorphicProcessor`: router modes "keyword", "liquid" and "topk"
  (the latter two route an embedding through a `LiquidMoERouter`),
  `build_plan` -> ordered (zone, weight) pairs (intent boosts, a softmax
  over every active zone, then the first `top_k`, so the weights need not
  sum to 1), `run_plan` / `process` -> the weighted sum of the zones'
  outputs, and usage stats. A zone that raises is logged, counted in
  `stats["errors"]` and skipped; when every zone fails the output is
  zeros like the input. A caller that must not see a swallowed failure
  checks `stats["errors"]`;
- `NeuralPlasticityEngine`: event-driven homeostatic nudges of per-zone
  bias currents (numpy) toward a target firing rate.

The processor holds a device for the liquid router, which it builds at
its first liquid route from a `torch.Generator` seeded 0 on the CPU
(JAX's `PRNGKey(0)` bits cannot be drawn here), or takes from
`set_liquid_router`.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.ops.maths import softmax_np
from aura_snn_rag_tpu_torch.zones.events import Event, EventBus

logger = logging.getLogger(__name__)


class ContentType(Enum):
    REASONING = "reasoning"
    MEMORY = "memory"
    LANGUAGE = "language"
    EMOTION = "emotion"
    CREATIVE = "creative"
    ANALYTICAL = "analytical"
    PATTERN = "pattern"
    TEMPORAL = "temporal"


_CONTENT_TO_ZONES = {
    ContentType.REASONING: ["prefrontal_cortex", "parietal_cortex"],
    ContentType.MEMORY: ["hippocampus", "temporal_cortex"],
    ContentType.LANGUAGE: ["temporal_cortex", "prefrontal_cortex"],
    ContentType.EMOTION: ["amygdala", "insular_cortex"],
    ContentType.CREATIVE: ["temporal_cortex", "prefrontal_cortex"],
    ContentType.ANALYTICAL: ["prefrontal_cortex"],
    ContentType.PATTERN: ["occipital_cortex", "parietal_cortex"],
    ContentType.TEMPORAL: ["hippocampus", "cerebellum"],
}

_KEYWORDS = {
    ContentType.REASONING: ("analyze", "logic", "reason", "conclude",
                            "deduce", "infer"),
    ContentType.MEMORY: ("remember", "recall", "history", "past", "memory",
                         "learned"),
    ContentType.LANGUAGE: ("language", "grammar", "syntax", "semantic",
                           "linguistic", "word"),
    ContentType.EMOTION: ("emotion", "feel", "happy", "sad", "angry",
                          "afraid"),
    ContentType.CREATIVE: ("create", "art", "design", "imagine", "creative",
                           "novel"),
    ContentType.ANALYTICAL: ("calculate", "compute", "solve", "mathematical",
                             "statistical"),
    ContentType.PATTERN: ("pattern", "visual", "image", "recognize",
                          "classify"),
    ContentType.TEMPORAL: ("time", "sequence", "order", "temporal",
                           "timeline"),
}


class ContentRouter:
    """Keyword-driven routing of text to brain zones."""

    def __init__(self):
        self.content_to_zones = dict(_CONTENT_TO_ZONES)
        self.keyword_mapping = {
            kw: ct for ct, kws in _KEYWORDS.items() for kw in kws}
        self.external_lexicon: Dict[str, str] = {}  # word → zone

    def analyze_content(self, text: str) -> Dict[ContentType, float]:
        if not text:
            return {ContentType.REASONING: 1.0}
        counts: Dict[ContentType, float] = {}
        for word in text.lower().split():
            w = word.strip(".,!?;:\"'()[]")
            ct = self.keyword_mapping.get(w)
            if ct is not None:
                counts[ct] = counts.get(ct, 0.0) + 1.0
        if not counts:
            return {ContentType.REASONING: 1.0}
        total = sum(counts.values())
        return {ct: c / total for ct, c in counts.items()}

    def route_text_to_zones(self, text: str) -> List[str]:
        zones: List[str] = []
        # external lexicon direct word→zone hits first
        for word in (text or "").lower().split():
            z = self.external_lexicon.get(word.strip(".,!?;:\"'()[]"))
            if z and z not in zones:
                zones.append(z)
        for ct, w in sorted(self.analyze_content(text).items(),
                            key=lambda kv: -kv[1]):
            for z in self.content_to_zones[ct]:
                if z not in zones:
                    zones.append(z)
        return zones

    def load_lexicon_dir(self, path: str) -> int:
        """Load word→zone hints from *.txt/*.jsonl/*.csv files; filenames
        carry the zone hint (e.g. 'language_words.txt' → temporal_cortex via
        the LANGUAGE content type). Returns entries loaded."""
        n = 0
        if not os.path.isdir(path):
            return 0
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            stem = os.path.splitext(name)[0].lower()
            zone = None
            for ct in ContentType:
                if ct.value in stem:
                    zone = self.content_to_zones[ct][0]
                    break
            if zone is None:
                continue
            try:
                words: List[str] = []
                if name.endswith(".txt"):
                    with open(full, encoding="utf-8", errors="ignore") as f:
                        words = f.read().split()
                elif name.endswith(".jsonl"):
                    with open(full, encoding="utf-8", errors="ignore") as f:
                        for line in f:
                            try:
                                row = json.loads(line)
                                if isinstance(row, dict):
                                    words.extend(str(v).split()
                                                 for v in row.values()
                                                 if isinstance(v, str))
                            except json.JSONDecodeError:
                                continue
                    words = [w for sub in words for w in
                             (sub if isinstance(sub, list) else [sub])]
                elif name.endswith(".csv"):
                    with open(full, encoding="utf-8", errors="ignore",
                              newline="") as f:
                        for row in csv.reader(f):
                            words.extend(w for cell in row
                                         for w in cell.split())
                for w in words:
                    self.external_lexicon[w.lower()] = zone
                    n += 1
            except OSError as e:
                logger.warning("lexicon file %s failed: %s", full, e)
        return n


class NeuromorphicProcessor:
    """Routes inputs through registered zone forward functions."""

    def __init__(self, d_model: int = 64,
                 event_bus: Optional[EventBus] = None,
                 router_mode: str = "keyword",
                 stats_collector=None, device="cuda"):
        self.d_model = d_model
        self.device = resolve_device(device)
        self.content_router = ContentRouter()
        self.event_bus = event_bus or EventBus()
        self.zone_forwards: Dict[str, Callable] = {}
        self.zone_capabilities: Dict[str, Set[str]] = {}
        self.stats = {"processed": 0, "zone_usage": {}, "errors": 0}
        # live telemetry sink: zone forwards' activity dicts (firing rate,
        # membrane stats) flow into the StatsCollector when attached
        self.stats_collector = stats_collector
        self.set_router_mode(router_mode)
        self._liquid_router = None

    def set_router_mode(self, mode: str) -> None:
        if mode not in ("keyword", "liquid", "topk"):
            raise ValueError(f"unsupported router mode {mode!r}")
        self._router_mode = mode

    def register_zone(self, name: str, forward: Callable,
                      capabilities: Optional[Set[str]] = None) -> None:
        """forward: (input [B, D]) → (output [B, D'], stats dict)."""
        self.zone_forwards[name] = forward
        self.zone_capabilities[name] = capabilities or set()
        self.stats["zone_usage"].setdefault(name, 0)

    # ------------------------------------------------------------------
    def set_liquid_router(self, router) -> None:
        """The `LiquidMoERouter` (in_features d_model, one expert per
        registered zone, in registration order) the liquid modes use."""
        self._liquid_router = router.to(self.device)

    def _liquid_route(self, embedding: np.ndarray,
                      top_k: int) -> Tuple[List[str], np.ndarray]:
        names = list(self.zone_forwards.keys())
        if self._liquid_router is None:
            from aura_snn_rag_tpu_torch.models.brain.liquid_moe import (
                LiquidMoERouter)
            from aura_snn_rag_tpu_torch.models.layers import initialize
            router = LiquidMoERouter(self.d_model, 64, len(names),
                                     top_k=min(top_k, len(names)),
                                     device="cpu")
            initialize(router, torch.Generator().manual_seed(0))
            self.set_liquid_router(router)
        with torch.no_grad():
            routing = self._liquid_router(torch.as_tensor(
                np.asarray(embedding, np.float32),
                device=self.device)[None, :])
        idx = routing["indices"][0].cpu().numpy()
        weights = routing["weights"][0].cpu().numpy().astype(np.float64)
        return [names[int(i)] for i in idx], weights

    def build_plan(self, text: str = "",
                   intents: Optional[List[str]] = None,
                   top_k: int = 3,
                   embedding: Optional[np.ndarray] = None
                   ) -> List[Tuple[str, float]]:
        """Ordered (zone, weight) execution plan."""
        if self._router_mode in ("liquid", "topk") and self.zone_forwards:
            emb = (embedding if embedding is not None
                   else np.zeros(self.d_model, np.float32))
            active, base = self._liquid_route(emb, top_k)
        else:
            routed = self.content_router.route_text_to_zones(text)
            active = [z for z in routed if z in self.zone_forwards] or \
                list(self.zone_forwards.keys())
            base = np.ones(len(active), np.float64)

        if not active:
            return []
        if intents:
            intent_set = set(intents)
            for i, z in enumerate(active):
                matches = len(intent_set & self.zone_capabilities.get(z, set()))
                if matches:
                    base[i] *= 1.0 + 0.75 * matches
        weights = softmax_np(base)
        items = list(zip(active, weights))
        # prefrontal first, cerebellum last
        items.sort(key=lambda p: (p[0] == "cerebellum",
                                  p[0] != "prefrontal_cortex"))
        return items[:top_k] if top_k else items

    def run_plan(self, x, text: str = "",
                 intents: Optional[List[str]] = None,
                 embedding: Optional[np.ndarray] = None,
                 top_k: int = 3):
        """Execute the plan; weighted-sum combine. A zone that fails is
        counted and skipped."""
        plan = self.build_plan(text, intents, top_k, embedding)
        combined = None
        info = {"plan": plan, "zone_stats": {}}
        for zone, weight in plan:
            try:
                out, zstats = self.zone_forwards[zone](x)
                self.stats["zone_usage"][zone] += 1
                info["zone_stats"][zone] = zstats
                if self.stats_collector is not None and \
                        isinstance(zstats, dict):
                    self.stats_collector.update_zone_activity(zone, zstats)
                contrib = out * float(weight)
                combined = contrib if combined is None else combined + contrib
                self.event_bus.emit("neuron_fired", source=zone,
                                    zone=zone, weight=float(weight))
            except Exception as e:  # noqa: BLE001
                logger.warning("zone %s failed: %s", zone, e)
                self.stats["errors"] += 1
        self.stats["processed"] += 1
        if combined is None:
            combined = torch.zeros_like(x)
        return combined, info

    process = run_plan

    def get_stats(self) -> Dict[str, Any]:
        return dict(self.stats)

    def get_recommendations(self) -> List[str]:
        recs = []
        usage = self.stats["zone_usage"]
        if usage:
            total = sum(usage.values()) or 1
            for z, c in usage.items():
                if c / total > 0.8:
                    recs.append(f"zone '{z}' handles {100*c/total:.0f}% of "
                                "traffic — consider splitting capabilities")
                if c == 0:
                    recs.append(f"zone '{z}' unused — check routing keywords")
        if self.stats["errors"] > 0:
            recs.append(f"{self.stats['errors']} zone failures — inspect logs")
        return recs


class NeuralPlasticityEngine:
    """Event-driven homeostasis: nudge per-zone bias currents toward a
    target firing rate."""

    def __init__(self, target_rate: float = 0.1, nudge: float = 0.01,
                 event_bus: Optional[EventBus] = None):
        self.target_rate = target_rate
        self.nudge = nudge
        self.homeo_i: Dict[str, np.ndarray] = {}
        if event_bus is not None:
            event_bus.subscribe("brain_stats_updated", self._on_stats)

    def register_zone(self, name: str, n_neurons: int) -> None:
        self.homeo_i[name] = np.zeros(n_neurons, np.float32)

    def update(self, zone: str, firing_rate: float) -> np.ndarray:
        """Adjust bias current opposite the rate error; returns new bias."""
        if zone not in self.homeo_i:
            self.register_zone(zone, 1)
        err = self.target_rate - float(firing_rate)
        self.homeo_i[zone] = np.clip(
            self.homeo_i[zone] + self.nudge * err, -1.0, 1.0)
        return self.homeo_i[zone]

    def _on_stats(self, event: Event) -> None:
        for zone, rate in event.data.get("firing_rates", {}).items():
            self.update(zone, rate)
