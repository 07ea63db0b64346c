"""Event-driven and multi-modal processing adapters (counterpart of
`aura_snn_rag_tpu/zones/multimodal.py`): `EventDrivenProcessor` keeps a
per-zone boost that bus events raise (a zone fired) and decay (content
processed); `MultiModalProcessor` turns text, images and audio into
[1, d_model] features on the processor's device and routes them through
the shared zones."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from aura_snn_rag_tpu_torch.zones.events import Event, EventBus
from aura_snn_rag_tpu_torch.zones.processor import NeuromorphicProcessor


class EventDrivenProcessor:
    """Wraps a NeuromorphicProcessor; bus events adjust zone weighting."""

    def __init__(self, processor: NeuromorphicProcessor,
                 event_bus: Optional[EventBus] = None):
        self.processor = processor
        self.event_bus = event_bus or processor.event_bus
        self.zone_boost: Dict[str, float] = {}
        self.event_bus.subscribe("neuron_fired", self._on_fire)
        self.event_bus.subscribe("content_processed", self._on_content)

    def _on_fire(self, event: Event) -> None:
        zone = event.data.get("zone")
        if zone:
            # recently active zones get a mild recency boost, decaying
            self.zone_boost[zone] = min(
                1.5, self.zone_boost.get(zone, 1.0) * 1.05)

    def _on_content(self, event: Event) -> None:
        for z in list(self.zone_boost):
            self.zone_boost[z] = max(1.0, self.zone_boost[z] * 0.98)

    def process(self, x, text: str = "", **kw):
        out, info = self.processor.run_plan(x, text, **kw)
        info["zone_boost"] = dict(self.zone_boost)
        return out, info


class MultiModalProcessor:
    """Text/image/audio preprocessors -> the shared zone processor."""

    def __init__(self, processor: NeuromorphicProcessor,
                 d_model: Optional[int] = None,
                 text_encoder: Optional[Callable[[str], np.ndarray]] = None):
        self.processor = processor
        self.d_model = d_model or processor.d_model
        if text_encoder is None:
            from aura_snn_rag_tpu_torch.encoders.hash_embedder import (
                FastHashEmbedder)
            text_encoder = FastHashEmbedder(dim=self.d_model).embed
        self.text_encoder = text_encoder

    def _fold(self, arr: np.ndarray) -> np.ndarray:
        """Fold any flat signal into [d_model] by strided averaging."""
        flat = np.asarray(arr, np.float32).ravel()
        if flat.size == 0:
            return np.zeros(self.d_model, np.float32)
        pad = (-flat.size) % self.d_model
        folded = np.pad(flat, (0, pad)).reshape(-1, self.d_model).mean(0)
        n = np.linalg.norm(folded)
        return folded / n if n > 0 else folded

    def _run(self, feats: np.ndarray, text: str, **kw):
        x = torch.as_tensor(np.asarray(feats, np.float32),
                            device=self.processor.device)[None, :]
        return self.processor.run_plan(x, text=text, **kw)

    def process_text(self, text: str, **kw):
        return self._run(self.text_encoder(text)[:self.d_model], text, **kw)

    def process_image(self, image: np.ndarray, **kw):
        """image [H, W] or [H, W, C] -> occipital-routed features."""
        return self._run(self._fold(image), "visual pattern image", **kw)

    def process_audio(self, waveform: np.ndarray, **kw):
        """waveform [T] -> temporal-cortex-routed spectral features."""
        spec = np.abs(np.fft.rfft(np.asarray(waveform, np.float32)))
        return self._run(self._fold(np.log1p(spec)),
                         "audio temporal sequence", **kw)
