"""Dual-layer semantic + phonetic SRFFN, an addition-only dual-stream
encoder (counterpart of `aura_snn_rag_tpu/encoders/dual_layer_srffn.py`):
a semantic stream (event patterns) and a phonetic stream (formant spike
patterns), each gated by `ops.maths.additive_receptance`, fused by a
sigmoid weight and mixed additively with the previous call's state,
which stays on the device and carries across calls; plus voice
parameters from event and vowel statistics (host floats).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.encoders.event_encoder import (
    FastEventPatternEncoder)
from aura_snn_rag_tpu_torch.encoders.frequency_encoder import (
    FrequencyEncoderParams, FrequencyPatternEncoder)
from aura_snn_rag_tpu_torch.ops.maths import additive_receptance


class SRFFNParams(NamedTuple):
    semantic_patterns: torch.Tensor      # [d_ff, d_model]
    semantic_threshold: torch.Tensor     # [d_ff]
    phonetic_patterns: torch.Tensor      # [d_ff, d_model]
    phonetic_threshold: torch.Tensor     # [d_ff]
    fusion_weight: torch.Tensor          # scalar semantic <-> phonetic
    freq_params: FrequencyEncoderParams


class DualLayerSRFFN:
    """Semantic and phonetic addition-only streams with cross-modal
    fusion. The patterns are drawn with `np.random.RandomState(seed)`, as
    in the JAX package, and held on `device`."""

    def __init__(self, module_id: str = "srffn", d_model: int = 64,
                 d_ff: int = 128, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.module_id = module_id
        self.d_model = d_model
        self.d_ff = d_ff
        self.event_encoder = FastEventPatternEncoder(d_model, seed=seed)
        self.freq_encoder = FrequencyPatternEncoder(d_model,
                                                    device=self.device)
        rng = np.random.RandomState(seed)
        dev = self.device

        def patterns():
            return torch.from_numpy(rng.uniform(
                -0.1, 0.1, (d_ff, d_model)).astype(np.float32)).to(dev)
        self.params = SRFFNParams(
            semantic_patterns=patterns(),
            semantic_threshold=torch.zeros(d_ff, device=dev),
            phonetic_patterns=patterns(),
            phonetic_threshold=torch.zeros(d_ff, device=dev),
            fusion_weight=torch.full((), 0.5, device=dev),
            freq_params=self.freq_encoder.init_params())
        self._prev_state = torch.zeros(d_ff, device=dev)

    def temporal_mixing_additive(self, current: torch.Tensor,
                                 mix: float = 0.3) -> torch.Tensor:
        """Additive temporal mixing with the previous activation state."""
        mixed = (1 - mix) * current + mix * self._prev_state
        self._prev_state = mixed
        return mixed

    def cross_modal_fusion(self, semantic: torch.Tensor,
                           phonetic: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.params.fusion_weight)
        return w * semantic + (1 - w) * phonetic

    def extract_voice_characteristics(self, text: str,
                                      phonemes: Optional[List[str]] = None
                                      ) -> Dict[str, float]:
        """Voice-synthesis parameters from event and formant statistics."""
        analysis = self.event_encoder.get_event_analysis(text)
        emotion = analysis.get("emotion", 0.0)
        energy = analysis.get("motion", 0.0) + analysis.get("creation", 0.0)
        n_vowels = sum(1 for p in (phonemes or [])
                       if p in "iɪeɛæɑɔoʊuə")
        return {
            "pitch_base": 120.0 + 60.0 * emotion,
            "speech_rate": 1.0 + 0.5 * energy,
            "vowel_ratio": n_vowels / max(1, len(phonemes or [])),
            "intensity": min(1.0, 0.5 + emotion + 0.2 * energy),
        }

    def forward(self, text: str,
                phonemes: Optional[List[str]] = None) -> Dict[str, Any]:
        """Dual-stream encoding of a text (and a phoneme sequence)."""
        semantic_in = torch.from_numpy(
            self.event_encoder.encode(text)).to(self.device)
        if phonemes:
            ph = self.freq_encoder.encode(self.params.freq_params, phonemes)
            phonetic_in = ph.mean(dim=0)
        else:
            phonetic_in = torch.zeros(self.d_model, device=self.device)

        semantic = additive_receptance(
            semantic_in[None, :], self.params.semantic_patterns,
            self.params.semantic_threshold)[0]
        phonetic = additive_receptance(
            phonetic_in[None, :], self.params.phonetic_patterns,
            self.params.phonetic_threshold)[0]

        fused = self.cross_modal_fusion(semantic, phonetic)
        mixed = self.temporal_mixing_additive(fused)
        return {
            "features": mixed,
            "semantic": semantic,
            "phonetic": phonetic,
            "voice": self.extract_voice_characteristics(text, phonemes),
        }

    def read_with_voice(self, text: str,
                        phonemes: Optional[List[str]] = None
                        ) -> Dict[str, Any]:
        out = self.forward(text, phonemes)
        return {"voice_params": out["voice"],
                "features": out["features"],
                "text": text}

    def get_network_topology(self) -> Dict[str, Any]:
        return {
            "module_id": self.module_id,
            "d_model": self.d_model,
            "d_ff": self.d_ff,
            "streams": ["semantic", "phonetic"],
            "n_phonemes": len(self.freq_encoder.phonemes),
            "n_events": len(self.event_encoder.event_names),
        }
