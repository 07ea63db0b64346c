"""Phoneme -> formant-frequency spike-pattern encoder (counterpart of
`aura_snn_rag_tpu/encoders/frequency_encoder.py`): an IPA phoneme ->
(F1, F2) formant table, a [n_phonemes, 2, samples] sinusoid basis (made
with numpy, held on `device`), learnable amplitude and offset per phoneme
and F1/F2 weights, and thresholded spike patterns folded into d_model
bins. `encode` builds every phoneme's pattern in one pass over the
sequence (the same arithmetic per element as one phoneme at a time).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aura_snn_rag_tpu_torch._device import resolve_device

# IPA phoneme -> (F1, F2) dominant frequencies in Hz
IPA_FORMANTS: Dict[str, Tuple[float, float]] = {
    # vowels
    "i": (270, 2290), "ɪ": (390, 1990), "e": (530, 1840),
    "ɛ": (660, 1720), "æ": (860, 1720), "ɑ": (730, 1090),
    "ɔ": (570, 840), "o": (450, 880), "ʊ": (440, 1020),
    "u": (300, 870), "ə": (500, 1500),
    # consonants (dominant ranges)
    "p": (100, 500), "b": (100, 500), "t": (4000, 8000),
    "d": (4000, 8000), "k": (2000, 4000), "g": (2000, 4000),
    "f": (6000, 12000), "s": (8000, 12000), "ʃ": (3000, 6000),
    "h": (500, 2000), "l": (200, 400), "r": (300, 600),
    "m": (200, 300), "n": (200, 300),
}


class FrequencyEncoderParams(NamedTuple):
    amplitude_scale: torch.Tensor   # [n_phonemes]
    frequency_shift: torch.Tensor   # [n_phonemes]
    f1_weight: torch.Tensor         # scalar
    f2_weight: torch.Tensor         # scalar


class FrequencyPatternEncoder:
    """Precomputed formant spike patterns and learnable adaptation."""

    def __init__(self, d_model: int = 256, sample_rate: int = 1000,
                 duration_ms: int = 100, device="cuda"):
        self.device = resolve_device(device)
        self.d_model = d_model
        self.sample_rate = sample_rate
        self.samples = int(duration_ms * sample_rate / 1000)
        self.phonemes = list(IPA_FORMANTS)
        self.index = {p: i for i, p in enumerate(self.phonemes)}
        t = np.arange(self.samples) / sample_rate
        basis = np.zeros((len(self.phonemes), 2, self.samples), np.float32)
        for i, p in enumerate(self.phonemes):
            f1, f2 = IPA_FORMANTS[p]
            # high formants alias into the sample band
            basis[i, 0] = np.sin(2 * math.pi * (f1 % (sample_rate / 2)) * t)
            basis[i, 1] = np.sin(2 * math.pi * (f2 % (sample_rate / 2)) * t)
        self.basis = torch.from_numpy(basis).to(self.device)

    def init_params(self) -> FrequencyEncoderParams:
        n = len(self.phonemes)
        dev = self.device
        return FrequencyEncoderParams(
            amplitude_scale=torch.ones(n, device=dev),
            frequency_shift=torch.zeros(n, device=dev),
            f1_weight=torch.full((), 1.0, device=dev),
            f2_weight=torch.full((), 0.5, device=dev))

    def _patterns(self, params: FrequencyEncoderParams, idx: torch.Tensor,
                  threshold: float) -> torch.Tensor:
        """Spike patterns [len(idx), samples] of the phonemes `idx`."""
        wave = (params.f1_weight * self.basis[idx, 0]
                + params.f2_weight * self.basis[idx, 1])
        wave = (wave * params.amplitude_scale[idx, None]
                + params.frequency_shift[idx, None])
        return (wave > threshold).to(torch.float32)

    def _indices(self, phonemes: List[str]) -> torch.Tensor:
        fallback = self.index["ə"]
        return torch.tensor([self.index.get(p, fallback) for p in phonemes],
                            dtype=torch.long).to(self.device)

    def phoneme_pattern(self, params: FrequencyEncoderParams, phoneme: str,
                        threshold: float = 0.5) -> torch.Tensor:
        """Spike pattern [samples] of one phoneme."""
        return self._patterns(params, self._indices([phoneme]),
                              threshold)[0]

    def encode(self, params: FrequencyEncoderParams,
               phonemes: List[str]) -> torch.Tensor:
        """Phoneme sequence -> [len, d_model] spike features (each pattern
        folded into d_model bins by averaging, zero-padded)."""
        if not phonemes:
            return torch.zeros(0, self.d_model, device=self.device)
        pat = self._patterns(params, self._indices(phonemes), 0.5)
        fold = max(1, self.samples // self.d_model)
        usable = (self.samples // fold) * fold
        folded = pat[:, :usable].reshape(len(phonemes), -1, fold).mean(-1)
        if folded.shape[1] < self.d_model:
            folded = F.pad(folded, (0, self.d_model - folded.shape[1]))
        return folded[:, :self.d_model]
