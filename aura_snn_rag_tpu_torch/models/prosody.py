"""Prosody-driven spiking attention chain (counterpart of
`aura_snn_rag_tpu/models/prosody.py`).

- `prosody_channels_from_tokens`: deterministic (amp, pitch, boundary)
  channels from token ids (sin/cos hashes);
  `prosody_channels_from_strings`: the same from token strings, on the
  host (numpy, a copy of the JAX package's);
- `multi_channel_spiking_attention`: three binary LIF chains with reset,
  run as one loop over the stacked [3, B, T] drive with per-channel
  decays, a weighted salience sum, optional smoothing (a box filter of
  width m, padded m // 2 before and (m - 1) // 2 after as
  `jnp.convolve(mode="same")` pads, which `conv1d(padding="same")` does
  not for even m, and summed in XLA's order, so tied saliences stay
  tied), max-normalisation, and the top-k winners taken by a
  stable descending sort, so tied saliences keep the lowest index first
  as `lax.top_k` does (`torch.topk` does not) -> a per-row gain
  `min + range * tanh(gain_up * mean(winners))`;
- `prosody_attention_gains`: per-token gains mu * (1 + salience);
- `CachedProsodyBridge`: an md5-keyed LRU of the gains (kept on the
  device); ids on the card cost one device-to-host copy per call, for the
  key, counted in `host_copies`;
- `prosody_gif_scan`: GIF over [B, T, D] with the gain modulating the
  input, the threshold (x clamp(1 - 0.3 (g - 1), 0.5, 1.5)) and the
  adaptation rate; a Python loop over T in the JAX step's order of
  operations, the gain-only factors computed for all T at once;
- `emotion_modulated_prosody`: emotion posteriors on the circumplex
  (arousal, valence) scale the gains and give the [B, T, 4] prosody
  tensor.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.ops.neurons import GIFParams
from aura_snn_rag_tpu_torch.ops.surrogate import multi_bit_spike


class ProsodyAttentionConfig(NamedTuple):
    k_winners: int = 5
    decay: Tuple[float, float, float] = (0.7, 0.7, 0.7)
    weights: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    gain_up: float = 1.8
    min_gain: float = 0.5
    max_gain: float = 2.5
    smoothing: int = 0
    normalize_salience: bool = True


ANALYTICAL_BALANCED = ProsodyAttentionConfig(
    k_winners=7, decay=(0.75, 0.7, 0.65), weights=(1.0, 0.8, 1.2),
    gain_up=1.5, min_gain=0.6, max_gain=2.0, smoothing=3)

EMOTIONAL_BOOSTED = ProsodyAttentionConfig(
    k_winners=5, weights=(1.2, 1.5, 0.6), gain_up=2.0, smoothing=0)

SWEEP_CONFIGS: Dict[str, ProsodyAttentionConfig] = {
    "baseline": ProsodyAttentionConfig(k_winners=5),
    "less_smoothing": ProsodyAttentionConfig(
        k_winners=5, smoothing=0, normalize_salience=False),
    "amplified_channels": ProsodyAttentionConfig(
        k_winners=5, weights=(1.5, 1.5, 1.5)),
    "k3_conservative": ProsodyAttentionConfig(
        k_winners=3, weights=(1.2, 1.2, 1.2), smoothing=1),
    "k7_aggressive": ProsodyAttentionConfig(
        k_winners=7, weights=(0.8, 0.8, 0.8), smoothing=0,
        normalize_salience=False),
    "emotional_boosted": EMOTIONAL_BOOSTED,
    "analytical_balanced": ProsodyAttentionConfig(
        k_winners=5, weights=(0.8, 1.2, 1.0), smoothing=2, gain_up=1.5),
}


def prosody_channels_from_tokens(token_ids: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Deterministic (amp, pitch, boundary) channels from token ids."""
    t = token_ids.to(torch.float32)
    amp = torch.abs(torch.sin(t * 0.1))
    pitch = torch.abs(torch.cos(t * 0.05))
    boundary = (torch.sin(t * 0.3) > 0.8).to(torch.float32)
    return amp, pitch, boundary


def prosody_channels_from_strings(tokens) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Text-derived (amp, pitch, boundary) channels from token strings, on
    the host: emphasis (capitals, exclamation) drives the amplitude, word
    length the pitch, sentence punctuation marks boundaries. Returns
    [1, T] float32 arrays."""
    amp, pitch, boundary = [], [], []
    for w in tokens:
        letters = [c for c in w if c.isalpha()]
        caps = (sum(c.isupper() for c in letters) / len(letters)
                if letters else 0.0)
        excl = min(w.count("!") + w.count("?"), 3) / 3.0
        amp.append(0.2 + 0.6 * caps + 0.4 * excl)
        pitch.append(0.3 + 0.7 * min(len(w) / 10.0, 1.0))
        boundary.append(1.0 if (w and w[-1] in ".,;:!?") else 0.0)
    mk = lambda v: np.asarray(v, np.float32)[None, :]
    return mk(amp), mk(pitch), mk(boundary)


def _table(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small f32 table on `device`, made by fills (no copy from the
    host, so no sync)."""
    return torch.stack([torch.full((), v, dtype=torch.float32,
                                   device=device) for v in values])


def _lif_chains(x: torch.Tensor, decay: torch.Tensor,
                theta: float = 1.0) -> torch.Tensor:
    """Binary LIF with reset over a [C, B, T] drive, channel c decaying by
    decay[c] ([C, 1]). Returns spikes [C, B, T]."""
    v = torch.zeros_like(x[..., 0])
    spikes = []
    for t in range(x.shape[-1]):
        v = decay * v + x[..., t]
        s = (v >= theta).to(x.dtype)
        v = v - s * theta
        spikes.append(s)
    return torch.stack(spikes, dim=-1)


def _box_filter(s: torch.Tensor, m: int) -> torch.Tensor:
    """`jnp.convolve(row, ones(m) / m, mode="same")` along the rows of
    [B, T]: padded m // 2 before and (m - 1) // 2 after, each tap's product
    with 1/m summed in pairs, then pairs of pairs (XLA:CPU's order: bit
    for bit the same for m <= 6)."""
    T = s.shape[1]
    pad = F.pad(s, (m // 2, (m - 1) // 2))
    k = torch.full((), 1.0 / m, dtype=s.dtype, device=s.device)
    terms = [pad[:, i:i + T] * k for i in range(m)]
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]


def multi_channel_spiking_attention(
        amp: torch.Tensor, pitch: torch.Tensor, boundary: torch.Tensor,
        cfg: ProsodyAttentionConfig = ProsodyAttentionConfig()
) -> Dict[str, torch.Tensor]:
    """(amp, pitch, boundary) [B, T] -> {'mu_scalar', 'salience',
    'winners'}."""
    x = torch.stack([amp, pitch, boundary])
    sp = _lif_chains(x, _table(cfg.decay, x.device)[:, None])
    s = (cfg.weights[0] * sp[0] + cfg.weights[1] * sp[1]
         + cfg.weights[2] * sp[2])

    if cfg.smoothing > 1:
        s = _box_filter(s, cfg.smoothing)

    if cfg.normalize_salience:
        s = s / (s.max(dim=1, keepdim=True).values + 1e-6)

    k_win = min(cfg.k_winners, s.shape[1])
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    topk_vals, topk_idx = vals[:, :k_win], idx[:, :k_win]
    avg_winner = topk_vals.mean(dim=1)
    mu = cfg.min_gain + (cfg.max_gain - cfg.min_gain) * torch.tanh(
        cfg.gain_up * avg_winner)
    return {"mu_scalar": mu, "salience": s, "winners": topk_idx}


def prosody_attention_gains(token_ids: torch.Tensor,
                            cfg: ProsodyAttentionConfig =
                            ProsodyAttentionConfig()
                            ) -> Tuple[torch.Tensor,
                                       Dict[str, torch.Tensor]]:
    """[B, T] ids -> per-token gains mu * (1 + salience) [B, T], and the
    details."""
    amp, pitch, boundary = prosody_channels_from_tokens(token_ids)
    result = multi_channel_spiking_attention(amp, pitch, boundary, cfg)
    gains = result["mu_scalar"][:, None] * (1.0 + result["salience"])
    return gains, result


class CachedProsodyBridge:
    """Content-keyed LRU cache of the prosody gains, computed and kept on
    `device`."""

    def __init__(self, cfg: ProsodyAttentionConfig = ANALYTICAL_BALANCED,
                 cache_size: int = 256, device="cuda"):
        self.cfg = cfg
        self.cache_size = cache_size
        self.device = resolve_device(device)
        self._cache: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.host_copies = 0         # device-to-host copies of ids (keys)

    def __call__(self, token_ids) -> torch.Tensor:
        if torch.is_tensor(token_ids):
            if token_ids.device.type != "cpu":
                self.host_copies += 1
            ids = token_ids.cpu().numpy()
        else:
            ids = np.asarray(token_ids)
        key = hashlib.md5(ids.tobytes()).hexdigest()
        if key in self._cache:
            self.hits += 1
            self._cache.move_to_end(key)
            return self._cache[key]
        self.misses += 1
        dev_ids = (token_ids.to(self.device) if torch.is_tensor(token_ids)
                   else torch.as_tensor(ids).to(self.device))
        gains, _ = prosody_attention_gains(dev_ids, self.cfg)
        self._cache[key] = gains
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return gains

    @property
    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}


def prosody_gif_scan(params: GIFParams, currents: torch.Tensor,
                     attention_gains: Optional[torch.Tensor] = None,
                     modulation_strength: float = 0.3,
                     state: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """GIF dynamics over [B, T, D] with per-step prosody modulation: the
    gain g_t scales the input, the effective threshold
    (theta * clamp(1 - 0.3 (g - 1), 0.5, 1.5)) and the adaptation rate
    (alpha * g). Returns (spikes [B, T, D], (v, theta))."""
    p = params
    B, T, D = currents.shape
    if attention_gains is None:
        attention_gains = torch.ones(B, T, dtype=currents.dtype,
                                     device=currents.device)
    if state is None:
        v = torch.zeros(B, D, dtype=currents.dtype, device=currents.device)
        theta = torch.full((B, D), float(p.threshold), dtype=currents.dtype,
                           device=currents.device)
    else:
        v, theta = state
    # the factors that depend on the gain alone, for every step at once
    g = attention_gains[..., None]                          # [B, T, 1]
    drive = currents * g
    thr_scale = torch.clamp(1.0 - modulation_strength * (g - 1.0), 0.5, 1.5)
    alpha_eff = p.alpha * g
    spikes = []
    for t in range(T):
        v = v * p.decay + drive[:, t]
        theta_eff = theta * thr_scale[:, t]
        clamp = p.levels * theta_eff * 2.0
        v = torch.clamp(v, -clamp, clamp)
        spk = multi_bit_spike(v / (theta_eff + 1e-6), p.levels)
        v = v - spk * theta_eff
        a = alpha_eff[:, t]
        theta = theta + a * spk - a * (theta - p.threshold)
        spikes.append(spk)
    return torch.stack(spikes, dim=1), (v, theta)


# circumplex coordinates of the 8 emotion classes (joy, sad, anger, fear,
# surprise, disgust, trust, neutral), and the tone classes' (formal,
# casual, urgent, calm) gain multipliers
EMOTION_AROUSAL = (0.7, 0.3, 0.9, 0.8, 0.9, 0.6, 0.4, 0.2)
EMOTION_VALENCE = (0.8, -0.7, -0.8, -0.6, 0.3, -0.7, 0.6, 0.0)
TONE_GAIN = (1.0, 1.0, 1.3, 0.8)


def _head_logits(head, head_params, pooled):
    """A port `EmotionPersonalityHead` (called) or any object with the JAX
    `head.apply(params, x)` call shape."""
    if isinstance(head, torch.nn.Module):
        return head(pooled)
    return head.apply(head_params, pooled)


def emotion_modulated_prosody(token_ids: torch.Tensor,
                              features: torch.Tensor, head,
                              head_params=None,
                              cfg: ProsodyAttentionConfig =
                              ANALYTICAL_BALANCED
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """token_ids [B, T], features [B, T, D] ->
      gains   [B, T]    spiking-attention gains scaled by arousal and tone,
      prosody [B, T, 4] (arousal, valence, arousal, valence) per sample,
      info              salience and winners, and the emotion posteriors.
    """
    pooled = features.mean(dim=1)
    logits = _head_logits(head, head_params, pooled)
    dev = features.device
    p_emo = torch.softmax(logits["emotion"], dim=-1)             # [B, 8]
    p_tone = torch.softmax(logits["tone"], dim=-1)               # [B, 4]
    arousal = p_emo @ _table(EMOTION_AROUSAL, dev)                     # [B]
    valence = p_emo @ _table(EMOTION_VALENCE, dev)
    tone_gain = p_tone @ _table(TONE_GAIN, dev)

    gains, info = prosody_attention_gains(token_ids, cfg)
    gains = gains * (1.0 + 0.3 * torch.tanh(arousal))[:, None]
    gains = torch.clamp(gains * tone_gain[:, None], cfg.min_gain,
                        cfg.max_gain * 1.5)

    B, T = token_ids.shape
    pros = torch.stack([arousal, valence, arousal, valence], dim=-1)
    prosody = pros[:, None, :].expand(B, T, 4)
    info = dict(info, emotion_probs=p_emo, arousal=arousal,
                valence=valence, tone_gain=tone_gain)
    return gains, prosody, info
