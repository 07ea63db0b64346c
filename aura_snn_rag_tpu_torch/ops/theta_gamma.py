"""Theta-gamma phase-coupled positional encoding.

Counterpart of `aura_snn_rag_tpu/ops/theta_gamma.py`: positions
normalised to [0, 2*pi] by a fixed `max_seq_len`, a theta sine carrier
plus a gamma sine whose amplitude rides the theta phase
((cos theta + 1) / 2), learnable per-dim phase offsets and amplitude.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class ThetaGammaParams(NamedTuple):
    theta_offsets: torch.Tensor   # [D]
    gamma_offsets: torch.Tensor   # [D]
    amplitude: torch.Tensor       # [D]


def init_theta_gamma(generator: Optional[torch.Generator],
                     embedding_dim: int, dtype: torch.dtype = torch.float32,
                     device=None) -> ThetaGammaParams:
    """Offsets ~ normal(0.1), amplitude 1, drawn from `generator` (on
    `device`)."""
    def offsets():
        return (torch.randn(embedding_dim, generator=generator,
                            device=device) * 0.1).to(dtype)
    return ThetaGammaParams(
        theta_offsets=offsets(), gamma_offsets=offsets(),
        amplitude=torch.ones(embedding_dim, dtype=dtype, device=device))


def theta_gamma_encoding(params: ThetaGammaParams, positions: torch.Tensor,
                         max_seq_len: int, theta_freq: float = 8.0,
                         gamma_freq: float = 40.0) -> torch.Tensor:
    """The encoding of integer `positions` [...] -> [..., D]. Positions
    take the parameters' dtype first, as in the JAX package; the
    normalisation denominator is max(max_seq_len - 1, 1)."""
    denom = float(max(max_seq_len - 1, 1))
    norm_pos = (positions.to(params.amplitude.dtype) / denom) \
        * (2.0 * math.pi)
    norm_pos = norm_pos[..., None]                               # [..., 1]

    theta_phases = norm_pos + params.theta_offsets
    theta_enc = torch.sin(theta_phases)

    freq_ratio = gamma_freq / theta_freq
    gamma_phases = norm_pos * freq_ratio + params.gamma_offsets

    gamma_amplitude = (torch.cos(theta_phases) + 1.0) * 0.5
    gamma_enc = gamma_amplitude * torch.sin(gamma_phases)

    return (theta_enc + 0.5 * gamma_enc) * params.amplitude
