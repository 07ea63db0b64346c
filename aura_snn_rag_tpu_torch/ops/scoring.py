"""The memory's exact scoring rule, shared by the engine and the overflow
annex's pass (`cuda/annex.py`), whose CUDA epilogue computes the same
score without locations.

`config` is a `MemoryConfig` and `state` a `MemoryState`; they are not
typed here, since `ops` is imported by the memory package.
"""

from __future__ import annotations

from typing import Optional

import torch


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    return x * torch.rsqrt((x * x).sum(dim, keepdim=True) + eps)


def combined_score(config, state, cos: torch.Tensor,
                   slots: Optional[torch.Tensor],
                   query_loc: Optional[torch.Tensor]) -> torch.Tensor:
    """(w_c*cos + w_s*spatial + w_t*temporal) * strength.

    slots: [B, N] bank indices, or None for every row in bank order (cos
    is then [B, M] and the per-row terms broadcast instead of gathering).
    """
    if slots is None:
        strength, ts = state.strength[None, :], state.timestamp[None, :]
        mem_loc = state.locations[None]                          # [1, M, S]
    else:
        strength, ts = state.strength[slots], state.timestamp[slots]
        mem_loc = state.locations[slots] if query_loc is not None else None
    ages = (state.step - ts) * config.seconds_per_step
    temporal = torch.exp(-torch.clamp(ages, min=0.0) / config.temporal_tau)
    if query_loc is not None:
        d = torch.sqrt(((mem_loc - query_loc[:, None, :]) ** 2).sum(-1)
                       + 1e-12)
        spatial = 1.0 / (1.0 + d)
    else:
        spatial = torch.zeros_like(cos)
    return (config.w_cosine * cos + config.w_spatial * spatial
            + config.w_temporal * temporal) * strength
