"""Sparse place-cell population coding.

Counterpart of `aura_snn_rag_tpu/ops/place_cells.py`: the top ~3% of
place-cell logits fire with sigmoid activation, the rest are zero. The
k-th largest logit per position is a threshold, so ties at the threshold
all fire, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sparse_place_code(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Sparsify [..., N] place-cell logits to exactly-k (modulo ties)
    winners; activity in [0, 1]: sigmoid on winners, zero elsewhere."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    mask = (logits >= kth).to(logits.dtype)
    return torch.sigmoid(logits) * mask


def place_cell_encode(token_embeds: torch.Tensor,
                      w_proj: torch.Tensor, b_proj: torch.Tensor,
                      w_back: torch.Tensor, b_back: torch.Tensor,
                      k: int, residual_scale: float = 0.1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full place-cell encoding path: embed -> project to place space ->
    sparse top-k sigmoid -> reconstruct -> `token_embeds + residual_scale *
    reconstructed`. Weights are [in, out], as in the JAX package.

    Returns (semantic_embedding [..., D], place_activity [..., N])."""
    place_logits = token_embeds @ w_proj + b_proj
    activity = sparse_place_code(place_logits, k)
    reconstructed = activity @ w_back + b_back
    return token_embeds + residual_scale * reconstructed, activity
