"""Composite LM loss (counterpart of `aura_snn_rag_tpu/training/losses.py`).

1. cross-entropy with label smoothing (next-token prediction), over the
   positions whose label is not `ignore_index`;
2. the mean entropy of the predicted distribution, SUBTRACTED, so
   training raises it (against repetition loops);
3. an L2 penalty pulling the mean place-cell activity to the target
   sparsity.
"""

from __future__ import annotations

from typing import Optional

import torch


def hippocampal_loss(logits: torch.Tensor, labels: torch.Tensor,
                     place_activity: Optional[torch.Tensor] = None,
                     label_smoothing: float = 0.1,
                     entropy_lambda: float = 0.05,
                     sparsity_lambda: float = 0.02,
                     target_sparsity: float = 0.03,
                     ignore_index: int = -100) -> torch.Tensor:
    """logits [B, L, V], labels [B, L] -> scalar f32 loss."""
    logits = logits.float()
    ignored = labels == ignore_index
    mask = (~ignored).float()
    safe_labels = torch.where(ignored, 0, labels).long()

    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, safe_labels[..., None])[..., 0]
    if label_smoothing > 0:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    denom = mask.sum().clamp(min=1.0)
    loss = (nll * mask).sum() / denom

    if entropy_lambda > 0:
        probs = torch.exp(log_probs)
        entropy = -(probs * log_probs).sum(dim=-1)
        entropy = (entropy * mask).sum() / denom
        loss = loss - entropy_lambda * entropy

    if place_activity is not None and sparsity_lambda > 0:
        current = place_activity.mean()
        loss = loss + sparsity_lambda * (current - target_sparsity) ** 2

    return loss


def perplexity(loss_ce: torch.Tensor) -> torch.Tensor:
    return torch.exp(loss_ce)
