"""Composite LM loss (counterpart of `aura_snn_rag_tpu/training/losses.py`).

1. cross-entropy with label smoothing (next-token prediction), over the
   positions whose label is not `ignore_index`;
2. the mean entropy of the predicted distribution, SUBTRACTED, so
   training raises it (against repetition loops);
3. an L2 penalty pulling the mean place-cell activity to the target
   sparsity.

With a `group` (a 'seq' axis's, where each rank holds one chunk of the
sequence), the value is this rank's share of the loss over the whole
sequence: the means divide by the token count summed over the group,
the sparsity term takes the group's mean activity (`all_reduce_sum`)
and a 1/n share of the penalty, so the ranks' shares add up to the
unsharded loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from aura_snn_rag_tpu_torch.parallel.collectives import all_reduce_sum


def hippocampal_loss(logits: torch.Tensor, labels: torch.Tensor,
                     place_activity: Optional[torch.Tensor] = None,
                     label_smoothing: float = 0.1,
                     entropy_lambda: float = 0.05,
                     sparsity_lambda: float = 0.02,
                     target_sparsity: float = 0.03,
                     ignore_index: int = -100, group=None) -> torch.Tensor:
    """logits [B, L, V], labels [B, L] -> scalar f32 loss (this rank's
    share of it with a `group`)."""
    logits = logits.float()
    ignored = labels == ignore_index
    mask = (~ignored).float()
    safe_labels = torch.where(ignored, 0, labels).long()

    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, safe_labels[..., None])[..., 0]
    if label_smoothing > 0:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if group is None:
        denom = mask.sum().clamp(min=1.0)
    else:
        denom = mask.sum()
        dist.all_reduce(denom, group=group)
        denom = denom.clamp(min=1.0)
    loss = (nll * mask).sum() / denom

    if entropy_lambda > 0:
        probs = torch.exp(log_probs)
        entropy = -(probs * log_probs).sum(dim=-1)
        entropy = (entropy * mask).sum() / denom
        loss = loss - entropy_lambda * entropy

    if place_activity is not None and sparsity_lambda > 0:
        current = place_activity.mean()
        if group is None:
            loss = loss + sparsity_lambda * (current - target_sparsity) ** 2
        else:
            n = dist.get_world_size(group)
            current = all_reduce_sum(current, group) / n
            loss = loss + sparsity_lambda * (
                current - target_sparsity) ** 2 / n

    return loss


def perplexity(loss_ce: torch.Tensor) -> torch.Tensor:
    return torch.exp(loss_ce)
