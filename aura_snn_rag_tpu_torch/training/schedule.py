"""LR schedule: linear warmup + cosine decay to `min_lr_ratio`
(counterpart of `aura_snn_rag_tpu/training/schedule.py`).

The values are optax's `warmup_cosine_decay_schedule`: warmup clamped
into [1, max_steps - 1], lr 0 at step 0, the cosine over the remaining
`max_steps - warmup` steps down to `lr * min_lr_ratio`, computed in f32
in optax's order of operations. The schedule takes a step count as an
int or as a tensor (the optimizer's count on the device), so reading it
needs no host sync.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch


def warmup_cosine_schedule(lr: float, warmup_steps: int, max_steps: int,
                           min_lr_ratio: float = 0.1
                           ) -> Callable[[Union[int, torch.Tensor]],
                                         torch.Tensor]:
    max_steps = max(2, max_steps)
    warmup = min(max(1, warmup_steps), max_steps - 1)
    decay = float(max_steps - warmup)
    end = lr * min_lr_ratio
    alpha = 0.0 if lr == 0.0 else end / lr

    def schedule(count: Union[int, torch.Tensor]) -> torch.Tensor:
        count = torch.as_tensor(count).float()
        # linear warmup from 0 to lr over `warmup` steps
        frac = 1.0 - count.clamp(0.0, float(warmup)) / warmup
        warm = (0.0 - lr) * frac + lr
        # cosine decay, counted from the end of the warmup
        t = torch.clamp(count - warmup, max=decay)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / decay))
        cos_lr = lr * ((1.0 - alpha) * cosine + alpha)
        return torch.where(count < warmup, warm, cos_lr)

    return schedule
