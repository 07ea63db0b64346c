"""Dict-based STDP token-salience learner, the host-side variant (a copy
of `aura_snn_rag_tpu/training/stdp_dict.py`, pure Python; the port keeps
its own).

Sparse per-token scalar weights, pre-before-post LTP within a window,
passive decay + pruning, `get_modulations` = 1 + 0.2 w. The vectorised
device version is `training.online`; this one suits small or irregular
token-id sets where a dense [V] buffer is wasteful.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List


class STDPLearnerDict:
    def __init__(self, lr_plus: float = 0.01, time_window: int = 5,
                 decay: float = 0.999, w_min: float = 0.0,
                 w_max: float = 1.0, prune_below: float = 0.01):
        self.lr_plus = lr_plus
        self.time_window = time_window
        self.decay = decay
        self.w_min = w_min
        self.w_max = w_max
        self.prune_below = prune_below
        self.weights: Dict[int, float] = {}
        self.items_seen = 0

    def process_sequence(self, token_ids: Iterable[int]) -> Dict[str, float]:
        toks = list(token_ids)
        # LTP: pre-before-post within the window, exp(-dt) weighting
        for post_t, post in enumerate(toks):
            for dt in range(1, self.time_window + 1):
                pre_t = post_t - dt
                if pre_t < 0:
                    break
                bump = self.lr_plus * math.exp(-dt)
                w = self.weights.get(post, 0.5) + bump
                self.weights[post] = min(self.w_max, w)
        # passive decay + pruning
        for tok in list(self.weights):
            self.weights[tok] = max(self.w_min,
                                    self.weights[tok] * self.decay)
            if self.weights[tok] < self.prune_below:
                del self.weights[tok]
        self.items_seen += 1
        return {
            "n_tracked": len(self.weights),
            "mean_weight": (sum(self.weights.values())
                            / max(1, len(self.weights))),
        }

    def get_modulations(self, token_ids: Iterable[int]) -> List[float]:
        return [1.0 + 0.2 * self.weights.get(t, 0.0) for t in token_ids]
