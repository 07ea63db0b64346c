"""The trainer's step on the Kimi-Linear LM in plain PyTorch: the training
cell's reference (`moonlight_train`'s step over `kimi_linear_plain`).

A frozen statement of a wake step as the configuration states it
(amygdala, thalamus and dropout off, memory on, no EWC): the forward of
`kimi_linear_plain.KimiLinear` injecting at each layer the bank rows the
program retrieved there and routing each token to the experts the
program picked (or, for a control, to its own picks); the loss (label-
smoothed next-token cross-entropy minus the entropy bonus); autograd; the
global-norm clip and AdamW under the warmup-cosine schedule
(`lm_train.learning_rate`); every MoE layer's bias moved by rate *
sign(mean load - load) of the step's picks; on a store step the batch's
memory summaries written over the bank's oldest rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from perfbench.reference import kimi_linear_plain, lm_train

B1, B2, EPS = 0.9, 0.999, 1e-8


def train_steps(P0: Dict[str, torch.Tensor], m: dict, mem: dict, t: dict,
                batches: Sequence[torch.Tensor], rows: torch.Tensor,
                slots: Sequence[List[torch.Tensor]],
                choices: Optional[Sequence[List[torch.Tensor]]],
                linear=kimi_linear_plain.plain_linear,
                blocked: bool = True, kda_control=None) -> dict:
    """Runs the steps of `batches` (ids [N, L] each, labels = ids) from
    weights P0. `slots[s][l]` [N, k] are the rows layer l injected in step
    s; `choices[s][l]` [N, L, k] the experts MoE layer l picked (None for
    a dense layer), or `choices` None for the model's own picks. Returns
    each step's loss, the first step's clipped gradient, the weights after
    the last step, the bank rows each store step wrote, each step's
    widest route gap and the picks it routed by. `kda_control` plants a
    control in every KDA layer (`kimi_linear_plain.KimiLinear`)."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P0.items()}
    nu = {k: torch.zeros_like(v) for k, v in P0.items()}
    E = m["n_routed_experts"]
    first = m["first_k_dense_replace"]
    L_n = m["num_layers"]
    bias = [None if i < first else torch.zeros(E, device=rows.device)
            for i in range(L_n)]
    rows = rows.clone()
    written = rows.shape[0]                      # the bank starts full
    losses, first_grad, writes, gaps, picks = [], None, [], [], []
    for step, ids in enumerate(batches):
        model = kimi_linear_plain.KimiLinear(P, m, mem, linear, blocked,
                                             kda_control=kda_control)
        temporal = math.exp(-step * mem["seconds_per_step"]
                            / mem["temporal_tau"])
        own = choices is None
        ch = [None if i < first else "own" for i in range(L_n)] if own \
            else choices[step]
        loss, grads, summary, gap = kimi_linear_plain.loss_and_grads(
            model, t, ids, ids, rows, slots[step], ch, bias, temporal)
        picked = model.picked if own else ch
        losses.append(loss)
        gaps.append(gap)
        picks.append(picked)
        with torch.no_grad():
            names = list(P)
            norm = torch.sqrt(sum((grads[k].float() ** 2).sum()
                                  for k in names))
            clip = t["gradient_clip"]
            scale = 1.0 if norm < clip else clip / norm
            g = {k: grads[k] * scale for k in names}
            if first_grad is None:
                first_grad = {k: v.clone() for k, v in g.items()}
            c = step + 1
            lr = lm_train.learning_rate(t, step)
            for k in names:
                mu[k] = (1 - B1) * g[k] + B1 * mu[k]
                nu[k] = (1 - B2) * g[k] * g[k] + B2 * nu[k]
                u = (mu[k] / (1 - B1 ** c)) / (
                    torch.sqrt(nu[k] / (1 - B2 ** c)) + EPS)
                u = u + t["weight_decay"] * P[k]
                P[k] -= lr * u
            for i in range(first, L_n):
                load = torch.bincount(picked[i].reshape(-1),
                                      minlength=E).float()
                bias[i] = bias[i] + t["router_bias_rate"] * torch.sign(
                    load.mean() - load)
            if step % t["memory_store_interval"] == 0:
                n = summary.shape[0]
                at = (written + torch.arange(n)) % rows.shape[0]
                rows[at.to(rows.device)] = summary
                writes.append((step, at.to(rows.device), summary))
                written += n
    return {"losses": losses, "grad": first_grad,
            "params": {k: v.detach() for k, v in P.items()},
            "writes": writes, "route_gaps": gaps, "picks": picks}
