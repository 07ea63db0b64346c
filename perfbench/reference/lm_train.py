"""The trainer's step in plain PyTorch: the training cell's reference.

A frozen statement of one wake step of the preset's trainer, as its
configuration states it (amygdala prosody on, thalamus off, no memory
veto, dropout on, no EWC): prosody from the amygdala on the token
embeddings; the forward of `lm_plain.Model` in training mode (dropout
masks from the step's dropout seed, the surrogate gradient of the spikes)
injecting at each layer the bank rows the program retrieved there; the
composite loss (label-smoothed next-token cross-entropy, minus the
entropy bonus, plus the place-code sparsity penalty); autograd; the
global-norm clip and AdamW under the warmup-cosine schedule; on a store
step the batch's memory summaries written over the bank's oldest rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference import lm_plain

B1, B2, EPS = 0.9, 0.999, 1e-8


def composite_loss(logits, labels, activity, t: dict) -> torch.Tensor:
    """Next-token loss of logits [B, L, V] against labels [B, L]."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    y = labels[:, 1:]
    nll = -lp.gather(-1, y[..., None])[..., 0]
    s = t["label_smoothing"]
    nll = (1.0 - s) * nll + s * (-lp.mean(dim=-1))
    n = float(nll.numel())
    loss = nll.sum() / n
    entropy = -(lp.exp() * lp).sum(dim=-1).sum() / n
    loss = loss - t["entropy_lambda"] * entropy
    return loss + t["sparsity_lambda"] * (activity.mean()
                                          - t["target_sparsity"]) ** 2


def prosody(amygdala: Dict[str, torch.Tensor], table: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    """[B, L, 4] = [arousal, valence, arousal, valence]: a two-layer MLP
    (ReLU, tanh) on each row's mean token embedding, averaged over the
    batch; arousal = (mean + 1) / 2."""
    x = table[ids].float().mean(dim=1)
    h = torch.relu(F.linear(x, amygdala["fc1.weight"], amygdala["fc1.bias"]))
    avg = torch.tanh(F.linear(h, amygdala["fc2.weight"],
                              amygdala["fc2.bias"])).mean(dim=0)
    a, v = (avg[0] + 1.0) / 2.0, avg[1]
    B, L = ids.shape
    return torch.stack([a, v, a, v])[None, None, :].expand(B, L, 4)


def learning_rate(t: dict, count: int) -> float:
    """optax's warmup-cosine schedule at step `count`."""
    lr, total = t["lr"], max(2, t["max_steps"])
    warm = min(max(1, t["warmup_steps"]), total - 1)
    if count < warm:
        return lr * count / warm
    decay = float(total - warm)
    alpha = t["min_lr_ratio"]
    cos = 0.5 * (1.0 + math.cos(math.pi * min(count - warm, decay) / decay))
    return lr * ((1.0 - alpha) * cos + alpha)


def train_steps(P0: Dict[str, torch.Tensor], amygdala, m: dict, mem: dict,
                t: dict, batches: Sequence[torch.Tensor], rows: torch.Tensor,
                slots: Sequence[List[torch.Tensor]], seeds: Sequence[int],
                dtype: torch.dtype, linear=lm_plain.plain_linear,
                half_batch: bool = False) -> dict:
    """Runs the steps of `batches` (ids [B, L] each, labels = ids) from
    weights P0; `slots[s][l]` are the rows layer l injected in step s,
    `seeds[s]` its dropout seed. Returns each step's loss, the first
    step's clipped gradient and the weights after the last step, by
    name, and the bank rows each store step wrote ([(step, slots, rows)]).
    `half_batch` plants a fault: the loss of the first half of the rows
    only."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P0.items()}
    nu = {k: torch.zeros_like(v) for k, v in P0.items()}
    rows = rows.clone()
    written = rows.shape[0]                      # the bank starts full
    losses, first_grad, writes = [], None, []
    for step, ids in enumerate(batches):
        pros = prosody(amygdala, P["semantic_encoder.token_embedding.weight"]
                       .detach(), ids)
        model = lm_plain.Model(P, m, mem, linear, dtype,
                               lm_plain.Dropout(seeds[step], m["dropout"]))
        temporal = math.exp(-step * mem["seconds_per_step"]
                            / mem["temporal_tau"])
        logits, act, summary = model.forward(ids, rows, slots[step], pros,
                                             temporal)
        rows_used = slice(0, ids.shape[0] // 2) if half_batch \
            else slice(None)
        loss = composite_loss(logits[rows_used], ids[rows_used],
                              act[rows_used], t)
        names = list(P)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(loss.item())
        with torch.no_grad():
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            clip = t["gradient_clip"]
            scale = 1.0 if norm < clip else clip / norm
            g = {k: gr * scale for k, gr in zip(names, grads)}
            if first_grad is None:
                first_grad = {k: v.clone() for k, v in g.items()}
            c = step + 1
            lr = learning_rate(t, step)
            for k in names:
                mu[k] = (1 - B1) * g[k] + B1 * mu[k]
                nu[k] = (1 - B2) * g[k] * g[k] + B2 * nu[k]
                u = (mu[k] / (1 - B1 ** c)) / (
                    torch.sqrt(nu[k] / (1 - B2 ** c)) + EPS)
                u = u + t["weight_decay"] * P[k]
                P[k] -= lr * u
            if step % t["memory_store_interval"] == 0:
                n = summary.shape[0]
                at = (written + torch.arange(n)) % rows.shape[0]
                rows[at.to(rows.device)] = summary
                writes.append((step, at.to(rows.device), summary))
                written += n
    return {"losses": losses, "grad": first_grad,
            "params": {k: v.detach() for k, v in P.items()},
            "writes": writes}
