"""Exact retrieval over every stored row: the engine's plain reference.

The bank the benchmark builds is written at logical step 0 with strength
1 and queried at step 0 without locations, so the engine's combined score
of a row is `w_cosine * cos + w_temporal` (the temporal term exp(0) = 1,
no spatial term), and ranking by it is ranking by cosine.

Two numbers judge a set of answers (bank slots and scores per query):
- `score_err`: the largest gap between a returned score and the exact
  combined score of the returned row, worked out in f64 from the rows;
- `recall_at_k`: the share of each query's exact top-k (f32 products,
  TF32 off) that the answer holds, averaged over the queries.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch

from perfbench.core import Check


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 in CUDA matmuls on or off for the block, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def exact_topk(unit_rows: torch.Tensor, unit_queries: torch.Tensor, k: int,
               chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cosines [Q, k], slots [Q, k]) of each unit query's k most similar
    unit rows, f32 products with TF32 off, `chunk` queries at a time."""
    cos, idx = [], []
    with tf32(False):
        for i in range(0, unit_queries.shape[0], chunk):
            c, j = torch.topk(unit_queries[i:i + chunk] @ unit_rows.T, k,
                              dim=1)
            cos.append(c)
            idx.append(j)
    return torch.cat(cos), torch.cat(idx)


def exact_scores(rows: torch.Tensor, queries: torch.Tensor,
                 slots: torch.Tensor, w_cosine: float,
                 w_temporal: float) -> torch.Tensor:
    """[Q, k] f64 combined scores of the given rows for each query."""
    r = rows[slots.clamp(min=0)].double()                      # [Q, k, D]
    q = queries.double()
    cos = torch.einsum("qkd,qd->qk", r, q) / (
        r.norm(dim=-1) * q.norm(dim=-1, keepdim=True))
    return w_cosine * cos + w_temporal


def judge(rows: torch.Tensor, queries: torch.Tensor, slots: torch.Tensor,
          scores: torch.Tensor, weights: dict, k: int, limits: dict
          ) -> List[Check]:
    """The two numbers for answers (`slots`, `scores`) [Q, k] to
    `queries` [Q, D] over `rows` [M, D], beside their limits."""
    dev = rows.device
    slots, scores = slots.to(dev), scores.to(dev)
    queries = queries.to(dev).float()
    want = exact_scores(rows, queries, slots, weights["w_cosine"],
                        weights["w_temporal"])
    err = (scores.double() - want).abs().amax().item()
    if bool((slots < 0).any()):
        err = float("inf")              # a miss in a bank that is full
    _, exact = exact_topk(_unit(rows), _unit(queries), k)
    hits = (slots[:, :, None] == exact[:, None, :]).any(-1).sum().item()
    recall = hits / float(exact.numel())
    return [Check("score_err", err, limits["score_err"], "max"),
            Check(f"recall_at_{k}", recall, limits[f"recall_at_{k}"], "min")]


def rank_check(rows: torch.Tensor, queries: torch.Tensor,
               slots: torch.Tensor, k: int, chunk: int = 256
               ) -> Tuple[int, float]:
    """(hits, widest shortfall) of answers `slots` [Q, k] to `queries`
    [Q, D] over `rows` [M, D], against each query's exact top-k by f64
    cosine: the exact top-k rows the answers hold, and the largest gap,
    at any rank, by which the answers' own exact cosines (sorted) lie
    below the exact top-k's. A swap of two rows that tie costs nothing;
    a missing answer (slot < 0) is an infinite gap."""
    unit = _unit(rows.double())
    hits, worst = 0, 0.0
    for i in range(0, queries.shape[0], chunk):
        s = slots[i:i + chunk].to(rows.device)
        cos = _unit(queries[i:i + chunk].to(rows.device).double()) @ unit.T
        top, idx = torch.topk(cos, k, dim=1)
        got = cos.gather(1, s.clamp(min=0)).sort(dim=1,
                                                 descending=True).values
        hits += (s[:, :, None] == idx[:, None, :]).any(-1).sum().item()
        worst = max(worst, (top - got).amax().item())
        if bool((s < 0).any()):
            worst = float("inf")
    return hits, worst


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (to nearest), as the
    tensor cores round a TF32 product's inputs; the same on any device."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def control(rows: torch.Tensor, queries: torch.Tensor, weights: dict,
            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference in the program's place one precision down: exact
    top-k of products whose inputs are rounded to TF32 (the configuration
    states f32 with TF32 off), accumulated in f32. Returns (slots,
    scores) as the program's answers."""
    cos, idx = exact_topk(round_tf32(_unit(rows)), round_tf32(
        _unit(queries.to(rows.device).float())), k)
    return idx, weights["w_cosine"] * cos + weights["w_temporal"]


def cat_answers(answers: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]], device):
    """Concatenate (queries, slots, scores) triples onto `device`."""
    q, s, c = zip(*answers)
    return (torch.cat([x.to(device) for x in q]),
            torch.cat([x.to(device) for x in s]),
            torch.cat([x.to(device) for x in c]))
