"""What one IVF retrieval needs (`engine.retrieve`, kernel B's path,
queries without locations), from the shapes and the bank's fill.

`fills` [K] is each cluster's filled rows (capped at its capacity),
`top_c` [B, P] the probed clusters. Unlike the bound in `chip_smoke.py`
(which charges every bucket slot, filled or not), only filled rows count:
the engine's buckets are about half full at `bucket_overprovision` 2.0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

KPAD = 128               # kernel B's candidate lanes per query (kk rounded)

Count = Tuple[float, Dict[str, float]]      # (bytes, {precision: ops})


def _add(*counts: Count) -> Count:
    nbytes = sum(c[0] for c in counts)
    ops: Dict[str, float] = {}
    for _, o in counts:
        for kind, n in o.items():
            ops[kind] = ops.get(kind, 0.0) + n
    return nbytes, ops


def kernel_b(fills: torch.Tensor, top_c: torch.Tensor, D: int,
             kk: int = KPAD) -> Count:
    """Kernel B on one batch: the filled bf16 rows of every probed cluster
    and their three aux words (cosine weight, temporal term, slot) read
    once, however many queries probe the cluster; the queries (f32) and
    probe ids; the f32 rows and strengths of each query's reranked
    candidates (at most `kk`, at most its probed rows); the [B, kk] score
    and slot lanes written. Operations: each query's dot products with
    every filled row it probes (bf16), and the f32 rerank."""
    B, P = top_c.shape
    uniq = torch.unique(top_c)
    rows_read = float(fills[uniq].sum())
    per_query = fills[top_c].sum(dim=1).double()                   # [B]
    rerank = float(per_query.clamp(max=kk).sum())
    nbytes = (rows_read * (D * 2 + 3 * 4) + B * (D * 4 + P * 4)
              + rerank * (D * 4 + 4) + B * kk * 8)
    ops = {"bf16": 2.0 * float(per_query.sum()) * D,
           "f32": 2.0 * rerank * D}
    return nbytes, ops


def retrieve_call(fills: torch.Tensor, top_c: torch.Tensor, K: int,
                  D: int, k: int, annex_rows: int, kk: int = KPAD) -> Count:
    """The whole `engine.retrieve` call: the nearest-P probe (the f32
    centroids read once, a [B, K] f32 product), kernel B, the overflow
    annex (its valid bf16 rows and four metadata words read once, a bf16
    product, the f32 rerank of each query's top min(kk, annex) rows), and
    the result (k slots, scores and f32 rows per query, read from the
    bank and written). The aux sidecar is not counted: it is a function
    of the bank, built once per bank state."""
    B = top_c.shape[0]
    probe = (K * D * 4.0, {"f32": 2.0 * B * K * D})
    annex_rerank = min(kk, annex_rows)
    annex = (annex_rows * (D * 2 + 4 * 4) + B * annex_rerank * (D * 4 + 4),
             {"bf16": 2.0 * B * annex_rows * D,
              "f32": 2.0 * B * annex_rerank * D})
    result = (B * k * (8 + 4 + 2 * D * 4), {})
    return _add(probe, kernel_b(fills, top_c, D, kk), annex, result)


def probes(queries: torch.Tensor, centroids: torch.Tensor, P: int
           ) -> torch.Tensor:
    """[B, P] nearest centroids by L2, as the engine picks them."""
    c2 = (centroids ** 2).sum(-1)
    d = c2[None, :] - 2.0 * (queries @ centroids.T)
    return torch.topk(-d, P, dim=1).indices
