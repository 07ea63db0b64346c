"""The overflow annex on kernel B's path: score, select, rerank and merge.

Counterpart of the JAX package's XLA annex after its v3r kernel
(`aura_snn_rag_tpu/memory/engine.py:385-404`), which no Pallas kernel
replaces there. The annex is the last G = min(overflow_buckets, K // 4)
clusters of the clustered store: rows that overflowed every spill round,
which no probe reaches, so every query scores all G*C of them.

- `annex_coarse`: the annex's coarse top-kcap (scores, slots, valid) from
  one [G*C, D] bf16 product; every IVF path with an annex merges it.
- `annex_merge`: kernel B's top-k lanes merged with the exact f32 rerank
  of the annex's coarse top-kcap into the final top-k. CUDA tensors launch
  `csrc/ivf_scan.cu`'s annex pass (`annex_select_kernel`, then
  `annex_rerank_kernel`; bound and design in its note), whose scores never
  reach device memory as a [B, G*C] matrix (only the kept keys are
  written; the workspace reserved for them is sized for every row kept,
  B*G*C*8 bytes, 268 MB at B = 1024 and G*C = 32,768); CPU tensors run
  `annex_merge_plain`, the PyTorch chain the engine ran before the pass.
- `annex_merge_grad`: `annex_merge` with the exact scores' gradient into
  the queries (`ivf_scan.exact_score_grad`, kernel B's formula).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch.ops.cuda import _build
from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import (
    DEAD, KK_MAX_FUSED, KPAD, NEG_INF, exact_score_grad)
from aura_snn_rag_tpu_torch.ops.scoring import combined_score, l2norm
from aura_snn_rag_tpu_torch.utils.trace import count


def annex_clusters(config, state) -> int:
    """G: how many of the last clusters form the annex (0 = none)."""
    return min(config.overflow_buckets, state.k_centroids // 4)


def annex_coarse(config, state, qn: torch.Tensor,
                 query_locations: Optional[torch.Tensor], kcap: int):
    """Coarse-score the overflow annex (last G clusters) with one
    [G*C, D] bf16 product; its top-kcap (scores, slots, valid), or None
    when no annex is configured."""
    K, C = state.k_centroids, state.bucket_capacity
    G = annex_clusters(config, state)
    if G == 0:
        return None
    Ku = K - G
    D = state.clustered.shape[-1]
    a_feats = state.clustered[Ku:].reshape(G * C, D)
    cos = (qn.to(a_feats.dtype) @ a_feats.T).float()          # [B, G*C]
    strength = torch.exp(state.decay_accum
                         - state.cluster_decay[Ku:]).reshape(-1)
    ages = (state.step - state.cluster_ts[Ku:]).reshape(-1) \
        * config.seconds_per_step
    temporal = torch.exp(-torch.clamp(ages, min=0.0) / config.temporal_tau)
    gens = state.cluster_gen[Ku:].reshape(-1)
    valid = (gens >= 0) & (gens >= state.count - state.max_memories)
    if query_locations is not None:
        locs = state.cluster_loc[Ku:].reshape(G * C, -1)
        d = torch.sqrt(((locs[None] - query_locations[:, None]) ** 2).sum(-1)
                       + 1e-12)
        spatial = 1.0 / (1.0 + d)
    else:
        spatial = 0.0
    comb = ((config.w_cosine * cos + config.w_spatial * spatial
             + config.w_temporal * temporal[None, :]) * strength[None, :])
    comb = torch.where(valid[None, :], comb, NEG_INF)
    kcap = min(kcap, comb.shape[-1])
    sc, pick = torch.topk(comb, kcap, dim=1)
    slots_row = state.cluster_slot[Ku:].reshape(-1).clamp(min=0).long()
    return sc, slots_row[pick], sc > NEG_INF / 2


def annex_merge_plain(config, state, qn: torch.Tensor, scores: torch.Tensor,
                      slots: torch.Tensor, kcap: int, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pass in PyTorch: the annex's coarse top-kcap, its exact f32
    rerank (`combined_score` without locations), then the top-k of
    kernel B's lanes (`scores`, `slots` [B, k]) followed by the annex's,
    so equal scores keep B's lanes first."""
    a_s, a_sl, a_valid = annex_coarse(config, state, qn, None, kcap)
    a_cos = torch.einsum("bkd,bd->bk", l2norm(state.features[a_sl]), qn)
    a_exact = combined_score(config, state, a_cos, a_sl, None)
    a_exact = torch.where(a_valid, a_exact, NEG_INF)
    all_s = torch.cat([scores, a_exact], dim=1)
    all_sl = torch.cat([slots, a_sl], dim=1)
    scores, pick = torch.topk(all_s, k, dim=1)
    return scores, all_sl.gather(1, pick)


# (B, N) -> bytes of the pass's kept keys and their counts at the
# library's launch shape
_workspace_bytes = _build.Entry("ivf_scan", "annex_workspace_bytes", "ii",
                                restype="l")
_merge_launch = _build.Entry(
    "ivf_scan", "annex_merge_launch", "p" * 17 + " l iiiiiii ffff",
    counts=("annex_select", "annex_rerank"))


def annex_merge(config, state, qn: torch.Tensor, b_scores: torch.Tensor,
                b_slots: torch.Tensor, kcap: int, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's output (`b_scores` [B, 128] f32, `b_slots` [B, 128]
    i32, lanes < k its top-k) merged with the annex into the final top-k:
    (scores [B, k] f32, slots [B, k] int64), a lane without a hit at
    -1e30 and slot -1. The annex's coarse funnel is kcap wide (kernel B's
    kk, rounded to 128 lanes). Without an annex (G = 0) B's lanes are the
    result."""
    G = annex_clusters(config, state)
    B = qn.shape[0]
    if not (0 < k <= KPAD and 0 < kcap <= KK_MAX_FUSED):
        raise ValueError(f"annex_merge: kcap={kcap}, k={k}")
    if G == 0:
        s = b_scores[:, :k]
        return s, torch.where(s > DEAD, b_slots[:, :k].long(), -1)
    if not state.clustered.is_cuda:
        s, sl = annex_merge_plain(config, state, qn, b_scores[:, :k],
                                  b_slots[:, :k].long(), kcap, k)
        return s, torch.where(s > DEAD, sl, -1)
    K, C, D = state.clustered.shape
    Ku, N = K - G, G * C
    kcap = min(kcap, N)
    qn = qn.float().contiguous()
    rows, cdecay, cts, cgen, cslot = (
        t[Ku:] for t in (state.clustered, state.cluster_decay,
                         state.cluster_ts, state.cluster_gen,
                         state.cluster_slot))
    f32, i32 = torch.float32, torch.int32
    # 16-byte loads from the rows, the queries and the features; the rest
    # is read a word at a time
    _build.check_inputs(
        "annex_merge", (rows, torch.bfloat16), (qn, f32),
        (state.features, f32), (cdecay, f32), (cts, f32), (cgen, i32),
        (cslot, i32), (state.strength, f32),
        (state.timestamp, f32), (state.step, f32), (state.decay_accum, f32),
        (state.count, i32), (b_scores, f32), (b_slots, i32), aligned=3)
    if (D % 8 or qn.shape != (B, D) or state.features.shape[1:] != (D,)
            or b_scores.shape != (B, KPAD) or b_slots.shape != (B, KPAD)):
        raise ValueError(f"annex_merge: clustered "
                         f"{tuple(state.clustered.shape)}, qn "
                         f"{tuple(qn.shape)}, kernel B's lanes "
                         f"{tuple(b_scores.shape)}")
    dev = qn.device
    work = torch.empty(_workspace_bytes(B, N), dtype=torch.uint8, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_slot = torch.empty((B, k), dtype=torch.int64, device=dev)
    # PyTorch divides a CUDA tensor by a Python float as a multiply by its
    # f32 reciprocal; the pass does the same
    inv_tau = float(np.float32(1.0) / np.float32(config.temporal_tau))
    _merge_launch(rows, cdecay, cts, cgen, cslot, state.features,
                  state.strength, state.timestamp, state.step,
                  state.decay_accum, state.count, qn, b_scores, b_slots,
                  work, out_s, out_slot,
                  state.features.shape[0], N, D, B, kcap, k, KPAD,
                  state.max_memories, config.w_cosine, config.w_temporal,
                  config.seconds_per_step, inv_tau)
    count("path.annex_fused")
    return out_s, out_slot


class _AnnexMerge(torch.autograd.Function):
    """`annex_merge` with a gradient into the queries. Kernel B's lanes
    enter detached, so each final lane is counted once: a hit's exact
    score w_cos * strength[slot] * <f_hat[slot], qn> + const is linear in
    qn where the selection does not change, whichever side it came from,
    so the gradient is kernel B's formula over the k final lanes."""

    @staticmethod
    def forward(ctx, qn, config, state, b_scores, b_slots, kcap, k):
        with torch.no_grad():
            s, sl = annex_merge(config, state, qn.detach(), b_scores,
                                b_slots, kcap, k)
        ctx.mark_non_differentiable(sl)
        ctx.save_for_backward(state.features, state.strength, sl)
        ctx.w_cosine = config.w_cosine
        return s, sl

    @staticmethod
    def backward(ctx, g_s, g_sl):
        features, strength, sl = ctx.saved_tensors
        g_qn = exact_score_grad(g_s, features, strength, sl, ctx.w_cosine)
        return g_qn, None, None, None, None, None, None


def annex_merge_grad(config, state, qn: torch.Tensor, b_scores: torch.Tensor,
                     b_slots: torch.Tensor, kcap: int, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`annex_merge` whose scores carry the gradient into `qn`."""
    return _AnnexMerge.apply(qn, config, state, b_scores, b_slots, kcap, k)
