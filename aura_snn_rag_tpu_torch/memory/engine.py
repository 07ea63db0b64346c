"""Operations on `MemoryState`: write / retrieve / decay / rebuild.

Counterpart of `aura_snn_rag_tpu/memory/engine.py`, function for function.
Differences from the JAX package, by design:

- The large state tensors are updated in place; every mutating function
  returns a new MemoryState, and the state passed in is consumed.
- `write_memories` runs its sequential per-row scan as a Python loop on
  device tensors (1-element index tensors, no host sync inside the loop).
- Every coarse funnel is an exact `torch.topk` where the JAX package uses
  `jax.lax.approx_max_k`, so the port's recall is at least the
  reference's.
- Which branch runs depends only on the config and the shapes. The
  kernel wrappers (`ops/cuda`) alone look at the device: they launch the
  CUDA kernel for a CUDA tensor and run the plain version for a CPU one.
- Bank slots in `RetrievalResult.indices` are int64 (PyTorch's index type).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory.state import MemoryState
from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import (
    BLOCK_R, block_member_slots, flat_blockmax, pack_row_terms)
from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import (
    KPAD, ivf_candidates, ivf_retrieve_fused, ivf_retrieve_fused_grad,
    ivf_scan_scores, ivf_topk_scores)

NEG_INF = -1e30

# The exact oracle and every rerank must run in true f32: no TF32 in
# CUDA matmuls (PyTorch's default, set here so nothing else can change it
# under the engine).
torch.backends.cuda.matmul.allow_tf32 = False


class RetrievalResult(NamedTuple):
    indices: torch.Tensor    # [B, k] int64 bank slots (-1 = no hit)
    scores: torch.Tensor     # [B, k] f32 combined scores (0 = no hit)
    features: torch.Tensor   # [B, k, D] raw stored features


def _l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    return x * torch.rsqrt((x * x).sum(dim, keepdim=True) + eps)


def _to_coarse_rows(x_norm: torch.Tensor, dtype: torch.dtype):
    """Per-row max-abs quantisation -> (rows, scale [rows] f32).

    int8 rows use the full +-127 range of each row (dequant
    x ~ q * scale / 127); any other dtype is a plain cast with scale 1."""
    if dtype == torch.int8:
        scale = x_norm.abs().amax(-1, keepdim=True).clamp_min(1e-12)
        q = torch.round(x_norm * (127.0 / scale)).clamp(-127, 127)
        return q.to(torch.int8), scale.squeeze(-1).float()
    ones = torch.ones(x_norm.shape[:-1], dtype=torch.float32,
                      device=x_norm.device)
    return x_norm.to(dtype), ones


def _int8_matmul(q8: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """[B, D] int8 x [M, D] int8 -> [B, M] int32, exact.

    `torch._int_mm` needs more than 16 rows and multiples of 8 on the card:
    the queries are padded to a multiple of 8 and at least 24 rows on every
    device, so the call is the same everywhere."""
    B, D = q8.shape
    M = bank.shape[0]
    if M % 8 or D % 8:
        # exact in f32 while every partial sum stays below 2^24
        if D * 127 * 127 >= 2 ** 24:
            raise ValueError(f"int8 product: D={D} with M={M} % 8 != 0")
        return (q8.float() @ bank.float().T).to(torch.int32)
    Bp = max(24, -(-B // 8) * 8)
    if Bp != B:
        q8 = F.pad(q8, (0, 0, 0, Bp - B))
    return torch._int_mm(q8, bank.T)[:B]


def _coarse_cos(bank_coarse: torch.Tensor, qn: torch.Tensor,
                row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[M, D] coarse bank x [B, D] f32 normalised queries -> cosine [B, M].

    int8 banks: queries quantise per-query max-abs, the int8 product is
    exact in int32, and both rank-1 scale factors apply after it."""
    if bank_coarse.dtype == torch.int8:
        qmax = qn.abs().amax(-1, keepdim=True).clamp_min(1e-12)     # [B, 1]
        q8 = torch.round(qn * (127.0 / qmax)).clamp(-127, 127)
        cos = _int8_matmul(q8.to(torch.int8), bank_coarse).float()
        cos.mul_(qmax * (1.0 / (127.0 * 127.0)))
        if row_scale is not None:
            cos.mul_(row_scale[None, :])
        return cos
    return (qn.to(bank_coarse.dtype) @ bank_coarse.T).float()


# --------------------------------------------------------------------------
# WRITE
# --------------------------------------------------------------------------

def write_memories(config: MemoryConfig, state: MemoryState,
                   features: torch.Tensor,
                   locations: torch.Tensor) -> MemoryState:
    """Write a [B, D] batch (with [B, S] locations) into the bank.

    Sequential within the batch when the index is live: each row's nearest
    centroid sees the centroids (eta = 1/n update) and bucket ring cursors
    left by the rows before it. The loop is a candidate for a kernel."""
    dev = state.device
    features = torch.as_tensor(features).to(device=dev,
                                            dtype=state.features.dtype)
    locations = torch.as_tensor(locations).to(device=dev,
                                              dtype=state.locations.dtype)
    B = features.shape[0]
    M = state.max_memories
    # one host sync: the FIFO cursor and whether the index is live
    count0, ready = torch.stack(
        [state.count.long(), state.index_ready.long()]).tolist()
    gens = count0 + torch.arange(B, device=dev)
    idx = gens % M
    if ready:
        cids = _assign_and_append(state, features, locations, idx, gens)
    else:
        cids = torch.full((B,), -1, dtype=torch.long, device=dev)

    # bank rows: with B > M a later row overwrites an earlier one's slot
    keep = slice(max(0, B - M), B)
    i = idx[keep]
    f = features[keep]
    qrows, qscales = _to_coarse_rows(_l2norm(f), state.features_nb16.dtype)
    state.features[i] = f
    state.features_nb16[i] = qrows
    state.coarse_scale[i] = qscales
    state.locations[i] = locations[keep]
    state.strength[i] = 1.0
    state.timestamp[i] = state.step
    state.centroid_id[i] = cids[keep].to(torch.int32)
    state.slot_gen[i] = gens[keep].to(torch.int32)
    return state._replace(count=state.count + B)


def _assign_and_append(state: MemoryState, features: torch.Tensor,
                       locations: torch.Tensor, idx: torch.Tensor,
                       gens: torch.Tensor) -> torch.Tensor:
    """Per row: nearest centroid, eta = 1/n centroid update, append to the
    centroid's bucket ring. Updates the index tensors in place; returns
    the centroid of every row [B] int64."""
    C = state.bucket_capacity
    fn = _l2norm(features).to(state.clustered.dtype)
    idx32, gens32 = idx.to(torch.int32), gens.to(torch.int32)
    cids = torch.empty(features.shape[0], dtype=torch.long,
                       device=state.device)
    for r in range(features.shape[0]):
        f = features[r]
        d2 = ((state.centroids - f) ** 2).sum(-1)                    # [K]
        cid = torch.argmin(d2).view(1)          # 1-element: no host sync
        new_count = state.centroid_counts[cid] + 1.0
        eta = (1.0 / new_count.clamp(min=1.0))[:, None]
        state.centroids[cid] = ((1.0 - eta) * state.centroids[cid]
                                + eta * f)
        state.centroid_counts[cid] = new_count
        pos = state.bucket_fill[cid] % C
        state.clustered[cid, pos] = fn[r:r + 1]
        state.cluster_slot[cid, pos] = idx32[r:r + 1]
        state.cluster_gen[cid, pos] = gens32[r:r + 1]
        state.cluster_ts[cid, pos] = state.step
        state.cluster_decay[cid, pos] = state.decay_accum
        state.cluster_loc[cid, pos] = locations[r:r + 1]
        state.bucket_fill[cid] += 1
        cids[r:r + 1] = cid
    return cids


def bulk_load(config: MemoryConfig, state: MemoryState,
              features: torch.Tensor, locations: torch.Tensor) -> MemoryState:
    """Vectorised ingest of [N, D] rows into an EMPTY bank (N <= M); call
    `rebuild_centroids` afterwards to build the index."""
    dev = state.device
    f = torch.as_tensor(features).to(device=dev, dtype=state.features.dtype)
    loc = torch.as_tensor(locations).to(device=dev,
                                        dtype=state.locations.dtype)
    N = f.shape[0]
    qrows, qscales = _to_coarse_rows(_l2norm(f), state.features_nb16.dtype)
    state.features[:N] = f
    state.features_nb16[:N] = qrows
    state.coarse_scale[:N] = qscales
    state.locations[:N] = loc
    state.strength[:N] = 1.0
    state.timestamp[:N] = state.step
    state.slot_gen[:N] = (state.count
                          + torch.arange(N, dtype=torch.int32, device=dev))
    return state._replace(count=state.count + N)


# --------------------------------------------------------------------------
# SCORING
# --------------------------------------------------------------------------

def _combined_score(config: MemoryConfig, state: MemoryState,
                    cos: torch.Tensor, slots: Optional[torch.Tensor],
                    query_loc: Optional[torch.Tensor]) -> torch.Tensor:
    """(w_c*cos + w_s*spatial + w_t*temporal) * strength.

    slots: [B, N] bank indices, or None for every row in bank order (cos
    is then [B, M] and the per-row terms broadcast instead of gathering).
    """
    if slots is None:
        strength, ts = state.strength[None, :], state.timestamp[None, :]
        mem_loc = state.locations[None]                          # [1, M, S]
    else:
        strength, ts = state.strength[slots], state.timestamp[slots]
        mem_loc = state.locations[slots] if query_loc is not None else None
    ages = (state.step - ts) * config.seconds_per_step
    temporal = torch.exp(-torch.clamp(ages, min=0.0) / config.temporal_tau)
    if query_loc is not None:
        d = torch.sqrt(((mem_loc - query_loc[:, None, :]) ** 2).sum(-1)
                       + 1e-12)
        spatial = 1.0 / (1.0 + d)
    else:
        spatial = torch.zeros_like(cos)
    return (config.w_cosine * cos + config.w_spatial * spatial
            + config.w_temporal * temporal) * strength


def _rerank(config: MemoryConfig, state: MemoryState, qn: torch.Tensor,
            cand_slots: torch.Tensor, cand_valid: torch.Tensor,
            query_locations: Optional[torch.Tensor],
            k: int) -> RetrievalResult:
    """Exact f32 rerank of [B, N] candidate slots and the final top-k."""
    return _finish(*_rerank_raw(config, state, qn, cand_slots, cand_valid,
                                query_locations, k))


def _rerank_raw(config: MemoryConfig, state: MemoryState, qn: torch.Tensor,
                cand_slots: torch.Tensor, cand_valid: torch.Tensor,
                query_locations: Optional[torch.Tensor], k: int):
    """`_rerank` before its misses are masked: (slots, scores, features),
    a miss scoring -1e30."""
    cand_feats = state.features[cand_slots]                     # [B, N, D]
    exact_cos = torch.einsum("bkd,bd->bk", _l2norm(cand_feats), qn)
    exact = _combined_score(config, state, exact_cos, cand_slots,
                            query_locations)
    exact = torch.where(cand_valid, exact, NEG_INF)
    scores, pick = torch.topk(exact, k, dim=1)
    out_slots = cand_slots.gather(1, pick).long()
    feats = cand_feats.gather(
        1, pick[..., None].expand(-1, -1, cand_feats.shape[-1]))
    return out_slots, scores, feats


def _finish(out_slots, scores, feats) -> RetrievalResult:
    hit = scores > NEG_INF / 2
    return RetrievalResult(torch.where(hit, out_slots, -1),
                           torch.where(hit, scores, 0.0),
                           torch.where(hit[..., None], feats, 0.0))


# --------------------------------------------------------------------------
# RETRIEVE — IVF (centroid-probed) path
# --------------------------------------------------------------------------

def _annex_coarse(config: MemoryConfig, state: MemoryState, qn: torch.Tensor,
                  query_locations: Optional[torch.Tensor], kcap: int):
    """Coarse-score the overflow annex (last G clusters) with one
    [G*C, D] bf16 product; its top-kcap (scores, slots, valid), or None
    when no annex is configured."""
    K, C = state.k_centroids, state.bucket_capacity
    G = min(config.overflow_buckets, K // 4)
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


def build_ivf_aux(config: MemoryConfig, state: MemoryState) -> torch.Tensor:
    """The IVF kernel's metadata sidecar [K, 8, C] f32: row 0 = w_cos *
    strength, row 1 = w_t * temporal * strength (-1e30 when invalid),
    row 2 = bank slot, rows 3..7 = zeros. A pure function of the bank
    state; `HippocampalFormation` caches it per state."""
    strength_all = torch.exp(state.decay_accum - state.cluster_decay)
    ages_all = (state.step - state.cluster_ts) * config.seconds_per_step
    temporal_all = torch.exp(
        -torch.clamp(ages_all, min=0.0) / config.temporal_tau)
    valid_all = ((state.cluster_gen >= 0)
                 & (state.cluster_gen >= state.count - state.max_memories))
    aux_add = (config.w_temporal * temporal_all * strength_all
               + torch.where(valid_all, 0.0, NEG_INF))
    Kc, Cc = aux_add.shape
    return torch.cat([
        (config.w_cosine * strength_all)[:, None],
        aux_add[:, None],
        state.cluster_slot.float()[:, None],
        torch.zeros((Kc, 5, Cc), device=state.device)], dim=1).contiguous()


def retrieve(config: MemoryConfig, state: MemoryState, queries: torch.Tensor,
             query_locations: Optional[torch.Tensor] = None, k: int = 5,
             aux: Optional[torch.Tensor] = None) -> RetrievalResult:
    """Batched approximate retrieval via the centroid index.

    Per query: nearest-P centroids by L2, the P probed [C, D] blocks of the
    clustered store scored with the combined metric (stale entries
    masked), the overflow annex merged in, exact f32 rerank, top-k.

    Branches, as in the JAX package, for `use_pallas_ivf` without
    locations:
    - v3r (kernel B, everything up to the final top-k in the kernel) when
      `ivf_kernel == "v3r"`, probe*capacity >= 128, max_memories % 8 == 0
      and k <= 128;
    - else v3 (kernel D, the coarse top-kk across probes) when
      `ivf_kernel == "v3"` and probe*capacity >= 128;
    - else v2 (kernel E, the coarse top-k of each probe).
    v2 and v3 feed the funnel and the exact rerank below. With locations
    every `ivf_kernel` takes kernel C (v1, the fused gather + dot) and
    scores the metadata around it; `use_pallas_ivf=False` gathers the
    blocks with plain tensor ops. Widths the JAX package's kernels reject
    (v2 with more than 128 per probe, v3 with kk rounded past
    probe*capacity) raise ValueError.
    """
    G = min(config.overflow_buckets, state.k_centroids // 4)
    P = min(config.probe_centroids, state.k_centroids - G)
    C = state.bucket_capacity
    M = state.max_memories
    qn = _l2norm(queries)                                        # [B, D]

    # nearest centroids by L2: argmin ||c||^2 - 2 q.c
    c2 = (state.centroids ** 2).sum(-1)
    cdist = c2[None, :] - 2.0 * (queries @ state.centroids.T)
    _, top_c = torch.topk(-cdist, P, dim=1)                      # [B, P]

    B = queries.shape[0]
    kk = min(max(config.rerank_candidates, 4 * k), P * C)
    if config.use_pallas_ivf and query_locations is None:
        if aux is None:
            aux = build_ivf_aux(config, state)
        if (config.ivf_kernel == "v3r" and P * C >= KPAD and M % 8 == 0
                and k <= KPAD):
            return _retrieve_v3r(config, state, qn, top_c, aux, kk, k)
        if config.ivf_kernel == "v3" and P * C >= KPAD:
            kk = -(-kk // KPAD) * KPAD                           # lane-aligned
            combined, sl = ivf_candidates(state.clustered, aux, qn, top_c,
                                          kk)
        else:
            per_k = min(max(k, -(-kk // P)), C)
            sc, sl = ivf_topk_scores(state.clustered, aux, qn, top_c, per_k)
            combined = sc[:, :, :per_k].reshape(B, -1)
            sl = sl[:, :, :per_k].reshape(B, -1)
        slots = sl.clamp(min=0).long()
        valid = combined > NEG_INF / 2
    else:
        combined, slots, valid = _probe_scores(config, state, qn, top_c,
                                               query_locations)

    annex = _annex_coarse(config, state, qn, query_locations, kk)
    if annex is not None:
        a_s, a_sl, a_valid = annex
        combined = torch.cat([combined, a_s], dim=1)
        slots = torch.cat([slots, a_sl], dim=1)
        valid = torch.cat([valid, a_valid], dim=1)

    # coarse top-kk (exact), then the exact f32 rerank from the bank
    if combined.shape[-1] > kk:
        _, pick = torch.topk(combined, kk, dim=1)
        slots, valid = slots.gather(1, pick), valid.gather(1, pick)
    return _rerank(config, state, qn, slots, valid, query_locations, k)


def _retrieve_v3r(config: MemoryConfig, state: MemoryState, qn: torch.Tensor,
                  top_c: torch.Tensor, aux: torch.Tensor, kk: int,
                  k: int) -> RetrievalResult:
    """Kernel B does the coarse scan, funnel, exact rerank and top-k; the
    annex's coarse top-kk is reranked here and merged by score. The
    scores carry a gradient into `qn` (`ivf_retrieve_fused_grad`, the
    gradient of the JAX package's XLA path), as the annex's do."""
    kk3 = -(-kk // KPAD) * KPAD
    s, sl = ivf_retrieve_fused_grad(state.clustered, aux, state.features,
                                    state.strength, config.w_cosine, qn,
                                    top_c, kk3, k, fused=ivf_retrieve_fused)
    scores, out_slots = s[:, :k], sl[:, :k].long()
    annex = _annex_coarse(config, state, qn, None, kk3)
    if annex is not None:
        a_s, a_sl, a_valid = annex
        a_cos = torch.einsum("bkd,bd->bk",
                             _l2norm(state.features[a_sl]), qn)
        a_exact = _combined_score(config, state, a_cos, a_sl, None)
        a_exact = torch.where(a_valid, a_exact, NEG_INF)
        all_s = torch.cat([scores, a_exact], dim=1)
        all_sl = torch.cat([out_slots, a_sl], dim=1)
        scores, pick2 = torch.topk(all_s, k, dim=1)
        out_slots = all_sl.gather(1, pick2)
    hit = scores > NEG_INF / 2
    feats = state.features[torch.where(hit, out_slots, 0)]
    return _finish(out_slots, scores, feats)


def _probe_scores(config: MemoryConfig, state: MemoryState, qn: torch.Tensor,
                  top_c: torch.Tensor, query_locations: Optional[torch.Tensor]):
    """v1 and the plain gather: the combined score of every probed entry,
    (combined, slots, valid), each [B, P*C]."""
    B = qn.shape[0]
    # FIFO liveness: slot g % M holds generation g iff g >= count - M
    gens = state.cluster_gen[top_c]
    valid = (gens >= 0) & (gens >= state.count - state.max_memories)
    slots = state.cluster_slot[top_c].clamp(min=0).long()        # [B, P, C]
    if config.use_pallas_ivf:
        cos = ivf_scan_scores(state.clustered, qn, top_c)        # [B, P, C]
    else:
        blocks = state.clustered[top_c]                          # [B,P,C,D]
        cos = torch.einsum("bpcd,bd->bpc", blocks.float(), qn)
    strength = torch.exp(state.decay_accum - state.cluster_decay[top_c])
    ages = (state.step - state.cluster_ts[top_c]) * config.seconds_per_step
    temporal = torch.exp(-torch.clamp(ages, min=0.0) / config.temporal_tau)
    if query_locations is not None:
        locs = state.cluster_loc[top_c]                          # [B,P,C,S]
        d = torch.sqrt(((locs - query_locations[:, None, None, :]) ** 2)
                       .sum(-1) + 1e-12)
        spatial = 1.0 / (1.0 + d)
    else:
        spatial = torch.zeros_like(cos)
    combined = (config.w_cosine * cos + config.w_spatial * spatial
                + config.w_temporal * temporal) * strength
    combined = torch.where(valid, combined, NEG_INF).reshape(B, -1)
    return combined, slots.reshape(B, -1), valid.reshape(B, -1)


# --------------------------------------------------------------------------
# RETRIEVE — brute force (exact)
# --------------------------------------------------------------------------

def retrieve_bruteforce(config: MemoryConfig, state: MemoryState,
                        queries: torch.Tensor,
                        query_locations: Optional[torch.Tensor] = None,
                        k: int = 5) -> RetrievalResult:
    """Exact retrieval: one [B, M] f32 product over the whole bank."""
    M = state.max_memories
    qn = _l2norm(queries)
    inv_norm = torch.rsqrt((state.features ** 2).sum(-1) + 1e-12)   # [M]
    cos = (qn @ state.features.T) * inv_norm[None, :]
    combined = _combined_score(config, state, cos, None, query_locations)
    active = torch.arange(M, device=state.device) < state.active_count()
    combined = torch.where(active[None, :], combined, NEG_INF)
    scores, out_slots = torch.topk(combined, k, dim=1)
    hit = scores > NEG_INF / 2
    feats = state.features[torch.where(hit, out_slots, 0)]
    return _finish(out_slots, scores, feats)


# --------------------------------------------------------------------------
# RETRIEVE — flat scan
# --------------------------------------------------------------------------

def retrieve_flat(config: MemoryConfig, state: MemoryState,
                  queries: torch.Tensor,
                  query_locations: Optional[torch.Tensor] = None,
                  k: int = 5) -> RetrievalResult:
    """Batched flat scan over the whole bank (large batches).

    - "scan": [B, M] coarse scores, exact top-kk funnel, exact f32 rerank.
    - "blockmax": kernel A streams the bank once and returns [B, M/8]
      block maxima; the top blocks' member rows get the exact rerank. The
      top-j rows by coarse score lie in the top-j blocks by block max, so
      the funnel has no recall slack before the rerank.
    """
    if config.flat_strategy == "blockmax":
        return _retrieve_flat_blockmax(config, state, queries,
                                       query_locations, k)
    return _retrieve_flat_scan(config, state, queries, query_locations, k)


def _retrieve_flat_scan(config: MemoryConfig, state: MemoryState,
                        queries: torch.Tensor,
                        query_locations: Optional[torch.Tensor],
                        k: int) -> RetrievalResult:
    """[B, M] coarse scores, the exact coarse top-kk, the exact f32 rerank.

    The funnel is an exact `torch.topk`, so it already is what
    `flat_exact_funnel` computes (the exact coarse top-kk through the top
    blocks) and what `flat_wide_funnel` followed by its exact top-kk
    computes; both options take it as it is. `flat_rescue_queries` > 0
    re-funnels the riskiest queries `flat_rescue_width` wide
    (`_flat_rescue`).
    """
    M = state.max_memories
    dev = state.device
    qn = _l2norm(queries)
    sdt = torch.bfloat16 if config.flat_score_dtype == "bf16" \
        else torch.float32
    cos = _coarse_cos(state.features_nb16, qn, state.coarse_scale).to(sdt)
    ages = (state.step - state.timestamp) * config.seconds_per_step
    temporal = torch.exp(-torch.clamp(ages, min=0.0) / config.temporal_tau)
    if query_locations is not None:
        d = torch.sqrt(((state.locations[None] - query_locations[:, None])
                        ** 2).sum(-1) + 1e-12)
        spatial = (1.0 / (1.0 + d)).to(sdt)
    else:
        spatial = torch.zeros((), dtype=sdt, device=dev)
    combined = (config.w_cosine * cos + config.w_spatial * spatial
                + (config.w_temporal * temporal).to(sdt)[None, :]) \
        * state.strength.to(sdt)[None, :]
    active = torch.arange(M, device=dev) < state.active_count()
    combined = torch.where(active[None, :], combined,
                           torch.tensor(NEG_INF, dtype=sdt, device=dev))
    kk = min(max(config.rerank_candidates, 4 * k), M)
    cand_coarse, pick = torch.topk(combined, kk, dim=1)
    out_slots, scores, feats = _rerank_raw(config, state, qn, pick,
                                           active[pick], query_locations, k)
    R = min(config.flat_rescue_queries, qn.shape[0])
    kk2 = min(config.flat_rescue_width, M)
    if R > 0 and kk2 > kk:
        out_slots, scores, feats = _flat_rescue(
            config, state, qn, combined, pick, cand_coarse, out_slots,
            scores, feats, query_locations, k, R, kk2)
    return _finish(out_slots, scores, feats)


def _flat_rescue(config: MemoryConfig, state: MemoryState, qn: torch.Tensor,
                 combined: torch.Tensor, pick: torch.Tensor,
                 cand_coarse: torch.Tensor, out_slots: torch.Tensor,
                 scores: torch.Tensor, feats: torch.Tensor,
                 query_locations: Optional[torch.Tensor], k: int, R: int,
                 kk2: int):
    """Near-tie rescue: re-funnel the R riskiest queries kk2 wide.

    A true top-k row can be missing from the narrow funnel only when its
    coarse score fell below the funnel's cutoff, so the queries whose k-th
    exact score lies closest to their coarse cutoff take kk2 more
    candidates from their coarse rows. The union of both lanes, each slot
    scored once, gets the exact rerank, and the rows go back in place."""
    margin = scores[:, k - 1] - cand_coarse.amin(dim=1).float()     # [B]
    _, risky = torch.topk(-margin, R)                                # [R]
    _, pick_w = torch.topk(combined[risky], kk2, dim=1)
    slots_all = torch.cat([pick[risky], pick_w], dim=1)              # [R, C]
    valid_all = slots_all < state.active_count()
    # a slot in both lanes counts once: every occurrence after its first
    srt, order = slots_all.sort(dim=1, stable=True)
    dup_sorted = torch.zeros_like(srt, dtype=torch.bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    is_dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    loc_r = None if query_locations is None else query_locations[risky]
    s_w, s_sc, f_w = _rerank_raw(config, state, qn[risky], slots_all,
                                 valid_all & ~is_dup, loc_r, k)
    out_slots[risky], scores[risky], feats[risky] = s_w, s_sc, f_w
    return out_slots, scores, feats


def _flat_kernel_ok(state: MemoryState, query_locations) -> bool:
    """Kernel A scores the no-location case; spatial scoring takes the
    plain [B, M] block-max variant."""
    return query_locations is None and state.feature_dim % 128 == 0


def select_block_candidates(bm: torch.Tensor, funnel_blocks: int, k: int,
                            active_count, M: int, R: int):
    """Expand the top blocks of a block-max surface [B, n_blocks] into
    candidate slots: (cand_slots [B, F], cand_valid [B, F]) with
    F = min(max(funnel_blocks, k), n_blocks) * R. Blocks are contiguous.

    Exact two-level selection: super-block maxima (x16) -> top-k over them
    -> expand -> top-k over block maxima. Both levels keep the containment
    guarantee (a top-j block's super-max ranks <= j).
    """
    B, n_blocks = bm.shape
    kk_b = min(max(funnel_blocks, k), n_blocks)
    R2 = 16
    if n_blocks > 4 * R2 * kk_b:
        spad = (-n_blocks) % R2
        sup = F.pad(bm, (0, spad), value=NEG_INF).reshape(B, -1, R2) \
            .amax(-1)                                            # [B, Nsup]
        kk_s = min(max(kk_b, 2 * k), sup.shape[1])
        _, sup_pick = torch.topk(sup, kk_s, dim=1)
        blk_ids = (sup_pick[..., None] * R2
                   + torch.arange(R2, device=bm.device)).reshape(B, -1)
        # ids past n_blocks (padded tail) clamp to the last block with
        # their value forced to -1e30, so no real block surfaces twice
        in_range = blk_ids < n_blocks
        blk_ids = blk_ids.clamp(max=n_blocks - 1)
        blk_vals = torch.where(in_range, bm.gather(1, blk_ids), NEG_INF)
        bvals, p2 = torch.topk(blk_vals, kk_b, dim=1)
        blocks = blk_ids.gather(1, p2)
    else:
        bvals, blocks = torch.topk(bm, kk_b, dim=1)
    block_live = bvals > NEG_INF / 2
    if R != BLOCK_R:
        raise ValueError(f"block rows R={R}; the layout has {BLOCK_R}")
    cand_slots = block_member_slots(blocks).reshape(B, kk_b * R)
    cand_valid = ((cand_slots < active_count)
                  & block_live.repeat_interleave(R, dim=1))
    return cand_slots.clamp(max=M - 1), cand_valid


def _retrieve_flat_blockmax(config: MemoryConfig, state: MemoryState,
                            queries: torch.Tensor,
                            query_locations: Optional[torch.Tensor],
                            k: int) -> RetrievalResult:
    M = state.max_memories
    dev = state.device
    qn = _l2norm(queries)
    B = qn.shape[0]
    R = BLOCK_R
    ages = (state.step - state.timestamp) * config.seconds_per_step
    temporal = torch.exp(-torch.clamp(ages, min=0.0) / config.temporal_tau)
    active = torch.arange(M, device=dev) < state.active_count()
    mul = torch.where(active, config.w_cosine * state.strength, 0.0)
    add = torch.where(active,
                      config.w_temporal * temporal * state.strength, NEG_INF)

    if _flat_kernel_ok(state, query_locations):
        # per-row dequant scale folds into the row term, the per-query
        # max-abs scale into the kernel's epilogue
        bank = state.features_nb16
        qc, qscale = _to_coarse_rows(qn, bank.dtype)
        mul_p, add_p = pack_row_terms(mul * state.coarse_scale, add, M)
        bm = flat_blockmax(bank, qc.contiguous(), mul_p, add_p,
                           q_scale=qscale if bank.dtype == torch.int8
                           else None)                            # [B, Nblk]
    else:
        cos = _coarse_cos(state.features_nb16, qn, state.coarse_scale)
        combined = cos * mul[None, :] + add[None, :]
        if query_locations is not None:
            d = torch.sqrt(((state.locations[None] - query_locations[:, None])
                            ** 2).sum(-1) + 1e-12)
            spatial = (config.w_spatial / (1.0 + d)) * state.strength[None, :]
            combined = combined + torch.where(active[None, :], spatial, 0.0)
        pad = (-M) % R
        if pad:
            combined = F.pad(combined, (0, pad), value=NEG_INF)
        bm = combined.reshape(B, -1, R).amax(-1)

    cand_slots, cand_valid = select_block_candidates(
        bm, config.flat_block_funnel, k, state.active_count(), M, R)
    return _rerank(config, state, qn, cand_slots, cand_valid,
                   query_locations, k)


def retrieve_auto(config: MemoryConfig, state: MemoryState,
                  queries: torch.Tensor,
                  query_locations: Optional[torch.Tensor] = None,
                  k: int = 5) -> RetrievalResult:
    """Dispatch across the three retrieval paths.

    - B * probe * capacity >= M: the IVF gathers would read at least one
      flat pass's bytes, so take the flat scan.
    - Otherwise IVF when the index is live and holds more rows than
      centroids, else brute force.
    """
    B = queries.shape[0]
    ivf_traffic = B * config.probe_centroids * config.bucket_capacity
    if ivf_traffic >= state.max_memories:
        return retrieve_flat(config, state, queries, query_locations, k)
    # one host sync: the branch reads the index flag and the live count
    use_index = bool(state.index_ready
                     & (state.active_count() > state.k_centroids))
    if use_index:
        return retrieve(config, state, queries, query_locations, k)
    return retrieve_bruteforce(config, state, queries, query_locations, k)


# --------------------------------------------------------------------------
# DECAY
# --------------------------------------------------------------------------

def decay_memories(state: MemoryState,
                   decay_rate: float = 0.01) -> MemoryState:
    """Multiplicative strength decay (strength updated in place)."""
    rate = torch.tensor(decay_rate, dtype=state.strength.dtype,
                        device=state.device)
    state.strength.mul_(1.0 - rate)
    return state._replace(decay_accum=state.decay_accum
                          + torch.log(1.0 - rate))


def tick(state: MemoryState, steps: float = 1.0) -> MemoryState:
    """Advance the logical clock."""
    return state._replace(step=state.step + steps)


# --------------------------------------------------------------------------
# REBUILD — batched k-means + bucketed layout
# --------------------------------------------------------------------------

def rebuild_centroids(config: MemoryConfig, state: MemoryState,
                      generator: Optional[torch.Generator] = None
                      ) -> MemoryState:
    """Full index rebuild: K - G random active rows as initial centroids
    (drawn on the CPU from `generator`, so a seed gives the same rows on
    every device), then `_rebuild_from_init`."""
    M, K = state.max_memories, state.k_centroids
    Ku = K - min(config.overflow_buckets, K // 4)
    r = torch.rand(M, generator=generator)
    r[int(state.active_count()):] += 1e9
    init_idx = torch.topk(-r, Ku).indices
    return _rebuild_from_init(config, state, init_idx.to(state.device))


def _rebuild_from_init(config: MemoryConfig, state: MemoryState,
                       init_idx: torch.Tensor) -> MemoryState:
    """Lloyd iterations from the rows `init_idx` [K - G] -> reassign every
    row to its S nearest centroids -> capacity spill rounds -> overflow
    annex -> clustered store sorted by (cluster, distance)."""
    M, K, C = state.max_memories, state.k_centroids, state.bucket_capacity
    dev = state.device
    feats = state.features
    D = feats.shape[1]
    n_active = int(state.active_count())
    active = torch.arange(M, device=dev) < n_active
    # reserved overflow annex: the last G clusters get sentinel centroids
    # (never nearest, never probed) and hold rows that still overflow
    G = min(config.overflow_buckets, K // 4)
    Ku = K - G
    centroids = feats[init_idx.long()]
    if G:
        centroids = torch.cat([centroids, torch.full((G, D), 1e6,
                                                     device=dev)])

    BLK = 65536                 # rows per assignment block ([BLK, K] live)

    def assign_rows_topS(cents, S):
        """Per row: the S nearest centroids and their distance scores."""
        c2 = (cents ** 2).sum(-1)
        idx = torch.empty((M, S), dtype=torch.long, device=dev)
        dist = torch.empty((M, S), device=dev)
        for s0 in range(0, M, BLK):
            d = c2[None, :] - 2.0 * (feats[s0:s0 + BLK] @ cents.T)
            if S == 1:
                i = torch.argmin(d, dim=1, keepdim=True)
                idx[s0:s0 + BLK], dist[s0:s0 + BLK] = i, d.gather(1, i)
            else:
                negd, i = torch.topk(-d, S, dim=1)
                idx[s0:s0 + BLK], dist[s0:s0 + BLK] = i, -negd
        return idx, dist

    for _ in range(max(1, config.rebuild_lloyd_iters)):
        a = assign_rows_topS(centroids, 1)[0][:n_active, 0]
        sums = torch.zeros((K, D), device=dev).index_add_(
            0, a, feats[:n_active])
        counts = torch.bincount(a, minlength=K).float()
        centroids = torch.where(counts[:, None] > 0,
                                sums / counts.clamp(min=1.0)[:, None],
                                centroids)

    # final assignment + capacity-aware spill: a cluster's members ranked
    # by distance; members at rank >= C move to their next-nearest
    # centroid, round after round
    S = max(2, min(int(config.spill_rounds) + 1, Ku))
    idxS, distS = assign_rows_topS(centroids, S)
    rows = torch.arange(M, device=dev)

    def sort_by_cluster(a, key):
        """Permutation ordering rows by (cluster, key), stable."""
        order_d = torch.argsort(key, stable=True)
        return order_d[torch.argsort(a[order_d], stable=True)]

    def cluster_start(a):
        cnt = torch.bincount(a, minlength=K + 1)[:K]
        return torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                          torch.cumsum(cnt, 0)])

    choice = torch.zeros(M, dtype=torch.long, device=dev)
    for _ in range(S - 1):
        a = torch.where(active, idxS[rows, choice], K)
        order = sort_by_cluster(a, distS[rows, choice])
        sorted_a = a[order]
        rank = torch.empty(M, dtype=torch.long, device=dev)
        rank[order] = rows - cluster_start(a)[sorted_a.clamp(max=K - 1)]
        overflow = (rank >= C) & (a < K)
        choice = torch.where(overflow & (choice < S - 1), choice + 1, choice)
    assign = torch.where(active, idxS[rows, choice], K)
    counts = torch.bincount(assign[:n_active], minlength=K).float()

    # ---- bucketed layout: rows sorted by (cluster, distance) ----
    order = sort_by_cluster(assign, distS[rows, choice])
    sorted_assign = assign[order]
    rank = rows - cluster_start(assign)[sorted_assign.clamp(max=K - 1)]
    keep = (sorted_assign < K) & (rank < C)
    row = torch.where(keep, sorted_assign, K)
    col = torch.where(keep, rank, 0)
    if G:
        # rows still overflowing pack in order into the annex clusters
        # [Ku, K); beyond G*C they drop (reachable only by flat / brute)
        over = ~keep & (sorted_assign < K)
        a_idx = torch.cumsum(over.long(), 0) - 1
        in_annex = over & (a_idx < G * C)
        row = torch.where(in_annex, Ku + a_idx // C, row)
        col = torch.where(in_annex, a_idx % C, col)
    placed = row < K
    r, c, src = row[placed], col[placed], order[placed]

    def scatter(fill, dtype, values, tail=()):
        out = torch.full((K, C) + tuple(tail), fill, dtype=dtype, device=dev)
        out[r, c] = values.to(dtype)
        return out

    s = state.strength[src].clamp(min=1e-20)
    bucket_fill = counts.to(torch.int32).clamp(max=C)
    if G:
        n_over = min(int(over.sum()), G * C)
        bucket_fill[Ku:] = (n_over - torch.arange(G, device=dev) * C) \
            .clamp(0, C).to(torch.int32)
    return state._replace(
        centroid_id=torch.where(active, assign, -1).to(torch.int32),
        centroids=centroids,
        centroid_counts=counts,
        clustered=scatter(0.0, state.clustered.dtype,
                          _l2norm(feats[src]), (D,)),
        cluster_slot=scatter(-1, torch.int32, src),
        cluster_gen=scatter(-1, torch.int32, state.slot_gen[src]),
        cluster_ts=scatter(0.0, torch.float32, state.timestamp[src]),
        cluster_decay=scatter(0.0, torch.float32,
                              state.decay_accum - torch.log(s)),
        cluster_loc=scatter(0.0, torch.float32, state.locations[src],
                            (state.cluster_loc.shape[-1],)),
        bucket_fill=bucket_fill,
        index_ready=state.active_count() >= Ku,
    )
