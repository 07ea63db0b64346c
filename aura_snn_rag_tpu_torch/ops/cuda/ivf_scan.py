"""Kernels B, C, D and E: the IVF probe scan (counterpart of
`aura_snn_rag_tpu/ops/pallas/ivf_scan.py`).

- `ivf_scan_scores` (kernel C, replaces the v1 TPU kernel at
  aura_snn_rag_tpu/ops/pallas/ivf_scan.py:550): bf16 cosines of each query
  against its P probed [C, D] cluster blocks -> [B, P, C] f32.
- `ivf_retrieve_fused` (kernel B, replaces the v3r TPU kernel at
  aura_snn_rag_tpu/ops/pallas/ivf_scan.py:317): coarse score
  aux0 * cos + aux1, exact top-kk across probes (ties to the lowest flat
  index p*C + c; dead lanes at -1e30), exact f32 rerank of the kk raw bank
  rows, final top-k.
- `ivf_candidates` (kernel D, replaces the v3 TPU kernel at
  aura_snn_rag_tpu/ops/pallas/ivf_scan.py:186): the coarse top-kk across
  probes, sorted descending, ties to the lowest flat index p*C + c.
- `ivf_topk_scores` (kernel E, replaces the v2 TPU kernel at
  aura_snn_rag_tpu/ops/pallas/ivf_scan.py:62): the coarse top-k of each
  probe, sorted descending, ties to the lowest c.

All four launch `csrc/ivf_scan.cu` for CUDA tensors (bound and design in
its header; B and D through a [B, P*C] scratch, C and E in one launch)
and run the `_plain` versions below for CPU tensors. B and D's coarse
pass is chosen in the library from (B, P, K): per pair at small batches,
cluster-major once the batch's pairs crowd the clusters (each probed
cluster read once for all the queries that probe it; its workspace rides
after the scratch, `_workspace_words`).
`exact_score_grad` is the gradient of B's exact scores into the queries
(plain PyTorch, on either device): the engine's v3r path takes it through
the overflow annex's Function (`annex.py`), which merges B's lanes
detached.

Output conventions:
- `ivf_retrieve_fused`: lanes < k hold the final top-k sorted by exact
  score (ties to the lower funnel lane); a lane without a live candidate,
  and every lane >= k, holds score -1e30 and slot -1.
- `ivf_candidates` and `ivf_topk_scores`: every selected lane holds its
  entry's coarse score and its bank slot (aux row 2). Once a probe's or a
  query's live entries run out, dead entries (score <= -5e29) fill the
  remaining lanes; callers mask them by score. Lanes >= k of
  `ivf_topk_scores` hold -1e30 and slot 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aura_snn_rag_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
DEAD = -5e29                # coarse or exact scores at or below are dead
KPAD = 128                  # output width of ivf_retrieve_fused and E
KK_MAX_FUSED = 4096         # kernel B: keys, query and candidate metadata
KK_MAX_CANDIDATES = 16384   # kernel D: 128 KB of sorted keys in shared memory


def ivf_scan_scores_plain(clustered: torch.Tensor, qn: torch.Tensor,
                          top_c: torch.Tensor) -> torch.Tensor:
    """Kernel C in PyTorch: [B, P, C] f32 cosines, bf16 operands."""
    blocks = clustered[top_c.long()].float()                 # [B, P, C, D]
    q16 = qn.to(torch.bfloat16).float()
    return torch.einsum("bpcd,bd->bpc", blocks, q16)


def _coarse_plain(clustered, aux, qn, top_c):
    """The coarse pass of kernels B, D and E in PyTorch: aux0 * cos + aux1
    and the aux rows (mul, add, slot), each [B, P, C]."""
    cos = ivf_scan_scores_plain(clustered, qn, top_c)
    a = aux[top_c.long()]                                    # [B, P, 8, C]
    a0, a1, sl = a[:, :, 0], a[:, :, 1], a[:, :, 2]
    return a0 * cos + a1, a0, a1, sl


def ivf_retrieve_fused_plain(clustered: torch.Tensor, aux: torch.Tensor,
                             features: torch.Tensor, qn: torch.Tensor,
                             top_c: torch.Tensor, kk: int, k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B in PyTorch. Stable sorts reproduce both tie rules."""
    B = top_c.shape[0]
    M = features.shape[0]
    coarse, a0, a1, sl = (x.reshape(B, -1) for x in _coarse_plain(
        clustered, aux, qn, top_c))
    order = torch.argsort(coarse, dim=1, descending=True, stable=True)[:, :kk]
    live = coarse.gather(1, order) > DEAD
    a0k = torch.where(live, a0.gather(1, order), 0.0)
    a1k = torch.where(live, a1.gather(1, order), NEG_INF)
    slot = torch.where(live, sl.gather(1, order).long(), -1)
    rows = features[slot.clamp(0, M - 1)]                    # [B, kk, D]
    dot = torch.einsum("bkd,bd->bk", rows, qn.float())
    n2 = (rows * rows).sum(-1)
    exact = a0k * (dot * torch.rsqrt(n2 + 1e-12)) + a1k
    exact = torch.where(slot >= 0, exact, NEG_INF)
    pick = torch.argsort(exact, dim=1, descending=True, stable=True)[:, :k]
    s = exact.gather(1, pick)
    hit = s > DEAD
    out_s = torch.full((B, KPAD), NEG_INF, device=qn.device)
    out_slot = torch.full((B, KPAD), -1, dtype=torch.int32, device=qn.device)
    out_s[:, :k] = torch.where(hit, s, NEG_INF)
    out_slot[:, :k] = torch.where(hit, slot.gather(1, pick), -1).int()
    return out_s, out_slot


def ivf_candidates_plain(clustered: torch.Tensor, aux: torch.Tensor,
                         qn: torch.Tensor, top_c: torch.Tensor, kk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D in PyTorch. A stable sort reproduces the tie rule."""
    B = top_c.shape[0]
    coarse, _, _, sl = _coarse_plain(clustered, aux, qn, top_c)
    coarse, sl = coarse.reshape(B, -1), sl.reshape(B, -1)
    order = torch.argsort(coarse, dim=1, descending=True, stable=True)[:, :kk]
    return coarse.gather(1, order), sl.gather(1, order).int()


def ivf_topk_scores_plain(clustered: torch.Tensor, aux: torch.Tensor,
                          qn: torch.Tensor, top_c: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E in PyTorch. A stable sort reproduces the tie rule."""
    B, P = top_c.shape
    coarse, _, _, sl = _coarse_plain(clustered, aux, qn, top_c)
    order = torch.argsort(coarse, dim=2, descending=True, stable=True)[..., :k]
    out_s = torch.full((B, P, KPAD), NEG_INF, device=qn.device)
    out_slot = torch.zeros((B, P, KPAD), dtype=torch.int32, device=qn.device)
    out_s[..., :k] = coarse.gather(2, order)
    out_slot[..., :k] = sl.gather(2, order).int()
    return out_s, out_slot


def _ivf_args(name, clustered, aux, qn, top_c, features=None):
    """Checks the CUDA kernels' inputs; returns (qn f32, top_c i32), both
    contiguous. The keys carry the flat index p*C + c in 32 bits."""
    K, C, D = clustered.shape
    B, P = top_c.shape
    top_c = top_c.to(torch.int32).contiguous()
    qn = qn.float().contiguous()
    _build.check_inputs(
        name, (clustered, torch.bfloat16), (qn, torch.float32),
        (top_c, torch.int32),
        *[(t, torch.float32) for t in (aux, features) if t is not None])
    if (D % 8 or qn.shape != (B, D) or P * C >= 2 ** 31
            or (aux is not None and aux.shape != (K, 8, C))
            or (features is not None and features.shape[1:] != (D,))):
        raise ValueError(
            f"{name}: clustered {tuple(clustered.shape)}, qn "
            f"{tuple(qn.shape)}, top_c {tuple(top_c.shape)}, aux "
            f"{None if aux is None else tuple(aux.shape)}, features "
            f"{None if features is None else tuple(features.shape)}")
    return qn, top_c


_scores_launch = _build.Entry("ivf_scan", "ivf_scan_scores_launch",
                              "pppp iiii")
_fused_launch = _build.Entry("ivf_scan", "ivf_retrieve_fused_launch",
                             "pppppppp iii l iiiii")
_candidates_launch = _build.Entry("ivf_scan", "ivf_candidates_launch",
                                  "ppppppp iiiiii")
_topk_launch = _build.Entry("ivf_scan", "ivf_topk_scores_launch",
                            "pppppp iiiii")
# (B, P, K, D) -> f32 words that B and D's coarse pass needs after the
# [B, P*C] scratch: 0 where it runs per pair, else the cluster-major
# pass's buckets, tiles and bf16 queries
_workspace_words = _build.Entry("ivf_scan", "ivf_coarse_workspace_words",
                                "iiii", restype="l")


def cluster_major(B: int, P: int, K: int) -> bool:
    """Whether kernels B and D run the cluster-major coarse pass on a
    card at this batch, probe count and cluster count (the library's own
    choice; it needs the built library)."""
    return _workspace_words(B, P, K, 8) > 0


def _scratch(B: int, P: int, C: int, K: int, D: int, device) -> torch.Tensor:
    """The coarse scores [B, P*C] f32 with the coarse pass's workspace
    after them, in one allocation."""
    n = B * P * C + _workspace_words(B, P, K, D)
    return torch.empty(n, dtype=torch.float32, device=device)


def ivf_scan_scores(clustered: torch.Tensor, qn: torch.Tensor,
                    top_c: torch.Tensor) -> torch.Tensor:
    """clustered [K, C, D] bf16, qn [B, D] f32 (cast to bf16 inside),
    top_c [B, P] probed cluster ids -> cosines [B, P, C] f32."""
    if not clustered.is_cuda:
        return ivf_scan_scores_plain(clustered, qn, top_c)
    _, C, D = clustered.shape
    B, P = top_c.shape
    qn, top_c = _ivf_args("ivf_scan_scores", clustered, None, qn, top_c)
    out = torch.empty((B, P, C), dtype=torch.float32, device=qn.device)
    _scores_launch(clustered, qn, top_c, out, C, D, B, P)
    return out


def ivf_retrieve_fused(clustered: torch.Tensor, aux: torch.Tensor,
                       features: torch.Tensor, qn: torch.Tensor,
                       top_c: torch.Tensor, kk: int, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """clustered [K, C, D] bf16; aux [K, 8, C] f32 (`build_ivf_aux`);
    features [M, D] f32; qn [B, D] f32 L2-normalised; top_c [B, P].
    Returns (scores [B, 128] f32, slots [B, 128] i32)."""
    K, C, D = clustered.shape
    B, P = top_c.shape
    if not (0 < kk <= P * C and kk <= KK_MAX_FUSED
            and 0 < k <= min(kk, KPAD)):
        raise ValueError(f"ivf_retrieve_fused: kk={kk}, k={k}, P*C={P * C}")
    if not clustered.is_cuda:
        return ivf_retrieve_fused_plain(clustered, aux, features, qn, top_c,
                                        kk, k)
    M = features.shape[0]
    qn, top_c = _ivf_args("ivf_retrieve_fused", clustered, aux, qn, top_c,
                          features)
    scratch = _scratch(B, P, C, K, D, qn.device)
    out_s = torch.empty((B, KPAD), dtype=torch.float32, device=qn.device)
    out_slot = torch.empty((B, KPAD), dtype=torch.int32, device=qn.device)
    _fused_launch(clustered, aux, features, qn, top_c, scratch, out_s,
                  out_slot, C, D, K, M, B, P, kk, k, KPAD)
    return out_s, out_slot


def exact_score_grad(g_s: torch.Tensor, features: torch.Tensor,
                     strength: torch.Tensor, slots: torch.Tensor,
                     w_cosine: float) -> torch.Tensor:
    """The gradient into qn [B, D] of exact scores [B, n] whose lanes hold
    bank `slots` [B, n] (-1 for a miss, which passes none): for each hit,
    g[b, j] * w_cosine * strength[slot] * f_hat[slot]. The selection
    (probes, funnel, top-k) is piecewise constant, so a lane's exact score
    w_cosine * strength[slot] * <f_hat[slot], qn> + const is linear in qn
    where the slots do not change, with f_hat = row * rsqrt(|row|^2 +
    1e-12) as in kernel B's rerank: the gradient of the JAX package's XLA
    path (its exact rerank einsum; its Pallas kernel B has no VJP). The
    annex's Function (`ops/cuda/annex.py`) takes it."""
    slots = slots.long()
    hit = slots >= 0
    safe = slots.clamp(min=0)
    rows = features[safe]                                        # [B, n, D]
    # the plain version's order: the lane's multiplier and 1/|row| scale
    # g, then one batched product with the raw rows
    coef = g_s * (w_cosine * strength[safe])
    coef = coef * torch.rsqrt((rows * rows).sum(-1) + 1e-12)
    coef = torch.where(hit, coef, 0.0)
    return torch.einsum("bk,bkd->bd", coef, rows)


def ivf_candidates(clustered: torch.Tensor, aux: torch.Tensor,
                   qn: torch.Tensor, top_c: torch.Tensor, kk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """clustered [K, C, D] bf16; aux [K, 8, C] f32; qn [B, D] f32
    L2-normalised; top_c [B, P]; kk a multiple of 128, at most P*C and
    16384. Returns (scores [B, kk] f32, slots [B, kk] i32), sorted
    descending."""
    K, C, D = clustered.shape
    B, P = top_c.shape
    if not (0 < kk <= min(P * C, KK_MAX_CANDIDATES) and kk % KPAD == 0):
        raise ValueError(f"ivf_candidates: kk={kk} must be a multiple of "
                         f"{KPAD} in (0, min(P*C={P * C}, "
                         f"{KK_MAX_CANDIDATES})]")
    if not clustered.is_cuda:
        return ivf_candidates_plain(clustered, aux, qn, top_c, kk)
    qn, top_c = _ivf_args("ivf_candidates", clustered, aux, qn, top_c)
    # the coarse pass's scores, which the select pass reads
    scratch = _scratch(B, P, C, K, D, qn.device)
    out_s = torch.empty((B, kk), dtype=torch.float32, device=qn.device)
    out_slot = torch.empty((B, kk), dtype=torch.int32, device=qn.device)
    _candidates_launch(clustered, aux, qn, top_c, scratch, out_s, out_slot,
                       C, D, K, B, P, kk)
    return out_s, out_slot


def ivf_topk_scores(clustered: torch.Tensor, aux: torch.Tensor,
                    qn: torch.Tensor, top_c: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """clustered [K, C, D] bf16; aux [K, 8, C] f32; qn [B, D] f32
    L2-normalised; top_c [B, P]; 0 < k <= min(128, C). Returns
    (scores [B, P, 128] f32, slots [B, P, 128] i32); lanes < k hold each
    probe's top-k sorted descending. One launch, no scratch: a CTA scores
    its share of a probe's rows 128 at a time and keeps only their top-k
    keys in shared memory, so shared memory puts no bound on C; the keys'
    32-bit index does (P*C < 2^31)."""
    _, C, D = clustered.shape
    B, P = top_c.shape
    if not 0 < k <= min(KPAD, C):
        raise ValueError(f"ivf_topk_scores: k={k} must be in "
                         f"(0, min({KPAD}, C={C})]")
    if not clustered.is_cuda:
        return ivf_topk_scores_plain(clustered, aux, qn, top_c, k)
    qn, top_c = _ivf_args("ivf_topk_scores", clustered, aux, qn, top_c)
    out_s = torch.empty((B, P, KPAD), dtype=torch.float32, device=qn.device)
    out_slot = torch.empty((B, P, KPAD), dtype=torch.int32, device=qn.device)
    _topk_launch(clustered, aux, qn, top_c, out_s, out_slot, C, D, B, P, k)
    return out_s, out_slot
