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
`ivf_retrieve_fused_grad` is kernel B with a gradient into the queries
(plain PyTorch backward, on either device), which training needs.

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

import ctypes
from typing import Callable, Dict, Tuple

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


def _check(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous, 16-byte "
                             f"aligned and on one device")


def _ivf_args(name, clustered, aux, qn, top_c, features=None):
    """Checks the CUDA kernels' inputs; returns (qn f32, top_c i32), both
    contiguous. The keys carry the flat index p*C + c in 32 bits."""
    K, C, D = clustered.shape
    B, P = top_c.shape
    top_c = top_c.to(torch.int32).contiguous()
    qn = qn.float().contiguous()
    tensors = [clustered, qn, top_c]
    dtypes = [torch.bfloat16, torch.float32, torch.int32]
    if aux is not None:
        tensors.append(aux)
        dtypes.append(torch.float32)
    if features is not None:
        tensors.append(features)
        dtypes.append(torch.float32)
    _check(name, tensors, dtypes)
    if (D % 8 or qn.shape != (B, D) or P * C >= 2 ** 31
            or (aux is not None and aux.shape != (K, 8, C))
            or (features is not None and features.shape[1:] != (D,))):
        raise ValueError(
            f"{name}: clustered {tuple(clustered.shape)}, qn "
            f"{tuple(qn.shape)}, top_c {tuple(top_c.shape)}, aux "
            f"{None if aux is None else tuple(aux.shape)}, features "
            f"{None if features is None else tuple(features.shape)}")
    return qn, top_c


# each launcher's C arguments before the stream
_ARGTYPES = {
    "ivf_scan_scores": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4,
    "ivf_retrieve_fused": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_long] + [ctypes.c_int] * 5,
    "ivf_candidates": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6,
    "ivf_topk_scores": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
}
_bound: Dict[str, Callable[..., int]] = {}


def _bind(symbol: str, argtypes, restype):
    """The library's `symbol`, looked up and typed once per process."""
    fn = _bound.get(symbol)
    if fn is None:
        fn = getattr(_build.load("ivf_scan"), symbol)
        fn.argtypes, fn.restype = argtypes, restype
        _bound[symbol] = fn
    return fn


def _launch(name: str, *args) -> None:
    """Calls `<name>_launch` on the current stream."""
    fn = _bind(f"{name}_launch", _ARGTYPES[name] + [ctypes.c_void_p],
               ctypes.c_int)
    _build.check(fn(*args, _build.stream()), name)
    _build.launch_counts[name] += 1


def _workspace_words(B: int, P: int, K: int, D: int) -> int:
    """f32 words that B and D's coarse pass needs after the [B, P*C]
    scratch: 0 where it runs per pair, else the cluster-major pass's
    buckets, tiles and bf16 queries."""
    return _bind("ivf_coarse_workspace_words", [ctypes.c_int] * 4,
                 ctypes.c_long)(B, P, K, D)


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
    _launch("ivf_scan_scores", _build.ptr(clustered), _build.ptr(qn),
            _build.ptr(top_c), _build.ptr(out), C, D, B, P)
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
    _launch("ivf_retrieve_fused", _build.ptr(clustered), _build.ptr(aux),
            _build.ptr(features), _build.ptr(qn), _build.ptr(top_c),
            _build.ptr(scratch), _build.ptr(out_s), _build.ptr(out_slot), C,
            D, K, M, B, P, kk, k, KPAD)
    return out_s, out_slot


class _RetrieveFused(torch.autograd.Function):
    """Kernel B with a gradient into the queries. The selection (probes,
    funnel, top-k) is piecewise constant, so a lane's exact score
    w_cos * strength[slot] * <f_hat[slot], qn> + const is linear in qn
    where the slots do not change: d score / d qn = w_cos *
    strength[slot] * f_hat[slot], with f_hat = row * rsqrt(|row|^2 +
    1e-12) as in the kernel's rerank. This is the gradient of the JAX
    package's XLA path (its exact rerank einsum); its Pallas kernel B
    has no VJP."""

    @staticmethod
    def forward(ctx, qn, clustered, aux, features, strength, top_c, kk, k,
                w_cosine, fused):
        with torch.no_grad():
            s, sl = fused(clustered, aux, features, qn.detach(), top_c, kk,
                          k)
        ctx.mark_non_differentiable(sl)
        ctx.save_for_backward(features, strength, sl)
        ctx.k, ctx.w_cosine = k, w_cosine
        return s, sl

    @staticmethod
    def backward(ctx, g_s, g_sl):
        features, strength, sl = ctx.saved_tensors
        slots = sl[:, :ctx.k].long()                             # [B, k]
        hit = slots >= 0
        safe = slots.clamp(min=0)
        rows = features[safe]                                    # [B, k, D]
        # the plain version's order: the lane's multiplier and 1/|row|
        # scale g, then one batched product with the raw rows
        coef = g_s[:, :ctx.k] * (ctx.w_cosine * strength[safe])
        coef = coef * torch.rsqrt((rows * rows).sum(-1) + 1e-12)
        coef = torch.where(hit, coef, 0.0)
        g_qn = torch.einsum("bk,bkd->bd", coef, rows)
        return g_qn, None, None, None, None, None, None, None, None, None


def ivf_retrieve_fused_grad(clustered: torch.Tensor, aux: torch.Tensor,
                            features: torch.Tensor, strength: torch.Tensor,
                            w_cosine: float, qn: torch.Tensor,
                            top_c: torch.Tensor, kk: int, k: int,
                            fused: Callable = ivf_retrieve_fused
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fused(clustered, aux, features, qn, top_c, kk, k)` (kernel B, whose
    wrapper runs the plain version for CPU tensors) under no grad, with
    the exact score's gradient into `qn`: for each hit lane j < k,
    g[b, j] * w_cosine * strength[slot] * f_hat[slot] (`_RetrieveFused`).
    Misses (slot -1) and lanes >= k pass no gradient. strength [M] is
    the bank's per-slot strength; aux row 0 holds w_cosine times the same
    strength, as decayed at the cluster entry."""
    return _RetrieveFused.apply(qn, clustered, aux, features, strength,
                                top_c, kk, k, w_cosine, fused)


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
    _launch("ivf_candidates", _build.ptr(clustered), _build.ptr(aux),
            _build.ptr(qn), _build.ptr(top_c), _build.ptr(scratch),
            _build.ptr(out_s), _build.ptr(out_slot), C, D, K, B, P, kk)
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
    _launch("ivf_topk_scores", _build.ptr(clustered), _build.ptr(aux),
            _build.ptr(qn), _build.ptr(top_c), _build.ptr(out_s),
            _build.ptr(out_slot), C, D, B, P, k)
    return out_s, out_slot
