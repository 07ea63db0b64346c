"""Kernels B and C: the IVF probe scan (counterpart of
`aura_snn_rag_tpu/ops/pallas/ivf_scan.py`).

- `ivf_scan_scores` (kernel C, replaces the v1 TPU kernel at
  aura_snn_rag_tpu/ops/pallas/ivf_scan.py:550): bf16 cosines of each query
  against its P probed [C, D] cluster blocks -> [B, P, C] f32.
- `ivf_retrieve_fused` (kernel B, replaces the v3r TPU kernel at
  aura_snn_rag_tpu/ops/pallas/ivf_scan.py:317): coarse score
  aux0 * cos + aux1, exact top-kk across probes (ties to the lowest flat
  index p*C + c; dead lanes at -1e30), exact f32 rerank of the kk raw bank
  rows, final top-k.

Both launch `csrc/ivf_scan.cu` for CUDA tensors (bound and design in its
header) and run the `_plain` versions below for CPU tensors.

Output convention of `ivf_retrieve_fused`: lanes < k hold the final top-k
sorted by exact score (ties to the lower funnel lane); a lane without a
live candidate, and every lane >= k, holds score -1e30 and slot -1.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from aura_snn_rag_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
DEAD = -5e29                # coarse or exact scores at or below are dead
KPAD = 128                  # output width of ivf_retrieve_fused


def ivf_scan_scores_plain(clustered: torch.Tensor, qn: torch.Tensor,
                          top_c: torch.Tensor) -> torch.Tensor:
    """Kernel C in PyTorch: [B, P, C] f32 cosines, bf16 operands."""
    blocks = clustered[top_c.long()].float()                 # [B, P, C, D]
    q16 = qn.to(torch.bfloat16).float()
    return torch.einsum("bpcd,bd->bpc", blocks, q16)


def ivf_retrieve_fused_plain(clustered: torch.Tensor, aux: torch.Tensor,
                             features: torch.Tensor, qn: torch.Tensor,
                             top_c: torch.Tensor, kk: int, k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B in PyTorch. Stable sorts reproduce both tie rules."""
    B, P = top_c.shape
    C = clustered.shape[1]
    M = features.shape[0]
    cos = ivf_scan_scores_plain(clustered, qn, top_c)        # [B, P, C]
    a = aux[top_c.long()]                                    # [B, P, 8, C]
    a0, a1, sl = (a[:, :, i].reshape(B, P * C) for i in range(3))
    coarse = a0 * cos.reshape(B, P * C) + a1
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


def _check(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous, 16-byte "
                             f"aligned and on one device")


def ivf_scan_scores(clustered: torch.Tensor, qn: torch.Tensor,
                    top_c: torch.Tensor) -> torch.Tensor:
    """clustered [K, C, D] bf16, qn [B, D] f32 (cast to bf16 inside),
    top_c [B, P] probed cluster ids -> cosines [B, P, C] f32."""
    if not clustered.is_cuda:
        return ivf_scan_scores_plain(clustered, qn, top_c)
    K, C, D = clustered.shape
    B, P = top_c.shape
    top_c = top_c.to(torch.int32).contiguous()
    qn = qn.float().contiguous()
    _check("ivf_scan_scores", [clustered, qn, top_c],
           [torch.bfloat16, torch.float32, torch.int32])
    if D % 8 or qn.shape != (B, D):
        raise ValueError(f"ivf_scan_scores: D={D}, qn {tuple(qn.shape)}")
    out = torch.empty((B, P, C), dtype=torch.float32, device=qn.device)
    fn = _build.load("ivf_scan").ivf_scan_scores_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(clustered), _build.ptr(qn), _build.ptr(top_c),
            _build.ptr(out), C, D, B, P, _build.stream())
    _build.check(rc, "ivf_scan_scores")
    _build.launch_counts["ivf_scan_scores"] += 1
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
    if not (0 < kk <= P * C and kk <= 4096 and 0 < k <= min(kk, KPAD)):
        raise ValueError(f"ivf_retrieve_fused: kk={kk}, k={k}, P*C={P * C}")
    if not clustered.is_cuda:
        return ivf_retrieve_fused_plain(clustered, aux, features, qn, top_c,
                                        kk, k)
    M = features.shape[0]
    top_c = top_c.to(torch.int32).contiguous()
    qn = qn.float().contiguous()
    _check("ivf_retrieve_fused", [clustered, aux, features, qn, top_c],
           [torch.bfloat16, torch.float32, torch.float32, torch.float32,
            torch.int32])
    if (D % 8 or aux.shape != (K, 8, C) or features.shape != (M, D)
            or qn.shape != (B, D)):
        raise ValueError("ivf_retrieve_fused: shapes "
                         f"{tuple(aux.shape)} {tuple(features.shape)} "
                         f"{tuple(qn.shape)} for D={D}")
    scratch = torch.empty((B, P * C), dtype=torch.float32, device=qn.device)
    out_s = torch.empty((B, KPAD), dtype=torch.float32, device=qn.device)
    out_slot = torch.empty((B, KPAD), dtype=torch.int32, device=qn.device)
    fn = _build.load("ivf_scan").ivf_retrieve_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_long]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(clustered), _build.ptr(aux), _build.ptr(features),
            _build.ptr(qn), _build.ptr(top_c), _build.ptr(scratch),
            _build.ptr(out_s), _build.ptr(out_slot), C, D, M, B, P, kk, k,
            KPAD, _build.stream())
    _build.check(rc, "ivf_retrieve_fused")
    _build.launch_counts["ivf_retrieve_fused"] += 1
    return out_s, out_slot
