"""Kimi Delta Attention's chunked core: the passes of `ops/kda.py`'s card
path, each with its plain version.

The JAX package has no linear attention, so no Pallas kernel is replaced.
Chunks hold C = 64 positions and heads K = 128 key and value channels
(the published widths; the plain versions take any). Inputs are f32 and
contiguous, with `n` = heads x chunks.

- `intra_fwd(q, k, G, beta)`: the intra-chunk matrices A [n, C, C]
  (b_t sum_c k_t k_i exp(G_t - G_i), i < t) and P (sum_c q_t k_i exp(G_t
  - G_i), i <= t) of q, k, G [n, C, K] and beta [n, C]; each exponent
  taken pairwise, so none is positive;
- `intra_bwd(q, k, G, beta, dA, dP)`: (dq, dk, dG, dbeta);
- `state_fwd(W, Ubar, Khat, D)`: the state carried over the chunks of
  each head (W, Ubar, Khat [heads, chunks, C, K], D [heads, chunks, K]):
  h_0 = 0, U_n = Ubar_n - W_n h_n, h_{n+1} = D_n h_n + Khat_n^T U_n;
  returns (h [heads, chunks, K, K] at each chunk's start, U);
- `state_bwd(dh, dU_ext, W, Khat, D)`: the reverse walk; returns (dS
  [heads, chunks, K, K], the gradient of each chunk's end state, dU).

CUDA tensors launch `csrc/kda.cu` (design and bound in its note); CPU
tensors run the plain versions, the kernels' oracle. The state passes
read their inputs but `D` 16 bytes at a time: those must start 16-byte
aligned (`aligned16` copies one that does not).
"""

from __future__ import annotations

from typing import Tuple

import torch

from aura_snn_rag_tpu_torch.ops.cuda import _build

CHUNK = 64          # positions a chunk (the kernels' C)
WIDTH = 128         # channels a head (the kernels' K)

_F32 = torch.float32

_intra_fwd = _build.Entry("kda", "kda_intra_fwd_launch", "pppppp l")
_intra_bwd = _build.Entry("kda", "kda_intra_bwd_launch", "pppppppppp l")
_state_fwd = _build.Entry("kda", "kda_state_fwd_launch", "pppppp i i")
_state_bwd = _build.Entry("kda", "kda_state_bwd_launch", "ppppppp i i")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it that starts 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pairs(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(E [..., C, C, K] = exp(G_t - G_i) where i <= t, else 0; the masks
    i <= t and i < t [C, C])."""
    C = G.shape[-2]
    idx = torch.arange(C, device=G.device)
    incl = idx[:, None] >= idx[None, :]
    strict = idx[:, None] > idx[None, :]
    diff = G[..., :, None, :] - G[..., None, :, :]
    E = torch.where(incl[..., None], torch.exp(torch.where(
        incl[..., None], diff, torch.zeros((), device=G.device))), 0.0)
    return E, incl, strict


def intra_fwd_plain(q, k, G, beta):
    E, incl, strict = _pairs(G)
    kk = torch.einsum("ntc,nic,ntic->nti", k, k, E)
    A = torch.where(strict, beta[..., :, None] * kk, 0.0)
    P = torch.einsum("ntc,nic,ntic->nti", q, k, E)
    return A, P


def intra_bwd_plain(q, k, G, beta, dA, dP):
    E, incl, strict = _pairs(G)
    dA = torch.where(strict, dA, 0.0)
    dP = torch.where(incl, dP, 0.0)
    dq = torch.einsum("nti,nic,ntic->ntc", dP, k, E)
    R = torch.einsum("nti,nic,ntic->ntc", dA, k, E)
    col = (torch.einsum("nti,ntc,ntic->nic", dP, q, E)
           + torch.einsum("nti,ntc,ntic->nic", dA * beta[..., :, None], k,
                          E))
    kr = beta[..., None] * R
    return dq, kr + col, q * dq + k * kr - k * col, (k * R).sum(-1)


def state_fwd_plain(W, Ubar, Khat, D):
    heads, chunks, C, Kk = W.shape
    s = W.new_zeros(heads, Kk, Ubar.shape[-1])
    h, U = [], []
    for n in range(chunks):
        h.append(s)
        u = Ubar[:, n] - W[:, n] @ s
        U.append(u)
        s = D[:, n, :, None] * s + Khat[:, n].transpose(-1, -2) @ u
    return torch.stack(h, 1), torch.stack(U, 1)


def state_bwd_plain(dh, dU_ext, W, Khat, D):
    heads, chunks = W.shape[:2]
    s = dh.new_zeros(dh[:, 0].shape)
    dS, dU = [None] * chunks, [None] * chunks
    for n in reversed(range(chunks)):
        dS[n] = s
        du = dU_ext[:, n] + Khat[:, n] @ s
        dU[n] = du
        s = dh[:, n] + D[:, n, :, None] * s - W[:, n].transpose(-1, -2) @ du
    return torch.stack(dS, 1), torch.stack(dU, 1)


def _check(name, shapes_ok, *tensors, aligned=0):
    _build.check_inputs(name, *((t, _F32) for t in tensors),
                        aligned=aligned)
    if not shapes_ok:
        raise ValueError(f"{name}: shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    if tensors[0].is_cuda and tensors[0].shape[-1] != WIDTH:
        raise ValueError(f"{name}: the kernel takes heads of {WIDTH} "
                         f"channels, got {tensors[0].shape[-1]}")


def _chunks_ok(x):
    return x.dim() == 3 and (not x.is_cuda or x.shape[1] == CHUNK)


def intra_fwd(q, k, G, beta):
    """(A, P) [n, C, C] of q, k, G [n, C, K] and beta [n, C]."""
    _check("kda_intra_fwd", q.shape == k.shape == G.shape
           and beta.shape == q.shape[:2] and _chunks_ok(q), q, k, G, beta)
    if not q.is_cuda:
        return intra_fwd_plain(q, k, G, beta)
    n, C, _ = q.shape
    A = torch.empty(n, C, C, dtype=_F32, device=q.device)
    P = torch.empty_like(A)
    _intra_fwd(q, k, G, beta, A, P, n)
    return A, P


def intra_bwd(q, k, G, beta, dA, dP):
    """(dq, dk, dG [n, C, K], dbeta [n, C]) from dA, dP [n, C, C]."""
    n, C = q.shape[:2]
    _check("kda_intra_bwd", q.shape == k.shape == G.shape
           and beta.shape == (n, C) and dA.shape == dP.shape == (n, C, C)
           and _chunks_ok(q), q, k, G, beta, dA, dP)
    if not q.is_cuda:
        return intra_bwd_plain(q, k, G, beta, dA, dP)
    dq, dk, dG = (torch.empty_like(q) for _ in range(3))
    dbeta = torch.empty_like(beta)
    _intra_bwd(q, k, G, beta, dA, dP, dq, dk, dG, dbeta, n)
    return dq, dk, dG, dbeta


def _state_ok(W, D, *rows):
    return (W.dim() == 4 and all(t.shape == W.shape for t in rows)
            and D.shape == W.shape[:2] + W.shape[3:]
            and (not W.is_cuda or W.shape[2] == CHUNK))


def state_fwd(W, Ubar, Khat, D):
    """(h [heads, chunks, K, K], U [heads, chunks, C, K])."""
    _check("kda_state_fwd", _state_ok(W, D, Ubar, Khat), W, Ubar, Khat, D,
           aligned=3)
    if not W.is_cuda:
        return state_fwd_plain(W, Ubar, Khat, D)
    heads, chunks, _, Kk = W.shape
    h = torch.empty(heads, chunks, Kk, Kk, dtype=_F32, device=W.device)
    U = torch.empty_like(Ubar)
    _state_fwd(W, Ubar, Khat, D, h, U, heads, chunks)
    return h, U


def state_bwd(dh, dU_ext, W, Khat, D):
    """(dS [heads, chunks, K, K], dU [heads, chunks, C, K])."""
    heads, chunks, _, Kk = W.shape
    _check("kda_state_bwd", _state_ok(W, D, dU_ext, Khat)
           and dh.shape == (heads, chunks, Kk, Kk), dh, dU_ext, W, Khat, D,
           aligned=4)
    if not W.is_cuda:
        return state_bwd_plain(dh, dU_ext, W, Khat, D)
    dS = torch.empty_like(dh)
    dU = torch.empty_like(dU_ext)
    _state_bwd(dh, dU_ext, W, Khat, D, dS, dU, heads, chunks)
    return dS, dU
