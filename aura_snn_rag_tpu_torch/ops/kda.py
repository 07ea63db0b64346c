"""Kimi Delta Attention's core: the gated delta rule with a decay per key
channel, from (q, k, v, g, beta) to o.

Per head, with S_0 = 0 ([K, V]):
  S_t = (I - b_t k_t k_t^T) Diag(exp g_t) S_{t-1} + b_t k_t v_t^T,
  o_t = S_t^T q_t,
for q, k [B, T, H, K], v [B, T, H, V], the log decay g [B, T, H, K]
(<= 0, f32) and b = beta [B, T, H] (f32). Returns o [B, T, H, V] f32.
The JAX package has no counterpart: this is DeepSeek-style MLA's sibling
in Kimi-Linear's hybrid block (`models/layers.KimiDeltaAttention`).

Both paths take chunks of C = 64 positions. Inside a chunk, with G the
running sum of g (f32) and E_ti = exp(G_t - G_i) per channel:
  A_ti = b_t sum_c k_t k_i E_ti (i < t),  P_ti = sum_c q_t k_i E_ti
  (i <= t),
  W = (I + A)^-1 diag(b) (k exp G),  Ubar = (I + A)^-1 diag(b) v (the WY
  form; the inverse from a unit-triangular solve, in f32);
and from chunk to chunk, with h_n the state at chunk n's start:
  U_n = Ubar_n - W_n h_n,  o_n = (q exp G) h_n + P_n U_n,
  h_{n+1} = Diag(exp G_last) h_n + (k exp(G_last - G))^T U_n.
Every exponent is <= 0: E is taken pairwise, exp G and exp(G_last - G)
decay forward from a point inside the chunk. No factor exp(-G) of the
running sum appears, which at the published gate (up to ~16 nats a token
a channel) overflows f32 within a chunk.

- CPU tensors (`kda_chunk_loop`, counter `path.kda_loop`): plain torch,
  a Python loop over the chunks carrying the state, autograd through it.
  It is the card path's oracle, and the tests hold it to the token-by-
  token recurrence (`reference/kimi_linear.kda_recurrence`).
- CUDA tensors (`kda_chunked`, counter `path.kda_chunked`): every chunk
  at once. The pairwise matrices A, P and their gradients are
  `ops/cuda/kda.py`'s `intra_fwd`/`intra_bwd`; the solve and the
  products are batched PyTorch in f32; the carry from chunk to chunk is
  `state_fwd`, and in the backward `state_bwd` in reverse. No loop over
  chunks: a layer launches the same kernels at any T. One
  `autograd.Function` saves q, k, v, g and beta (as the published
  chunked kernels do) and recomputes the rest in its backward, inside
  span `kda.core_bwd`; its forward runs in span `kda.core`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aura_snn_rag_tpu_torch.ops.cuda import kda as kernels
from aura_snn_rag_tpu_torch.utils.trace import count, span

CHUNK = kernels.CHUNK


def _chunked_inputs(q, k, v, g, beta, C):
    """[B*H, n, C, .] f32 chunks of each input (beta [B*H, n, C]), T padded
    to a multiple of C with zeros (no key, value, decay or write)."""
    B, T, H, _ = q.shape
    pad = -T % C

    def heads(t):
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.transpose(1, 2)                      # [B, H, Tp, ...]
        return t.reshape(B * H, (T + pad) // C, C, *t.shape[3:]) \
            .contiguous()

    return (heads(q), heads(k), heads(v), heads(g),
            heads(beta.unsqueeze(-1))[..., 0].contiguous())


def _unchunk(o, B, T, H):
    return o.reshape(B, H, -1, o.shape[-1])[:, :, :T].transpose(1, 2)


def _solve(A, beta, kg, v):
    """(W, Ubar) = T diag(beta) kg, T diag(beta) v with T = (I + A)^-1, the
    inverse of a unit lower triangle, solved for the identity (C right-
    hand sides, not the 2K of [kg | v])."""
    eye = torch.eye(A.shape[-1], device=A.device)
    T = torch.linalg.solve_triangular(eye + A, eye.expand_as(A),
                                      upper=False, unitriangular=True)
    return T @ (beta[..., None] * kg), T @ (beta[..., None] * v)


def kda_chunk_loop(q, k, v, g, beta, chunk: int = CHUNK):
    """The chunked form with a Python loop over the chunks (the CPU path),
    differentiable by autograd."""
    B, T, H, _ = q.shape
    q, k, v, g, beta = _chunked_inputs(q, k, v, g, beta, chunk)
    S = q.new_zeros(q.shape[0], q.shape[-1], v.shape[-1])
    out = []
    for n in range(q.shape[1]):
        qn, kn, vn, bn = q[:, n], k[:, n], v[:, n], beta[:, n]
        G = g[:, n].cumsum(-2)
        A, P = kernels.intra_fwd_plain(qn, kn, G, bn)
        W, Ubar = _solve(A, bn, kn * torch.exp(G), vn)
        U = Ubar - W @ S
        out.append((qn * torch.exp(G)) @ S + P @ U)
        last = G[:, -1:]
        S = torch.exp(last).transpose(-1, -2) * S \
            + (kn * torch.exp(last - G)).transpose(-1, -2) @ U
    return _unchunk(torch.stack(out, 1), B, T, H)


class _Intra(torch.autograd.Function):
    """(A, P) of chunked q, k, G, beta: `kernels.intra_fwd`, backward
    `kernels.intra_bwd`."""

    @staticmethod
    def forward(ctx, q, k, G, beta):
        ctx.save_for_backward(q, k, G, beta)
        C, Kk = q.shape[-2:]
        flat = [t.reshape(-1, C, Kk) for t in (q, k, G)]
        A, P = kernels.intra_fwd(*flat, beta.reshape(-1, C))
        return A.view(*q.shape[:-1], C), P.view(*q.shape[:-1], C)

    @staticmethod
    def backward(ctx, dA, dP):
        q, k, G, beta = ctx.saved_tensors
        C, Kk = q.shape[-2:]
        flat = [t.reshape(-1, C, Kk) for t in (q, k, G)]
        zero = q.new_zeros(*q.shape[:-1], C)
        dA = (zero if dA is None else dA).reshape(-1, C, C).contiguous()
        dP = (zero if dP is None else dP).reshape(-1, C, C).contiguous()
        dq, dk, dG, db = kernels.intra_bwd(*flat, beta.reshape(-1, C), dA,
                                           dP)
        return (dq.view_as(q), dk.view_as(k), dG.view_as(G),
                db.view_as(beta))


class _State(torch.autograd.Function):
    """(h, U) of W, Ubar, Khat, D: `kernels.state_fwd`; backward
    `kernels.state_bwd` and the products that follow from its dS."""

    @staticmethod
    def forward(ctx, W, Ubar, Khat, D):
        h, U = kernels.state_fwd(W, Ubar, Khat, D)
        ctx.save_for_backward(W, Khat, D, h, U)
        return h, U

    @staticmethod
    def backward(ctx, dh, dU_ext):
        W, Khat, D, h, U = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None \
            else kernels.aligned16(dh.contiguous())
        dU_ext = torch.zeros_like(U) if dU_ext is None \
            else kernels.aligned16(dU_ext.contiguous())
        dS, dU = kernels.state_bwd(dh, dU_ext, W, Khat, D)
        return (-(dU @ h.transpose(-1, -2)), dU,
                U @ dS.transpose(-1, -2), (h * dS).sum(-1))


def _chunked(q, k, v, g, beta):
    """The card path's graph over chunked inputs [B*H, n, C, .] (f32)."""
    G = g.cumsum(-2)
    A, P = _Intra.apply(q, k, G, beta)
    W, Ubar = _solve(A, beta, k * torch.exp(G), v)
    last = G[..., -1:, :]
    h, U = _State.apply(*(kernels.aligned16(t.contiguous()) for t in (
        W, Ubar, k * torch.exp(last - G))),
        torch.exp(last[..., 0, :]).contiguous())
    return (q * torch.exp(G)) @ h + P @ U


class _KDAChunked(torch.autograd.Function):
    """The card path: forward without a graph, saving only its inputs;
    the backward recomputes the graph and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta):
        ctx.save_for_backward(q, k, v, g, beta)
        B, T, H, _ = q.shape
        with span("kda.core"):
            o = _chunked(*_chunked_inputs(q, k, v, g, beta, CHUNK))
            return _unchunk(o, B, T, H)

    @staticmethod
    def backward(ctx, do):
        with span("kda.core_bwd"):
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            B, T, H, _ = leaves[0].shape
            with torch.enable_grad():
                o = _unchunk(_chunked(*_chunked_inputs(*leaves, CHUNK)),
                             B, T, H)
            return torch.autograd.grad(o, leaves, do)


def kda_chunked(q, k, v, g, beta):
    """Every chunk at once (the card path); on CPU tensors it runs the
    passes' plain versions."""
    return _KDAChunked.apply(q, k, v, g, beta)


def kda(q, k, v, g, beta):
    """The core on the path for the tensors' device: `kda_chunked` on the
    card (counter `path.kda_chunked`), `kda_chunk_loop` on the CPU
    (`path.kda_loop`)."""
    if q.is_cuda:
        count("path.kda_chunked")
        return kda_chunked(q, k, v, g, beta)
    count("path.kda_loop")
    with span("kda.core"):
        return kda_chunk_loop(q, k, v, g, beta)
