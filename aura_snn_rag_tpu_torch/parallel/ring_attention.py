"""Ring attention: exact attention over a sequence-sharded mesh axis
(counterpart of `aura_snn_rag_tpu/parallel/ring_attention.py`).

Each rank of the 'seq' axis holds one chunk of the sequence, [B, Lc, H,
Dh] of q, k and v, rank r the global positions [r * Lc, (r + 1) * Lc).
Over n steps the K/V chunks travel one `ppermute` hop around the ring;
at step j a rank holds the chunk of rank (r - j) mod n and folds it into
a running flash-style softmax state (max m, denominator l, numerator
acc, all f32), so no rank ever holds the whole sequence and the result
is softmax attention over it (K and V hop together, as one tensor).
Causality is enforced by global positions, and a chunk wholly in this
rank's future is skipped: the JAX package's `lax.cond(src > rank)` is a
Python branch here, exact because `src` and `rank` are host integers.

The products take the input dtype's values with f32 accumulation (JAX's
`preferred_element_type=f32`): the operands are widened to f32, where a
product of two bf16 values is exact.

The gradient is the one JAX's autodiff takes through the scan and the
hops, computed by an explicit backward ring (`_Ring`): an autograd graph
through the hops would leave a rank that skipped its future blocks
without the hops' backward, which the other ranks wait on. Each rank's
loss covers its own chunk, and the ranks' losses add up to the loss.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aura_snn_rag_tpu_torch.parallel.collectives import ppermute

NEG_INF = -1e30


def _hop(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else ppermute(x, group)


def _scores(qh, k_j, scale, causal, q_pos, k_pos):
    """[B, H, Lq, Lk] f32 scores of the queries against one K chunk, the
    future masked to NEG_INF."""
    s = torch.matmul(qh, k_j.permute(0, 2, 3, 1).float()) * scale
    if causal:
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
    return s


class _Ring(torch.autograd.Function):
    """The ring's forward fold and its backward as one autograd node, so
    the hops run in one order on every rank, whatever each rank skips.
    The backward is flash attention's: the softmax rebuilt from the saved
    log-sum-exp, dQ accumulated here, and each chunk's dK/dV travelling
    with it around the ring and home after n hops."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        B, Lq, H, Dh = q.shape
        dev = q.device
        q_pos = rank * Lq + torch.arange(Lq, device=dev)        # global
        qh = q.transpose(1, 2).float()                          # [B,H,Lq,Dh]
        m = torch.full((B, H, Lq), NEG_INF, device=dev)
        l = torch.zeros(B, H, Lq, device=dev)
        acc = torch.zeros(B, H, Lq, Dh, device=dev)
        kv = torch.stack([k, v])
        for j in range(n):
            src = (rank - j) % n                                # block owner
            if not (causal and src > rank):   # a future block: skipped
                k_pos = src * Lq + torch.arange(Lq, device=dev)
                s = _scores(qh, kv[0], scale, causal, q_pos, k_pos)
                m_new = torch.maximum(m, s.amax(dim=-1))        # [B,H,Lq]
                # rows no block has reached keep m = NEG_INF: guard the
                # NEG_INF - NEG_INF path
                alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
                alpha = torch.where(m <= NEG_INF / 2, 0.0, alpha)
                p = torch.exp(s - m_new[..., None])
                p = torch.where(s <= NEG_INF / 2, 0.0, p)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.matmul(
                    p.to(v.dtype).float(), kv[1].transpose(1, 2).float())
                m = m_new
            if j < n - 1:              # the last hop's blocks go unread
                kv = _hop(kv, group)
        # causal: every query row saw its own diagonal block, so l > 0
        out = acc / l[..., None]                                # [B,H,Lq,Dh]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        B, Lq, H, Dh = q.shape
        dev = q.device
        q_pos = rank * Lq + torch.arange(Lq, device=dev)
        qh = q.transpose(1, 2).float()
        do = dout.transpose(1, 2).float()                       # [B,H,Lq,Dh]
        delta = (do * out).sum(dim=-1)                          # [B,H,Lq]
        dq = torch.zeros_like(qh)
        kv = torch.stack([k, v])
        dkv = torch.zeros(2, B, H, Lq, Dh, device=dev)   # rides with kv
        for j in range(n):
            src = (rank - j) % n
            if not (causal and src > rank):
                k_pos = src * Lq + torch.arange(Lq, device=dev)
                kh = kv[0].transpose(1, 2).float()
                vh = kv[1].transpose(1, 2).float()
                s = _scores(qh, kv[0], scale, causal, q_pos, k_pos)
                p = torch.exp(s - lse[..., None])
                p = torch.where(s <= NEG_INF / 2, 0.0, p)       # [B,H,Lq,Lk]
                dkv[1] += torch.matmul(p.transpose(-1, -2), do)
                ds = p * (torch.matmul(do, vh.transpose(-1, -2))
                          - delta[..., None])
                dq += torch.matmul(ds, kh) * scale
                dkv[0] += torch.matmul(ds.transpose(-1, -2), qh) * scale
            if j < n - 1:
                kv = _hop(kv, group)
            dkv = _hop(dkv, group)     # n hops bring a chunk's home
        dk, dv = dkv.transpose(2, 3)                            # [B,Lk,H,Dh]
        return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's chunk of queries over the whole sequence,
    whose K/V chunks go around `group` (a 'seq' axis's process group; None
    for one chunk). q, k, v [B, Lc, H, Dh]; returns [B, Lc, H, Dh] in
    q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, group, causal, scale)


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mesh: DeviceMesh,
                               seq_axis: str = "seq",
                               batch_axes: Sequence[str] = ("data",),
                               head_axis: Optional[str] = None,
                               causal: bool = True) -> torch.Tensor:
    """Ring attention over `mesh`'s `seq_axis` on this rank's chunk: q, k,
    v [B, Lc, H, Dh] are this rank's rows of the batch (sharded over
    `batch_axes`), its chunk of the sequence, and its heads (sharded over
    `head_axis`, tensor parallelism). The ring is per-row, per-head math,
    so the batch and head shardings need no collective: they are named
    for the JAX signature's sake and checked against the mesh."""
    names = tuple(mesh.mesh_dim_names)
    for axis in (seq_axis, *batch_axes,
                 *(() if head_axis is None else (head_axis,))):
        if axis not in names:
            raise ValueError(f"mesh axes {names} lack {axis!r}")
    return ring_attention(q, k, v, mesh.get_group(seq_axis), causal)


def mesh_seq_axis(mesh, seq_axis: str = "seq") -> int:
    """Size of the mesh's sequence axis (1 = no sequence sharding)."""
    if mesh is None or seq_axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(seq_axis))
