"""The held experts of a mixture-of-experts layer: routing's answer
turned into one grouped product per projection, with no host sync and no
token dropped.

A layer holds `held` of the router's experts (ids offset .. offset +
held - 1, its share under expert parallelism). Each token picked k
experts (`top` [T, k], global ids) with weights `w` [T, k]; the layer's
output is, per token, the weighted sum of its picked experts' SwiGLU
outputs over the experts held here (the others' part lies on other
chips).

Two paths compute the same function:

- `held_experts_loop`: the plain version, one expert at a time over the
  tokens that picked it (boolean masks; the CPU path);
- `held_experts_grouped`: the card's. `dispatch_plan` lays every (token,
  pick) of a held expert into a row buffer grouped by expert, each group
  padded to `ALIGN` rows, from device tensors alone: the buffer has room
  for the most the picks can bring (T * min(k, held) rows and the
  padding), so nothing is dropped and nothing is read back. Then
  `torch._grouped_mm` runs each projection once over all held experts
  (gate and up as one [held, 2I, D] weight, then down), with the
  groups' ends `offs` on the device. The rows past the last group are
  never computed (their contents are undefined); every such row, and
  every padding row, points at one of `DUMP` extra output rows that are
  dropped (spread, so that their atomic adds do not queue on one row),
  and its weight is 0. The autograd Function recomputes the gathered rows
  and the first product in the backward rather than keep [R, .]
  buffers for it, and opens span `moe.experts_bwd` there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from aura_snn_rag_tpu_torch.utils.trace import span

ALIGN = 16                # rows a group is padded to
DUMP = 512                # dropped output rows the unused rows add into


class Plan(NamedTuple):
    src: torch.Tensor      # [R] token of each row (0 for unused rows)
    dest: torch.Tensor     # [R] token the row's output adds to (>= T: none)
    pos: torch.Tensor      # [T * k] row of each (token, pick); R if not held
    offs: torch.Tensor     # [held] int32 end row of each expert's group


def capacity(T: int, k: int, held: int) -> int:
    """Rows of the buffer: every pick of a held expert, and each group's
    padding."""
    return T * min(k, held) + held * (ALIGN - 1)


def dispatch_plan(top: torch.Tensor, held: int, offset: int) -> Plan:
    """Where each (token, pick) of a held expert goes in the grouped row
    buffer, computed on the device (no host sync): the rank of a pick
    among its expert's picks is a running count over the flattened picks
    (a scan per expert along the picks, the contiguous dimension), so
    rows keep token order within a group."""
    T, k = top.shape
    dev = top.device
    R = capacity(T, k, held)
    local = top.reshape(-1) - offset
    lid = torch.where((local >= 0) & (local < held), local,
                      torch.full_like(local, held))           # held: none
    onehot = torch.arange(held + 1, device=dev)[:, None] == lid[None, :]
    run = onehot.cumsum(1, dtype=torch.int32)                 # [h+1, T * k]
    rank = run.gather(0, lid[None, :])[0].long() - 1
    counts = run[:held, -1].long()
    padded = (counts + ALIGN - 1) // ALIGN * ALIGN
    ends = padded.cumsum(0)
    starts = ends - padded
    pos = torch.where(lid < held, starts[lid.clamp(max=held - 1)] + rank,
                      torch.full_like(lid, R))
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    src = torch.zeros(R + 1, dtype=torch.long, device=dev)
    dest = T + torch.arange(R + 1, device=dev) % DUMP
    src[pos] = tok               # picks of other experts land on row R
    dest[pos] = tok
    return Plan(src[:R], dest[:R], pos, ends.to(torch.int32))


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    g, u = h.chunk(2, dim=-1)
    return F.silu(g) * u


class _HeldExperts(torch.autograd.Function):
    """y [T, D] = sum over rows r with dest[r] = t of wt[r] * SwiGLU_e(x[src
    [r]]) (e the row's group), through `torch._grouped_mm`; x and the
    weights in the compute dtype (bf16), the sum in f32."""

    @staticmethod
    def forward(ctx, x, w13, w2, wt, src, dest, offs):
        T, D = x.shape
        with span("moe.experts"):
            h = torch._grouped_mm(x[src], w13.transpose(1, 2), offs=offs)
            o = torch._grouped_mm(_swiglu(h), w2.transpose(1, 2), offs=offs)
            del h
        with span("moe.combine"):
            y = torch.zeros(T + DUMP, D, dtype=torch.float32,
                            device=x.device)
            y.index_add_(0, dest, o.float() * wt[:, None])
        ctx.save_for_backward(x, w13, w2, wt, src, dest, offs)
        return y[:T].to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, w13, w2, wt, src, dest, offs = ctx.saved_tensors
        T, D = x.shape
        dt = x.dtype
        with span("moe.experts_bwd"):
            xs = x[src]
            h = torch._grouped_mm(xs, w13.transpose(1, 2), offs=offs)
            g, u = h.chunk(2, dim=-1)
            silu = F.silu(g)
            a = silu * u
            # the rows' output gradient before the weight (0 past T)
            gyr = F.pad(gy.to(dt), (0, 0, 0, DUMP))[dest]
            ga0 = torch._grouped_mm(gyr, w2, offs=offs)          # [R, I]
            live = dest < T
            gwt = torch.where(live, (a.float() * ga0.float()).sum(-1), 0.0)
            go = (gyr.float() * wt[:, None]).to(dt)
            gw2 = torch._grouped_mm(go.t(), a, offs=offs)         # [E, D, I]
            ga = (ga0.float() * wt[:, None]).to(dt)
            dh = torch.cat([torch.ops.aten.silu_backward(ga * u, g),
                            ga * silu], dim=-1)
            gw13 = torch._grouped_mm(dh.t(), xs, offs=offs)       # [E, 2I, D]
            gxs = torch._grouped_mm(dh, w13, offs=offs)           # [R, D]
            gx = torch.zeros(T + DUMP, D, dtype=torch.float32,
                             device=x.device)
            gx.index_add_(0, dest, gxs.float())
        return gx[:T].to(dt), gw13, gw2, gwt, None, None, None


def held_experts_grouped(x: torch.Tensor, w13: torch.Tensor,
                         w2: torch.Tensor, top: torch.Tensor,
                         w: torch.Tensor, offset: int) -> torch.Tensor:
    """x [T, D] (bf16), w13 [held, 2I, D] (gate rows, then up rows), w2
    [held, D, I] (bf16), top [T, k] the picked experts' global ids, w
    [T, k] f32 their weights: the held experts' part of the layer's
    output [T, D], in x's dtype."""
    held = w13.shape[0]
    with span("moe.dispatch"):
        plan = dispatch_plan(top, held, offset)
        R = plan.src.shape[0]
        wt = torch.zeros(R + 1, dtype=w.dtype, device=w.device).index_put(
            (plan.pos,), w.reshape(-1))[:R]
    return _HeldExperts.apply(x, w13, w2, wt, plan.src, plan.dest,
                              plan.offs)


def held_experts_loop(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                      top: torch.Tensor, w: torch.Tensor,
                      offset: int) -> torch.Tensor:
    """The plain version of `held_experts_grouped`: each held expert in
    turn on the tokens that picked it (their weight for it), summed in
    f32."""
    T, D = x.shape
    y = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for e in range(w13.shape[0]):
        pick = top == offset + e                                  # [T, k]
        tok = pick.any(dim=-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        h = F.linear(_swiglu(F.linear(x[tok], w13[e])), w2[e])
        wt = (w * pick).sum(dim=-1)[tok]
        y = y.index_add(0, tok, h.float() * wt[:, None])
    return y.to(x.dtype)
