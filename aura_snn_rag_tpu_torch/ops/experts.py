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
  padding), so nothing is dropped and nothing is read back. Routing
  fills about held / n_routed_experts of it. `torch._grouped_mm` runs
  each projection once over all held experts (gate and up as one [held,
  2I, D] weight, then down), with the groups' ends `offs` on the device;
  the passes around the products (the rows' gather, the SwiGLU, the
  weighted combine and their gradients) are hand-written kernels
  (`ops/cuda/csrc/experts.cu`) that read the groups' end `offs[-1]` on
  the device as well. So every pass touches only the filled rows: the
  rows from the end up to the buffer's size are allocated and never read
  or written. A padding row gathers zeros and carries weight 0, so it
  adds nothing to any gradient. The combine gathers, for each token, the
  rows of its picks held here (`pos`) and sums them weighted in f32 in
  pick order: no atomics, one fixed order. The autograd Function
  recomputes the gathered rows and the first product in the backward
  rather than keep [R, .] buffers for it, and opens span
  `moe.experts_bwd` there.

Each pass has a plain PyTorch version here (`*_plain`), bounded by the
same end (read on the host): CPU tensors take it, CUDA tensors launch the
kernel (counted in `ops.cuda.launch_counts`) or raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aura_snn_rag_tpu_torch.ops.cuda import _build
from aura_snn_rag_tpu_torch.utils.trace import span

ALIGN = 16                # rows a group is padded to
MAX_PICKS = 32            # k the combine kernel takes (a lane a pick)


class Plan(NamedTuple):
    src: torch.Tensor      # [R] pick t * k + p of each row; -1: none
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
    src = torch.full((R + 1,), -1, dtype=torch.long, device=dev)
    src[pos] = torch.arange(T * k, device=dev)   # other experts' on row R
    return Plan(src[:R], pos, ends.to(torch.int32))


def _rows(R: int, width: int, like: torch.Tensor) -> torch.Tensor:
    """An [R, width] row buffer in `like`'s dtype, left unset: only its
    filled rows are ever written."""
    return torch.empty(R, width, dtype=like.dtype, device=like.device)


def _end(offs: torch.Tensor) -> int:
    """The groups' end, read on the host (the plain versions)."""
    return int(offs[-1])


def gather_rows_plain(x: torch.Tensor, src: torch.Tensor,
                      offs: torch.Tensor, k: int) -> torch.Tensor:
    """xs [R, D]: row r < end holds x[src[r] // k] (zeros for padding)."""
    n = _end(offs)
    xs = _rows(src.shape[0], x.shape[1], x)
    s = src[:n]
    xs[:n] = torch.where((s >= 0)[:, None], x[s.clamp(min=0) // k], 0)
    return xs


def swiglu_plain(h: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """a [R, I]: silu(g) * u of the rows r < end of h = [g | u], in f32,
    rounded once."""
    n = _end(offs)
    a = _rows(h.shape[0], h.shape[1] // 2, h)
    g, u = h[:n].float().chunk(2, dim=-1)
    a[:n] = (F.silu(g) * u).to(h.dtype)
    return a


def combine_plain(rows: torch.Tensor, w: Optional[torch.Tensor],
                  pos: torch.Tensor, offs: torch.Tensor,
                  T: int) -> torch.Tensor:
    """y [T, D] in rows' dtype: for each token the sum over its picks p
    held here (pos < end) of w[t, p] * rows[pos[t * k + p]] (w None:
    unweighted), in f32 in pick order."""
    n = _end(offs)
    k = pos.numel() // T
    sel = (pos < n).nonzero()[:, 0]
    part = torch.zeros(T * k, rows.shape[1], dtype=torch.float32,
                       device=rows.device)
    v = rows[pos[sel]].float()
    part[sel] = v if w is None else v * w.reshape(-1)[sel, None]
    part = part.view(T, k, -1)
    y = torch.zeros(T, rows.shape[1], dtype=torch.float32,
                    device=rows.device)
    for p in range(k):
        y += part[:, p]
    return y.to(rows.dtype)


def grad_gather_plain(gy: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
                      offs: torch.Tensor, k: int):
    """(gyr, go) [R, D]: row r < end holds gy[src[r] // k] and w[src[r]]
    times it (zeros for padding)."""
    n = _end(offs)
    R, D = src.shape[0], gy.shape[1]
    gyr, go = _rows(R, D, gy), _rows(R, D, gy)
    s = src[:n]
    live = s >= 0
    q = s.clamp(min=0)
    g = torch.where(live[:, None], gy[q // k], 0)
    gyr[:n] = g
    wt = torch.where(live, w.reshape(-1)[q], 0.0)
    go[:n] = (g.float() * wt[:, None]).to(gy.dtype)
    return gyr, go


def swiglu_bwd_plain(h: torch.Tensor, ga0: torch.Tensor, w: torch.Tensor,
                     src: torch.Tensor, offs: torch.Tensor):
    """From h = [g | u] and ga0 (the gradient into a before the row's
    weight wt) at the rows r < end: (a [R, I] as the forward rounded it,
    dh [R, 2I] = [ga * u * silu'(g) | ga * silu(g)] with ga = wt * ga0,
    gw [T, k] f32 with gw[src[r]] = sum_i a * ga0 and 0 at picks not held
    here)."""
    n = _end(offs)
    R, I = h.shape[0], h.shape[1] // 2
    a, dh = _rows(R, I, h), _rows(R, 2 * I, h)
    gw = torch.zeros(w.numel(), dtype=torch.float32, device=w.device)
    g, u = h[:n].float().chunk(2, dim=-1)
    s = src[:n]
    live = s >= 0
    q = s.clamp(min=0)
    wt = torch.where(live, w.reshape(-1)[q], 0.0)
    sg = torch.sigmoid(g)
    silu = g * sg
    ab = (silu * u).to(h.dtype)
    ga0f = ga0[:n].float()
    ga = ga0f * wt[:, None]
    a[:n] = ab
    dh[:n] = torch.cat([ga * u * (sg * (1 + g * (1 - sg))), ga * silu],
                       dim=-1).to(h.dtype)
    gw[q[live]] = (ab.float() * ga0f).sum(-1)[live]
    return a, dh, gw.view_as(w)


# the kernels read their bf16 rows (the leading inputs, `aligned` in each
# check below) in 16-byte chunks
_gather_launch = _build.Entry("experts", "experts_gather_launch",
                              "pppp l iii")
_swiglu_launch = _build.Entry("experts", "experts_swiglu_launch", "ppp l ii")
_combine_launch = _build.Entry("experts", "experts_combine_launch",
                               "ppppp l iii")
_grad_gather_launch = _build.Entry("experts", "experts_grad_gather_launch",
                                   "pppppp l iii")
_swiglu_bwd_launch = _build.Entry("experts", "experts_swiglu_bwd_launch",
                                  "pppppppp l ii")


def _half_width(name: str, h: torch.Tensor) -> int:
    """I of h = [g | u], a multiple of 8 (16-byte chunks of a and of g)."""
    if h.shape[1] % 16:
        raise ValueError(f"{name}: h {tuple(h.shape)} is not [g | u] with "
                         f"g a multiple of 8 wide")
    return h.shape[1] // 2


_BF16, _F32, _I32, _I64 = torch.bfloat16, torch.float32, torch.int32, \
    torch.long


def gather_rows(x: torch.Tensor, src: torch.Tensor, offs: torch.Tensor,
                k: int) -> torch.Tensor:
    """`gather_rows_plain` (kernel `experts_gather` on the card)."""
    if not x.is_cuda:
        return gather_rows_plain(x, src, offs, k)
    _build.check_inputs("experts_gather", (x, _BF16), (src, _I64),
                        (offs, _I32), aligned=1, whole_rows=True)
    R, D = src.shape[0], x.shape[1]
    xs = _rows(R, D, x)
    _gather_launch(x, src, offs, xs, R, D, offs.numel(), k)
    return xs


def swiglu(h: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """`swiglu_plain` (kernel `experts_swiglu` on the card)."""
    if not h.is_cuda:
        return swiglu_plain(h, offs)
    _build.check_inputs("experts_swiglu", (h, _BF16), (offs, _I32),
                        aligned=1, whole_rows=True)
    R, I = h.shape[0], _half_width("experts_swiglu", h)
    a = _rows(R, I, h)
    _swiglu_launch(h, offs, a, R, I, offs.numel())
    return a


def combine(rows: torch.Tensor, w: Optional[torch.Tensor], pos: torch.Tensor,
            offs: torch.Tensor, T: int) -> torch.Tensor:
    """`combine_plain` (kernel `experts_combine` on the card; counted as
    `experts_grad_combine` when unweighted, the gradient's)."""
    if not rows.is_cuda:
        return combine_plain(rows, w, pos, offs, T)
    k = pos.numel() // T
    _build.check_inputs("experts_combine", (rows, _BF16), (pos, _I64),
                        (offs, _I32), *([] if w is None else [(w, _F32)]),
                        aligned=1, whole_rows=True)
    if not 0 < k <= MAX_PICKS or pos.numel() != T * k:
        raise ValueError(f"experts_combine: {pos.numel()} picks over "
                         f"{T} tokens")
    D = rows.shape[1]
    y = torch.empty(T, D, dtype=rows.dtype, device=rows.device)
    _combine_launch(rows, w, pos, offs, y, T, D, offs.numel(), k,
                    counts=("experts_grad_combine",) if w is None else ())
    return y


def grad_gather(gy: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
                offs: torch.Tensor, k: int):
    """`grad_gather_plain` (kernel `experts_grad_gather` on the card)."""
    if not gy.is_cuda:
        return grad_gather_plain(gy, w, src, offs, k)
    _build.check_inputs("experts_grad_gather", (gy, _BF16), (w, _F32),
                        (src, _I64), (offs, _I32), aligned=1,
                        whole_rows=True)
    R, D = src.shape[0], gy.shape[1]
    gyr, go = _rows(R, D, gy), _rows(R, D, gy)
    _grad_gather_launch(gy, w, src, offs, gyr, go, R, D, offs.numel(), k)
    return gyr, go


def swiglu_bwd(h: torch.Tensor, ga0: torch.Tensor, w: torch.Tensor,
               src: torch.Tensor, offs: torch.Tensor):
    """`swiglu_bwd_plain` (kernel `experts_swiglu_bwd` on the card)."""
    if not h.is_cuda:
        return swiglu_bwd_plain(h, ga0, w, src, offs)
    _build.check_inputs("experts_swiglu_bwd", (h, _BF16), (ga0, _BF16),
                        (w, _F32), (src, _I64), (offs, _I32), aligned=2,
                        whole_rows=True)
    R, I = h.shape[0], _half_width("experts_swiglu_bwd", h)
    if ga0.shape != (R, I):
        raise ValueError(f"experts_swiglu_bwd: h {tuple(h.shape)}, ga0 "
                         f"{tuple(ga0.shape)}")
    a, dh = _rows(R, I, h), _rows(R, 2 * I, h)
    gw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    _swiglu_bwd_launch(h, ga0, w, src, offs, a, dh, gw, R, I, offs.numel())
    return a, dh, gw


class _HeldExperts(torch.autograd.Function):
    """y [T, D] = for each token the sum over its picks p held here of
    w[t, p] * SwiGLU_e(x[t]) (e the pick's expert), through
    `torch._grouped_mm` over the rows of `src`; x and the weights in the
    compute dtype (bf16), the sum in f32, y in x's dtype."""

    @staticmethod
    def forward(ctx, x, w13, w2, w, src, pos, offs):
        T, k = w.shape
        with span("moe.experts"):
            xs = gather_rows(x, src, offs, k)
            h = torch._grouped_mm(xs, w13.transpose(1, 2), offs=offs)
            del xs
            a = swiglu(h, offs)
            del h
            o = torch._grouped_mm(a, w2.transpose(1, 2), offs=offs)
            del a
        with span("moe.combine"):
            y = combine(o, w, pos, offs, T)
        ctx.save_for_backward(x, w13, w2, w, src, pos, offs)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w13, w2, w, src, pos, offs = ctx.saved_tensors
        T, k = w.shape
        with span("moe.experts_bwd"):
            xs = gather_rows(x, src, offs, k)
            h = torch._grouped_mm(xs, w13.transpose(1, 2), offs=offs)
            # the rows' output gradient, before and after the weight
            gyr, go = grad_gather(gy.to(x.dtype).contiguous(), w, src, offs,
                                  k)
            ga0 = torch._grouped_mm(gyr, w2, offs=offs)          # [R, I]
            del gyr
            a, dh, gw = swiglu_bwd(h, ga0, w, src, offs)
            del h, ga0
            gw2 = torch._grouped_mm(go.t(), a, offs=offs)         # [E, D, I]
            del go, a
            gw13 = torch._grouped_mm(dh.t(), xs, offs=offs)       # [E, 2I, D]
            gxs = torch._grouped_mm(dh, w13, offs=offs)           # [R, D]
            del dh, xs
            gx = combine(gxs, None, pos, offs, T)
        return gx, gw13, gw2, gw, None, None, None


def held_experts_grouped(x: torch.Tensor, w13: torch.Tensor,
                         w2: torch.Tensor, top: torch.Tensor,
                         w: torch.Tensor, offset: int) -> torch.Tensor:
    """x [T, D] (bf16), w13 [held, 2I, D] (gate rows, then up rows), w2
    [held, D, I] (bf16), top [T, k] the picked experts' global ids, w
    [T, k] f32 their weights: the held experts' part of the layer's
    output [T, D], in x's dtype."""
    with span("moe.dispatch"):
        plan = dispatch_plan(top, w13.shape[0], offset)
    return _HeldExperts.apply(x.contiguous(), w13, w2, w.float().contiguous(),
                              plan.src, plan.pos, plan.offs)


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


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    g, u = h.chunk(2, dim=-1)
    return F.silu(g) * u
