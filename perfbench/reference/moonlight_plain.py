"""DeepSeek-V3's block, as Moonlight-16B-A3B publishes it, with the
system's episodic memory injected: a plain reference in float32.

A self-contained statement, in plain `torch` (this file imports nothing
else), of the LM that `config.DeepSeekV3Config` builds in the port: the
token embedding; per layer RMSNorm -> latent attention (MLA) ->
residual, the episodic memory's gate injection, RMSNorm -> the dense
SwiGLU FFN (the first `first_k_dense_replace` layers) or the MoE ->
residual; the final RMSNorm and the untied head; the loss (label-
smoothed next-token cross-entropy minus the entropy bonus: the trainer's
loss without a place code) and, through autograd, its gradients. No
cache, no batching tricks, f32 throughout with TF32 off (`tf32_off`).

It follows the published modelling code (`modeling_deepseek.py`,
`DeepseekV3Attention` with `q_lora_rank` null, `DeepseekV3MoE` with
`topk_method` "noaux_tc" and one group). Departures, each the port's as
well:
- every norm and RoPE computes in f32 and multiplies by the weight before
  any cast (the published code casts to the input's dtype first; here
  everything is f32);
- the MoE computes only the experts this model holds (its share under
  expert parallelism): the others' part of a token's output is left out,
  as it lies on other chips;
- the vocabulary is the slice this model holds; the loss is over it;
- the memory injection between the attention and the FFN is the
  system's, not the published model's.

Two answers are the program's and come in as inputs, so that a check
can judge each on its own: which bank rows each layer injected for each
sequence (`slots`: the query is worked out here, from this model's
hidden states, and so are the rows' scores and weights), and which
experts each layer's router picked for each token (`choices`: the
router's scores and the weights are worked out here; `route_gap` says
how far the picks lie below this model's own; "own" routes by this
model's own top k, as a control does, and `picked` keeps those picks).
`bias` is each MoE layer's load-balancing bias when the step ran.

`blocked=True` evaluates the same function so that it fits beside a
large model: sequence by sequence, each layer and each block of
`q_block` queries recomputed in the backward (`torch.utils.checkpoint`),
the loss's gradient taken sequence by sequence and summed.

`linear(x, w)` is every weight product's x @ w.T (the attention's own
products and the router's sigmoid excepted), so a control can round the
inputs of each to a lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


def tf32_off() -> None:
    """f32 products in full f32 on the card (TF32 off, matmul and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def plain_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T."""
    return x @ w.T


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter under the port's
    names, in the port's order; init "normal" (std = scale) or "const"
    (value = scale). Weights [out, in] with std 1/sqrt(in); the stacked
    experts [held, out, in] likewise; the embedding std 0.02; norms 1;
    the memory projections' biases 0."""
    D, H = m["embedding_dim"], m["num_heads"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    r, I, Ie = m["kv_lora_rank"], m["intermediate_size"], \
        m["moe_intermediate_size"]
    out = []

    def dense(name, n_in, n_out, bias=False):
        out.append((f"{name}.weight", (n_out, n_in), "normal",
                    n_in ** -0.5))
        if bias:
            out.append((f"{name}.bias", (n_out,), "const", 0.0))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), "const", 1.0))

    def swiglu(name, width):
        dense(f"{name}.gate_proj", D, width)
        dense(f"{name}.up_proj", D, width)
        dense(f"{name}.down_proj", width, D)

    out.append(("embed_tokens.weight", (m["vocab_size"], D), "normal",
                0.02))
    for i in range(m["num_layers"]):
        p = f"layers.{i}"
        norm(f"{p}.attention_norm", D)
        dense(f"{p}.attention.q_proj", D, H * (nope + rope))
        dense(f"{p}.attention.kv_a_proj_with_mqa", D, r + rope)
        norm(f"{p}.attention.kv_a_layernorm", r)
        dense(f"{p}.attention.kv_b_proj", r, H * (nope + vd))
        dense(f"{p}.attention.o_proj", H * vd, D)
        dense(f"{p}.query_proj", D, D, bias=True)
        dense(f"{p}.memory_proj", D, D, bias=True)
        dense(f"{p}.memory_gate_proj", 2 * D, D, bias=True)
        norm(f"{p}.ffn_norm", D)
        if i < m["first_k_dense_replace"]:
            swiglu(f"{p}.ffn", I)
        else:
            n = m["experts_held"]
            dense(f"{p}.ffn.gate", D, m["n_routed_experts"])
            out.append((f"{p}.ffn.experts.gate_up_proj", (n, 2 * Ie, D),
                        "normal", D ** -0.5))
            out.append((f"{p}.ffn.experts.down_proj", (n, D, Ie), "normal",
                        Ie ** -0.5))
            swiglu(f"{p}.ffn.shared_experts",
                   m["n_shared_experts"] * Ie)
    norm("final_norm", D)
    dense("lm_head", D, m["vocab_size"])
    return out


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """The published `apply_rotary_pos_emb` on x [..., L, n, d], positions
    0..L-1: de-interleave, then x cos + rotate_half(x) sin."""
    *lead, L, n, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d))
    f = torch.outer(torch.arange(L, device=x.device, dtype=torch.float32),
                    inv)
    emb = torch.cat([f, f], dim=-1)[:, None, :]
    x = x.reshape(*lead, L, n, d // 2, 2).transpose(-1, -2) \
        .reshape(*lead, L, n, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + half * emb.sin()


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


class Moonlight:
    """The model over parameters `P` (f32, the port's names) and the
    config `m` (the fields of `DeepSeekV3Config`); `mem` the memory
    config's fields (w_cosine, w_temporal)."""

    def __init__(self, P: Params, m: dict, mem: dict,
                 linear: Callable = plain_linear, blocked: bool = False,
                 q_block: int = 1024):
        self.P, self.m, self.mem, self.lin = P, m, mem, linear
        self.blocked, self.q_block = blocked, q_block
        self.picked: List[Optional[torch.Tensor]] = []

    def dense(self, x, name, bias=False):
        y = self.lin(x, self.P[f"{name}.weight"])
        return y + self.P[f"{name}.bias"] if bias else y

    def norm(self, x, name):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + self.m["rms_norm_eps"]) \
            * self.P[f"{name}.weight"]

    def _core(self, q, k, v, start: int):
        """Causal attention of queries q [H, Lq, d] at positions start ..
        over keys and values [H, L, .]."""
        Lq, L = q.shape[1], k.shape[1]
        s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        pos = torch.arange(start, start + Lq, device=q.device)
        s = s.masked_fill(torch.arange(L, device=q.device)[None, :]
                          > pos[:, None], float("-inf"))
        return torch.softmax(s, dim=-1) @ v

    def attention(self, x, p):
        m = self.m
        N, L, _ = x.shape
        H, nope, rope, vd = (m["num_heads"], m["qk_nope_head_dim"],
                             m["qk_rope_head_dim"], m["v_head_dim"])
        a = f"{p}.attention"
        q = self.dense(x, f"{a}.q_proj").view(N, L, H, nope + rope)
        kv_a = self.dense(x, f"{a}.kv_a_proj_with_mqa")
        kv = self.dense(self.norm(kv_a[..., :m["kv_lora_rank"]],
                                  f"{a}.kv_a_layernorm"),
                        f"{a}.kv_b_proj").view(N, L, H, nope + vd)
        theta = m["rope_theta"]
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], dim=-1)
        k_pe = _rope(kv_a[..., None, m["kv_lora_rank"]:], theta)
        k = torch.cat([kv[..., :nope], k_pe.expand(N, L, H, rope)], dim=-1)
        v = kv[..., nope:]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # [N, H, L, .]
        outs = []
        for n in range(N):
            if not self.blocked:
                outs.append(self._core(q[n], k[n], v[n], 0))
                continue
            outs.append(torch.cat([
                checkpoint(self._core, q[n, :, s:s + self.q_block], k[n],
                           v[n], s, use_reentrant=False)
                for s in range(0, L, self.q_block)], dim=1))
        ctx = torch.stack(outs).transpose(1, 2).reshape(N, L, H * vd)
        return self.dense(ctx, f"{a}.o_proj")

    def inject(self, h, p, rows, slots, temporal):
        """The gate injection of the bank rows `slots` [N, k] into every
        position of each sequence: the query from the hidden states' mean
        over the sequence, the rows' exact combined scores (w_cos cos +
        w_t `temporal`; every row of the bank has the same strength and
        age), their softmax-weighted mean, the sigmoid gate."""
        q = self.dense(h.mean(dim=1), f"{p}.query_proj", bias=True)  # [N, D]
        feats = rows[slots]                                          # [N,k,D]
        cos = torch.einsum("nkd,nd->nk", _unit(feats), _unit(q))
        score = self.mem["w_cosine"] * cos + self.mem["w_temporal"] * temporal
        ctx = (feats * torch.softmax(score, dim=-1)[..., None]).sum(dim=1)
        ctx = self.dense(ctx, f"{p}.memory_proj", bias=True)[:, None, :] \
            .expand_as(h)
        gate = torch.sigmoid(self.dense(torch.cat([h, ctx], dim=-1),
                                        f"{p}.memory_gate_proj", bias=True))
        return h + gate * ctx

    def swiglu(self, x, name):
        return self.dense(F.silu(self.dense(x, f"{name}.gate_proj"))
                          * self.dense(x, f"{name}.up_proj"),
                          f"{name}.down_proj")

    def scores(self, x, p):
        """The router's sigmoid scores [N, L, E] of x."""
        return torch.sigmoid(self.dense(x, f"{p}.ffn.gate"))

    def moe(self, x, p, choice):
        """The MoE's output at x [N, L, D] with the program's picks
        `choice` [N, L, k] (global expert ids): the held experts' weighted
        outputs plus the shared experts'."""
        m = self.m
        s = self.scores(x, p)
        w = s.gather(-1, choice)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        w = w * m["routed_scaling_factor"]
        y = self.swiglu(x, f"{p}.ffn.shared_experts")
        flat, yf = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        w13 = self.P[f"{p}.ffn.experts.gate_up_proj"]
        w2 = self.P[f"{p}.ffn.experts.down_proj"]
        for e in range(m["experts_held"]):
            pick = (choice == m["experts_offset"] + e).reshape(-1, choice
                                                              .shape[-1])
            tok = pick.any(dim=-1).nonzero()[:, 0]
            if tok.numel() == 0:
                continue
            g, u = self.lin(flat[tok], w13[e]).chunk(2, dim=-1)
            out = self.lin(F.silu(g) * u, w2[e])
            yf = yf.index_add(0, tok, out * (w.reshape(pick.shape)
                                             * pick).sum(-1)[tok, None])
        return yf.view_as(y)

    def route_gap(self, x, p, choice, bias) -> torch.Tensor:
        """The widest gap, over the tokens, by which a picked expert's
        biased score lies below this model's own k-th best biased score
        (0 where the picks are this model's top k)."""
        with torch.no_grad():
            sb = self.scores(x, p) + bias
            kth = torch.topk(sb, choice.shape[-1], dim=-1).values[..., -1]
            return (kth - sb.gather(-1, choice).amin(-1)).clamp(min=0).amax()

    def layer(self, h, i, rows, slots, choice, bias, temporal):
        """(h after layer i, the layer's route gap: 0 on a dense layer)."""
        p = f"layers.{i}"
        h = h + self.attention(self.norm(h, f"{p}.attention_norm"), p)
        h = self.inject(h, p, rows, slots, temporal)
        x = self.norm(h, f"{p}.ffn_norm")
        if i < self.m["first_k_dense_replace"]:
            return h + self.swiglu(x, f"{p}.ffn"), h.new_zeros(())
        if isinstance(choice, str):                       # "own"
            with torch.no_grad():
                choice = torch.topk(self.scores(x, p) + bias,
                                    self.m["num_experts_per_tok"],
                                    dim=-1).indices
            if torch._C._current_graph_task_id() == -1:   # not a recompute
                self._picks[i] = choice
        return (h + self.moe(x, p, choice),
                self.route_gap(x, p, choice, bias))

    def forward(self, ids, rows, slots, choices, biases, temporal=1.0):
        """(logits [N, L, V], the final hidden states' mean [N, D], the
        widest route gap over the MoE layers) of token ids [N, L].
        `slots[l]` [N, k] are the rows layer l injected for each sequence;
        `choices[l]` [N, L, k] (or "own") and `biases[l]` [E] the picks and
        the bias of MoE layer l (None for a dense layer)."""
        h = self.P["embed_tokens.weight"][ids]
        gap = h.new_zeros(())
        self._picks: List[Optional[torch.Tensor]] = [None] * len(choices)
        for i in range(self.m["num_layers"]):
            args = (h, i, rows, slots[i], choices[i], biases[i], temporal)
            h, g = (checkpoint(self.layer, *args, use_reentrant=False)
                    if self.blocked else self.layer(*args))
            gap = torch.maximum(gap, g.detach())
        h = self.norm(h, "final_norm")
        if any(c is not None for c in self._picks):
            self.picked.append(self._picks)
        return self.dense(h, "lm_head"), h.mean(dim=1), gap


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, t: dict,
            n: Optional[int] = None) -> torch.Tensor:
    """The trainer's loss without a place code: label-smoothed next-token
    cross-entropy minus `entropy_lambda` times the mean entropy, each
    summed over logits[:, :-1] against labels[:, 1:] and divided by `n`
    (default: those positions' count; a sequence's share of a batch's
    loss divides by the batch's)."""
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -lp.gather(-1, labels[:, 1:, None])[..., 0]
    s = t["label_smoothing"]
    nll = (1.0 - s) * nll - s * lp.mean(dim=-1)
    n = nll.numel() if n is None else n
    entropy = -(lp.exp() * lp).sum(dim=-1)
    return nll.sum() / n - t["entropy_lambda"] * entropy.sum() / n


def loss_and_grads(model: Moonlight, t: dict, ids, labels, rows, slots,
                   choices, biases, temporal=1.0, half_batch: bool = False):
    """(loss, gradients by name, memory summaries [N, D], widest route
    gap) of a batch: the whole batch at once, or with `model.blocked`
    one sequence at a time (the gradients summed). `half_batch` plants a
    fault: the loss of the first half of the sequences alone."""
    names = [k for k, v in model.P.items() if v.requires_grad]
    N = ids.shape[0]
    n_rows = N // 2 if half_batch else N
    n = n_rows * (ids.shape[1] - 1)
    parts = ([slice(i, i + 1) for i in range(N)] if model.blocked
             else [slice(0, N)])
    grads = {k: torch.zeros_like(model.P[k]) for k in names}
    loss, summaries, gap = 0.0, [], ids.new_zeros((), dtype=torch.float32)
    for sl in parts:
        logits, summary, g = model.forward(
            ids[sl], rows, [s[sl] for s in slots],
            [c[sl] if torch.is_tensor(c) else c for c in choices], biases,
            temporal)
        keep = slice(0, max(0, min(sl.stop, n_rows) - sl.start))
        part = lm_loss(logits[keep], labels[sl][keep], t, n)
        got = torch.autograd.grad(part, [model.P[k] for k in names],
                                  allow_unused=True)
        for k, gk in zip(names, got):
            if gk is not None:
                grads[k] += gk
        loss += float(part.detach())
        summaries.append(summary.detach())
        gap = torch.maximum(gap, g.float())
    if model.picked:          # the parts' own picks, each layer's joined
        model.picked = [None if c[0] is None else torch.cat(c)
                        for c in zip(*model.picked)]
    return loss, grads, torch.cat(summaries), float(gap)
