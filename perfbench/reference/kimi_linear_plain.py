"""Kimi-Linear's hybrid block, as Kimi-Linear-48B-A3B publishes it, with
the system's episodic memory injected: a plain reference in float32.

A self-contained statement, in plain `torch` (this file imports nothing
else), of the LM that `config.KimiLinearConfig` builds in the port: the
token embedding; per layer RMSNorm -> the token mixer (Kimi Delta
Attention in the layers of `kda_layers`, latent attention without RoPE
in the others) -> residual, the episodic memory's gate injection,
RMSNorm -> the dense SwiGLU FFN (the first `first_k_dense_replace`
layers) or the MoE -> residual; the final RMSNorm and the untied head;
the loss (label-smoothed next-token cross-entropy minus the entropy
bonus: the trainer's loss without a place code) and, through autograd,
its gradients. No cache, no batching tricks, f32 throughout with TF32
off (`tf32_off`).

Kimi Delta Attention (the published `modeling_kimi.py` and the Flash
Linear Attention layer it builds on), per layer on x with H heads of d:
  q, k, v = SiLU(causal depthwise conv_w(x W_q)) (and W_k, W_v), no bias;
  q, k unit per head (eps 1e-6), q times d^-1/2;
  g = -exp(A_log[h]) softplus(x W_fa W_fb + dt_bias), one per channel;
  beta = sigmoid(x W_b), one per head;
  per head S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1}
                 + beta_t k_t v_t^T, S_0 = 0;  o_t = S_t^T q_t;
  out = W_o [RMSNorm_d(o) * w_norm * sigmoid(x W_ga W_gb)].
Latent attention is DeepSeek-V3's (`q_lora_rank` null) with
`mla_use_nope`: no rotation; the rope dims, the shared rope key and the
scale 1/sqrt(nope + rope) stay. The MoE is DeepSeek-V3's `noaux_tc` with
one group (sigmoid scores, top k by score plus bias, renormalised, times
`routed_scaling_factor`).

Departures, each the port's as well:
- `g_b_proj` has no bias and `dt_bias` starts at 0 (not given by the
  published config); every norm computes in f32 and multiplies by the
  weight before any cast (here everything is f32);
- the MoE computes only the experts this model holds (its share under
  expert parallelism): the others' part of a token's output is left out,
  as it lies on other chips;
- the vocabulary is the slice this model holds; the loss is over it;
- the memory injection between the mixer and the FFN is the system's,
  not the published model's.

Two answers are the program's and come in as inputs, so that a check can
judge each on its own: which bank rows each layer injected for each
sequence (`slots`) and which experts each layer's router picked for each
token (`choices`; "own" routes by this model's own top k, as a control
does, and `picked` keeps those picks). `bias` is each MoE layer's
load-balancing bias when the step ran.

`blocked=True` evaluates the same function so that it fits beside a
large model: sequence by sequence, each layer recomputed in the backward
(`torch.utils.checkpoint`), attention in blocks of `q_block` queries, and
Kimi Delta Attention chunk by chunk (`kda_chunks`: within a chunk of
`chunk` positions the same sum in another order, exact in every
exponent, with the state checkpointed at each chunk's end). Unblocked it
runs the recurrence token by token (`kda_recurrence`).

`linear(x, w)` is every weight product's x @ w.T (the attention's own
products, the recurrence and the router's sigmoid excepted), so a
control can round the inputs of each to a lower precision. `kda_control`
plants a control in every KDA layer: "bf16_state" runs the state pass in
bf16 (the state rounded after every update; blocked, the state, the
corrections U and the decayed keys and queries that meet them rounded at
each product of the chunk's carry); "no_delta" leaves the delta
correction out (S_t = Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T: gated
linear attention).
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
    names, in the port's order; init "normal" (std = scale), "const"
    (value = scale) or "log_uniform" (log U(1, scale)). Weights [out, in]
    with std 1/sqrt(in); the convolutions' [n, 1, w] std 1/sqrt(w); the
    stacked experts [held, out, in] likewise; the embedding std 0.02;
    norms 1; `A_log` log U(1, 16); `dt_bias` and the memory projections'
    biases 0."""
    D, H = m["embedding_dim"], m["num_heads"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    r, I, Ie = m["kv_lora_rank"], m["intermediate_size"], \
        m["moe_intermediate_size"]
    Hk, d, w = m["kda_num_heads"], m["kda_head_dim"], \
        m["short_conv_kernel_size"]
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
        a = f"{p}.attention"
        norm(f"{p}.attention_norm", D)
        if i in m["kda_layers"]:
            for x in "qkv":
                dense(f"{a}.{x}_proj", D, Hk * d)
            for x in "qkv":
                out.append((f"{a}.{x}_conv1d.weight", (Hk * d, 1, w),
                            "normal", w ** -0.5))
            out.append((f"{a}.A_log", (Hk,), "log_uniform", 16.0))
            dense(f"{a}.f_a_proj", D, d)
            dense(f"{a}.f_b_proj", d, Hk * d)
            out.append((f"{a}.dt_bias", (Hk * d,), "const", 0.0))
            dense(f"{a}.b_proj", D, Hk)
            dense(f"{a}.g_a_proj", D, d)
            dense(f"{a}.g_b_proj", d, Hk * d)
            norm(f"{a}.o_norm", d)
            dense(f"{a}.o_proj", Hk * d, D)
        else:
            dense(f"{a}.q_proj", D, H * (nope + rope))
            dense(f"{a}.kv_a_proj_with_mqa", D, r + rope)
            norm(f"{a}.kv_a_layernorm", r)
            dense(f"{a}.kv_b_proj", r, H * (nope + vd))
            dense(f"{a}.o_proj", H * vd, D)
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


def _unit(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _state(S: torch.Tensor, control: Optional[str]) -> torch.Tensor:
    return S.bfloat16().float() if control == "bf16_state" else S


def kda_recurrence(q, k, v, g, beta, control: Optional[str] = None):
    """o [N, L, H, d] of the recurrence token by token over q, k, v, g
    [N, L, H, d] and beta [N, L, H]."""
    N, L, H, d = q.shape
    S = q.new_zeros(N, H, d, v.shape[-1])
    out = []
    for t in range(L):
        S = S * torch.exp(g[:, t])[..., None]
        kt = k[:, t]
        err = v[:, t] if control == "no_delta" else \
            v[:, t] - torch.einsum("nhk,nhkv->nhv", kt, S)
        S = _state(S + beta[:, t, :, None, None] * kt[..., None]
                   * err[..., None, :], control)
        out.append(torch.einsum("nhk,nhkv->nhv", q[:, t], S))
    return torch.stack(out, 1)


def _kda_chunk(S, q, k, v, g, beta, control):
    """(o [N, c, H, d], the state at the chunk's end) of one chunk from
    the state S at its start: with G the decay's running sum from the
    chunk's start, E_ti = exp(G_t - G_i) for i <= t (each exponent <= 0)
    and A_ti = beta_t k_t.(k_i E_ti) for i < t, the values' corrections
    U = (I + A)^-1 beta (v - (k exp G) S) give o_t = (q_t exp G_t) S +
    sum_{i<=t} (q_t.(k_i E_ti)) U_i and S' = exp(G_last) S + sum_i
    (k_i exp(G_last - G_i)) U_i^T."""
    c = q.shape[1]
    q, k, v, g = (t.transpose(1, 2) for t in (q, k, v, g))  # [N, H, c, d]
    beta = beta.transpose(1, 2)
    G = g.cumsum(-2)
    idx = torch.arange(c, device=q.device)
    incl = (idx[:, None] >= idx[None, :])[..., None]
    E = torch.where(incl, torch.exp(torch.where(
        incl, G[..., :, None, :] - G[..., None, :, :], 0.0)), 0.0)
    kE = k[..., None, :, :] * E                            # [N,H,t,i,d]
    P = (q[..., :, None, :] * kE).sum(-1)
    r = _state if control == "bf16_state" else (lambda x, c: x)
    S = r(S, control)
    rhs = beta[..., None] * (v - r(k * torch.exp(G), control) @ S)
    if control == "no_delta":
        U = beta[..., None] * v
    else:
        A = torch.where(incl[..., 0] & (idx[:, None] != idx[None, :]),
                        beta[..., None] * (k[..., :, None, :] * kE).sum(-1),
                        0.0)
        U = torch.linalg.solve_triangular(
            torch.eye(c, device=q.device) + A, rhs, upper=False,
            unitriangular=True)
    U = r(U, control)
    o = r(q * torch.exp(G), control) @ S + P @ U
    last = G[..., -1:, :]
    S = torch.exp(last).transpose(-1, -2) * S \
        + r(k * torch.exp(last - G), control).transpose(-1, -2) @ U
    return o.transpose(1, 2), _state(S, control)


def kda_chunks(q, k, v, g, beta, chunk: int = 64,
               control: Optional[str] = None):
    """The recurrence's outputs chunk by chunk (`_kda_chunk`), each chunk
    recomputed in the backward from the state checkpointed at its
    start."""
    N, L, H, d = q.shape
    S = q.new_zeros(N, H, d, v.shape[-1])
    out = []
    for s in range(0, L, chunk):
        sl = slice(s, s + chunk)
        o, S = checkpoint(_kda_chunk, S, q[:, sl], k[:, sl], v[:, sl],
                          g[:, sl], beta[:, sl], control,
                          use_reentrant=False)
        out.append(o)
    return torch.cat(out, 1)


class KimiLinear:
    """The model over parameters `P` (f32, the port's names) and the
    config `m` (the fields of `KimiLinearConfig`); `mem` the memory
    config's fields (w_cosine, w_temporal)."""

    def __init__(self, P: Params, m: dict, mem: dict,
                 linear: Callable = plain_linear, blocked: bool = False,
                 q_block: int = 512, chunk: int = 128,
                 kda_control: Optional[str] = None):
        self.P, self.m, self.mem, self.lin = P, m, mem, linear
        self.blocked, self.q_block, self.chunk = blocked, q_block, chunk
        self.kda_control = kda_control
        self.picked: List[Optional[torch.Tensor]] = []

    def dense(self, x, name, bias=False):
        y = self.lin(x, self.P[f"{name}.weight"])
        return y + self.P[f"{name}.bias"] if bias else y

    def norm(self, x, name, eps=None):
        eps = self.m["rms_norm_eps"] if eps is None else eps
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
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
        k_pe = kv_a[..., None, m["kv_lora_rank"]:]
        if not m["mla_use_nope"]:
            theta = m["rope_theta"]
            q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], -1)
            k_pe = _rope(k_pe, theta)
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

    def _conv(self, x, name):
        """SiLU of the causal depthwise convolution of x [N, L, n]: y_t =
        sum_j w[:, 0, j] x_{t - width + 1 + j}, zeros before the start (a
        sum of shifted products: cuDNN's grouped convolution over 4096
        channels of 32k f32 positions took seconds)."""
        w = self.P[f"{name}.weight"]                       # [n, 1, width]
        width, L = w.shape[-1], x.shape[1]
        xp = F.pad(x, (0, 0, width - 1, 0))
        y = sum(xp[:, j:j + L] * w[:, 0, j] for j in range(width))
        return F.silu(y)

    def delta_attention(self, x, p):
        m = self.m
        N, L, _ = x.shape
        H, d = m["kda_num_heads"], m["kda_head_dim"]
        a = f"{p}.attention"
        q, k, v = (self._conv(self.dense(x, f"{a}.{n}_proj"),
                              f"{a}.{n}_conv1d").view(N, L, H, d)
                   for n in "qkv")
        q = _unit(q, 1e-6) * d ** -0.5
        k = _unit(k, 1e-6)
        f = self.dense(self.dense(x, f"{a}.f_a_proj"), f"{a}.f_b_proj") \
            + self.P[f"{a}.dt_bias"]
        g = -torch.exp(self.P[f"{a}.A_log"])[:, None] \
            * F.softplus(f.view(N, L, H, d))
        beta = torch.sigmoid(self.dense(x, f"{a}.b_proj"))
        if self.blocked:
            o = kda_chunks(q, k, v, g, beta, self.chunk, self.kda_control)
        else:
            o = kda_recurrence(q, k, v, g, beta, self.kda_control)
        gate = torch.sigmoid(self.dense(self.dense(x, f"{a}.g_a_proj"),
                                        f"{a}.g_b_proj")).view(N, L, H, d)
        o = self.norm(o, f"{a}.o_norm") * gate
        return self.dense(o.reshape(N, L, H * d), f"{a}.o_proj")

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
        x = self.norm(h, f"{p}.attention_norm")
        h = h + (self.delta_attention(x, p) if i in self.m["kda_layers"]
                 else self.attention(x, p))
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


def loss_and_grads(model: KimiLinear, t: dict, ids, labels, rows, slots,
                   choices, biases, temporal=1.0):
    """(loss, gradients by name, memory summaries [N, D], widest route
    gap) of a batch: the whole batch at once, or with `model.blocked`
    one sequence at a time (the gradients summed)."""
    names = [k for k, v in model.P.items() if v.requires_grad]
    N = ids.shape[0]
    n = N * (ids.shape[1] - 1)
    parts = ([slice(i, i + 1) for i in range(N)] if model.blocked
             else [slice(0, N)])
    grads = {k: torch.zeros_like(model.P[k]) for k in names}
    loss, summaries, gap = 0.0, [], ids.new_zeros((), dtype=torch.float32)
    for sl in parts:
        logits, summary, g = model.forward(
            ids[sl], rows, [s[sl] for s in slots],
            [c[sl] if torch.is_tensor(c) else c for c in choices], biases,
            temporal)
        part = lm_loss(logits, labels[sl], t, n)
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
