"""The hippocampal transformer in plain PyTorch: the LM's reference.

A frozen, self-contained statement of the model the configuration names
(`lm-full-rag`): place-cell token encoder, theta-gamma positions, and
`num_layers` memory-augmented pre-norm blocks (causal attention whose
queries carry the memory gate, episodic retrieval injected through the
sigmoid gate, then the GELU MLP or, on `snn_layers`, the hybrid of the
MLP and the two-stage GIF spiking FFN), a final norm and the tied head.
It computes in the configuration's compute dtype (bf16, with the
program's casts; or f32, TF32 off) from the weights the benchmark drew,
with full causal attention over the whole sequence and no cache.

Which bank rows each layer injects at each position is the program's
answer, read from its retrievals (`slots`); everything else is worked
out here: the queries, the rows' scores and softmax weights (from the
bank rows the benchmark drew), and the injection. Every position of a
row shares the retrieval of the row's mean hidden state, as a training
step's does.

`linear` lets the control run the same steps with every product's
inputs rounded to fp8 (e4m3, per-tensor scale), forward and backward.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
PROSODY_DIM = 4
Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# parameters: names, shapes and how the benchmark draws them
# ----------------------------------------------------------------------

def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter; init is "normal"
    (std = scale) or "const" (value = scale). Dense weights are
    [out, in] with std 1/sqrt(in); spiking synapses are [in, out] with
    std 1/sqrt(in * 0.3); embeddings std 0.02; norms 1 and 0; the hybrid
    gate logit(snn_ratio); phase offsets std 0.1, amplitudes 1."""
    D, I, V = m["embedding_dim"], m["intermediate_size"], m["vocab_size"]
    H, N = m["num_heads"], m["n_place_cells"]
    out = []

    def dense(name, n_in, n_out):
        out.append((f"{name}.weight", (n_out, n_in), "normal",
                    1.0 / math.sqrt(n_in)))
        out.append((f"{name}.bias", (n_out,), "const", 0.0))

    def norm(name):
        out.append((f"{name}.weight", (D,), "const", 1.0))
        out.append((f"{name}.bias", (D,), "const", 0.0))

    def synapse(name, n_in, n_out):
        out.append((f"{name}.kernel", (n_in, n_out), "normal",
                    1.0 / math.sqrt(n_in * 0.3)))
        out.append((f"{name}.bias", (n_out,), "const", 0.0))

    out.append(("semantic_encoder.token_embedding.weight", (V, D), "normal",
                0.02))
    dense("semantic_encoder.semantic_projection", D, N)
    dense("semantic_encoder.place_to_semantic", N, D)
    for name in ("theta_phase_offsets", "gamma_phase_offsets"):
        out.append((f"pos_encoder.{name}", (D,), "normal", 0.1))
    out.append(("pos_encoder.amplitude_modulation", (D,), "const", 1.0))
    norm("input_norm")
    r = m["snn_ratio"]
    for i in range(m["num_layers"]):
        p = f"layers.{i}"
        norm(f"{p}.attention_norm")
        for proj in ("q_proj", "k_proj", "v_proj"):
            dense(f"{p}.attention.{proj}", D, D)
        dense(f"{p}.attention.prosody_gate", PROSODY_DIM, H)
        dense(f"{p}.attention.memory_gate", D, 1)
        dense(f"{p}.attention.o_proj", D, D)
        dense(f"{p}.query_proj", D, D)
        dense(f"{p}.memory_proj", D, D)
        dense(f"{p}.memory_gate_proj", 2 * D, D)
        norm(f"{p}.ffn_norm")
        if i in m["snn_layers"]:
            dense(f"{p}.ffn.mlp.up", D, I)
            dense(f"{p}.ffn.mlp.down", I, D)
            synapse(f"{p}.ffn.snn.syn1", D, I)
            dense(f"{p}.ffn.snn.gif1_in", I, I)
            synapse(f"{p}.ffn.snn.syn2", I, D)
            dense(f"{p}.ffn.snn.gif2_in", D, D)
            out.append((f"{p}.ffn.gate", (), "const",
                        math.log(r / (1 - r))))
        else:
            dense(f"{p}.ffn.up", D, I)
            dense(f"{p}.ffn.down", I, D)
    norm("final_norm")
    return out


# ----------------------------------------------------------------------
# precision of the products
# ----------------------------------------------------------------------

def plain_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T in the inputs' dtype (f32 accumulation)."""
    return x @ w.T


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 under a per-tensor scale (its largest
    magnitude maps to 448), back in f32; no gradient."""
    x = x.detach().float()
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Linear(torch.autograd.Function):
    """x @ w.T with every product's inputs rounded by `_fp8`, forward and
    backward (the gradient scaled per tensor as well), as fp8 training
    computes it. Left to autograd, the cast's backward would round the
    unscaled gradient to e4m3, whose smallest step (2^-9) flushes every
    weight gradient to zero."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        ctx.dtypes = (x.dtype, w.dtype)
        return (xq @ wq.T).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g)
        gx = (gq @ wq).to(ctx.dtypes[0])
        gw = (gq.reshape(-1, gq.shape[-1]).T
              @ xq.reshape(-1, xq.shape[-1])).to(ctx.dtypes[1])
        return gx, gw


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T with the inputs of its products rounded to fp8 e4m3
    (per-tensor scale) in the forward and the backward, accumulated in
    f32, returned in x's dtype."""
    return _Fp8Linear.apply(x, w)


# ----------------------------------------------------------------------
# training's stochastic and surrogate parts
# ----------------------------------------------------------------------

class Dropout:
    """Training's dropout masks: at site i (the model's dropout sites in
    order, `dropout_sites`) a uniform draw of the input's shape from a
    generator on its device seeded (seed * 1000003 + i) mod 2^63; kept
    where below 1 - rate and divided by 1 - rate rounded to the input's
    dtype, else 0."""

    def __init__(self, seed: int, rate: float):
        self.seed, self.rate = int(seed), rate

    def __call__(self, x: torch.Tensor, site: int) -> torch.Tensor:
        gen = torch.Generator(device=x.device)
        gen.manual_seed((self.seed * 1_000_003 + site) % (2 ** 63))
        keep = torch.rand(x.shape, generator=gen, device=x.device) \
            < 1.0 - self.rate
        return torch.where(keep, x / torch.tensor(1.0 - self.rate,
                                                  dtype=x.dtype), 0.0)


def dropout_sites(m: dict) -> Dict[str, int]:
    """Each dropout site's index: per layer the attention's output, then
    the MLP's (and on spiking layers the spiking FFN's); the input's
    last."""
    out, i = {}, 0
    for layer in range(m["num_layers"]):
        names = (["attn", "mlp", "snn"] if layer in m["snn_layers"]
                 else ["attn", "mlp"])
        for n in names:
            out[f"{layer}.{n}"] = i
            i += 1
    out["input"] = i
    return out


class _Spike(torch.autograd.Function):
    """Multi-bit spike floor(v) clipped to [0, levels], with the
    surrogate gradient clamp(1 - 2 |v - round(v)|, 0, 1) on
    0 <= v <= levels + 1."""

    @staticmethod
    def forward(ctx, v, levels):
        ctx.save_for_backward(v)
        ctx.levels = levels
        return torch.clamp(torch.floor(v), 0.0, levels)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        scale = torch.clamp(1.0 - 2.0 * (v - torch.round(v)).abs(), 0.0,
                            1.0)
        inside = ((v >= 0.0) & (v <= ctx.levels + 1.0)).to(g.dtype)
        return g * inside * scale, None


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


# ----------------------------------------------------------------------
# the forward
# ----------------------------------------------------------------------

class Model:
    """The reference over parameters `P` (f32, the program's names),
    computing in `dtype`: f32, or the configuration's bf16 with the
    program's casts (parameters cast at each use, norms and the place
    code's top-k in f32, constants rounded to bf16 first)."""

    def __init__(self, P: Params, m: dict, mem: dict,
                 linear: Callable = plain_linear,
                 dtype: torch.dtype = torch.float32,
                 dropout: Optional[Dropout] = None):
        self.P, self.m, self.mem, self.lin = P, m, mem, linear
        self.dt = dtype
        self.drop = dropout
        self.sites = dropout_sites(m)

    def dropout(self, x, site: str):
        return x if self.drop is None else self.drop(x, self.sites[site])

    def c(self, value: float, like: torch.Tensor) -> torch.Tensor:
        """A constant rounded to the compute dtype (f32 stays exact)."""
        return torch.tensor(value, dtype=self.dt, device=like.device)

    def dense(self, x, name):
        dt = self.dt
        return self.lin(x.to(dt), self.P[f"{name}.weight"].to(dt)) \
            + self.P[f"{name}.bias"].to(dt)

    def synapse(self, x, name):
        dt = self.dt
        return self.lin(x.to(dt), self.P[f"{name}.kernel"].to(dt).T) \
            + self.P[f"{name}.bias"].to(dt)

    def norm(self, x, name):
        return F.layer_norm(x.float(), (x.shape[-1],),
                            self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], LN_EPS).to(self.dt)

    def embed(self, ids):
        m = self.m
        te = self.P["semantic_encoder.token_embedding.weight"][ids] \
            .to(self.dt)
        logits = self.dense(te, "semantic_encoder.semantic_projection") \
            .float()
        k = max(1, int(m["n_place_cells"] * m["place_cell_sparsity"]))
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        act = torch.sigmoid(logits) * (logits >= kth).float()
        recon = self.dense(act, "semantic_encoder.place_to_semantic")
        return te + self.c(m["place_residual_scale"], te) * recon, act

    def positions(self, L, device):
        m, P = self.m, self.P
        pos = torch.arange(L, device=device, dtype=torch.float32)
        npos = (pos / float(max(m["max_seq_len"] - 1, 1))
                * (2.0 * math.pi))[:, None]
        theta = npos + P["pos_encoder.theta_phase_offsets"]
        gamma = npos * (m["gamma_freq"] / m["theta_freq"]) \
            + P["pos_encoder.gamma_phase_offsets"]
        enc = torch.sin(theta) + 0.5 * ((torch.cos(theta) + 1.0) * 0.5
                                        * torch.sin(gamma))
        return (enc * P["pos_encoder.amplitude_modulation"]).to(self.dt)

    def attention(self, x, p, prosody=None):
        N, L, D = x.shape
        H = self.m["num_heads"]
        Hd = D // H
        q, k, v = (self.dense(x, f"{p}.attention.{n}").view(N, L, H, Hd)
                   for n in ("q_proj", "k_proj", "v_proj"))
        if prosody is not None:
            pr = prosody.to(self.dt)
            gain = torch.sigmoid(self.dense(pr, f"{p}.attention.prosody_gate"))
            boost = ((1.0 + self.c(0.2, pr) * torch.tanh(pr[..., 0:1]))
                     * (1.0 + self.c(0.05, pr) * torch.tanh(pr[..., 1:2])))
            q = q * (1.0 + gain)[..., None] * boost[..., None]
        gate = torch.sigmoid(self.dense(x, f"{p}.attention.memory_gate"))
        q = q * (1.0 + 0.5 * gate)[..., None]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(Hd)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        ctx = (torch.softmax(s, dim=-1) @ v.float()).to(self.dt)
        return self.dense(ctx.transpose(1, 2).reshape(N, L, D),
                          f"{p}.attention.o_proj")

    def inject(self, h, p, rows, slots, temporal=1.0):
        """The gate injection of the rows `slots` [N, L, k] at each
        position: the query from this layer's hidden states' mean over
        the sequence, exact combined scores of the rows (`temporal` their
        common temporal term), their softmax-weighted mean, then the
        sigmoid gate."""
        q_in = h.mean(dim=1, keepdim=True).expand(-1, h.shape[1], -1)
        q = self.dense(q_in, f"{p}.query_proj").float()          # [N, L, D]
        feats = rows[slots]                                      # [N,L,k,D]
        cos = torch.einsum("nlkd,nld->nlk", _unit(feats), _unit(q))
        score = (self.mem["w_cosine"] * cos
                 + self.mem["w_temporal"] * temporal).to(self.dt)
        w = torch.softmax(score, dim=-1)[..., None]
        ctx = (feats.to(self.dt) * w).sum(dim=2)
        ctx = self.dense(ctx, f"{p}.memory_proj")
        gate = torch.sigmoid(self.dense(torch.cat([h, ctx], dim=-1),
                                        f"{p}.memory_gate_proj"))
        return h + gate * ctx

    def gif(self, currents: List[torch.Tensor]) -> torch.Tensor:
        """Multi-bit GIF spikes of per-step currents (the GIF step in the
        compute dtype), stacked on dim -2."""
        like = currents[0]
        levels = float(self.m["snn_levels"])
        decay = self.c(math.exp(-1.0 / 10.0), like)
        th0, alpha = self.c(1.0, like), self.c(0.01, like)
        v = torch.zeros_like(like)
        theta = torch.full_like(like, 1.0)
        out = []
        for cur in currents:
            v = v * decay + cur
            lim = levels * theta * 2.0
            v = torch.clamp(v, -lim, lim)
            spk = _Spike.apply(v / (theta + 1e-6), levels)
            v = v - spk * theta
            theta = theta + alpha * spk - alpha * (theta - th0)
            out.append(spk)
        return torch.stack(out, dim=-2)

    def ffn(self, x, p, layer: int, spiking: bool):
        def mlp(pre):
            out = self.dense(F.gelu(self.dense(x, f"{pre}.up"),
                                    approximate="tanh"), f"{pre}.down")
            return self.dropout(out, f"{layer}.mlp")
        if not spiking:
            return mlp(f"{p}.ffn")
        out = mlp(f"{p}.ffn.mlp")
        T = self.m["snn_timesteps"]
        s = f"{p}.ffn.snn"
        h1 = self.dense(self.synapse(x, f"{s}.syn1"), f"{s}.gif1_in")
        s1 = self.gif([h1] * T)                                  # [.., T, I]
        h2 = self.dense(self.synapse(s1, f"{s}.syn2"), f"{s}.gif2_in")
        s2 = self.gif([h2[..., t, :] for t in range(T)])
        snn = self.dropout(s2.float().mean(dim=-2).to(self.dt),
                           f"{layer}.snn")
        g = torch.sigmoid(self.P[f"{p}.ffn.gate"]).to(self.dt)
        return (1.0 - g) * out + g * snn

    def forward(self, ids: torch.Tensor, rows: torch.Tensor,
                slots: List[torch.Tensor],
                prosody: Optional[torch.Tensor] = None,
                temporal: float = 1.0):
        """(logits [N, L, V] f32, place activity [N, L, n_place] f32,
        memory summary [N, D] f32: the final hidden states' mean) of
        token ids [N, L]; `slots[l]` [N, L, k] are the bank rows layer l
        injects at each position."""
        N, L = ids.shape
        te, act = self.embed(ids)
        h = self.norm(te + self.positions(L, ids.device), "input_norm")
        h = self.dropout(h, "input")
        for i in range(self.m["num_layers"]):
            p = f"layers.{i}"
            a = self.attention(self.norm(h, f"{p}.attention_norm"), p,
                               prosody)
            h = h + self.dropout(a, f"{i}.attn")
            h = self.inject(h, p, rows, slots[i], temporal)
            h = h + self.ffn(self.norm(h, f"{p}.ffn_norm"), p, i,
                             i in self.m["snn_layers"])
        h = self.norm(h, "final_norm")
        E = self.P["semantic_encoder.token_embedding.weight"].to(self.dt)
        return self.lin(h, E).float(), act, h.mean(dim=1).float()
