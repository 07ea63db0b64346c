"""Kimi-Linear's hybrid block in the port's LM, on the CPU at small sizes in
f32 on seeded random weights: Kimi Delta Attention's chunked core
(`ops/kda.py`, both paths, and the plain versions of its card passes)
against the token-by-token recurrence; the LM (a small model with the
layer pattern KDA, KDA, MLA; hidden 64, 4 MLA heads, 2 KDA heads of 16,
16 routed experts of width 24, 4 held, top 3, 1 shared, sequences of 80
in batches of 2, memory on) against the plain reference
(`aura_snn_rag_tpu_torch/reference/kimi_linear.py`); the reference's
chunk-wise evaluation against its recurrence.

Tolerances (f32 on both sides, sums in other orders): the core within
1e-5 of each output's and each gradient's norm; the LM's logits and loss
within 2e-5 of their scale; each gradient within 1e-4 of the larger of
its own largest entry and 1e-3 of the model's largest gradient entry (a
KDA layer's `A_log` holds one entry a head, each a sum over every
position and channel of the layer whose terms cancel to ~1e-3 of the
other gradients, so its own scale is rounding's).
"""

import ast
import dataclasses
import inspect
import math

import pytest
import torch
import torch.nn.functional as F

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.config import (
    DeepSeekV3Config, KimiLinearConfig)
from aura_snn_rag_tpu_torch.memory import engine
from aura_snn_rag_tpu_torch.models.layers import (
    KimiDeltaAttention, LatentAttention)
from aura_snn_rag_tpu_torch.ops import kda
from aura_snn_rag_tpu_torch.ops.cuda import kda as kernels
from aura_snn_rag_tpu_torch.reference import kimi_linear as ref
from aura_snn_rag_tpu_torch.training.losses import hippocampal_loss
from aura_snn_rag_tpu_torch.training.trainer import Trainer
from aura_snn_rag_tpu_torch.utils.trace import counters

B, L = 2, 80
MODEL = KimiLinearConfig(
    vocab_size=256, embedding_dim=64, num_layers=3, num_heads=4,
    intermediate_size=96, max_seq_len=L, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=16, experts_held=4, experts_offset=4,
    num_experts_per_tok=3, n_shared_experts=1, moe_intermediate_size=24,
    routed_scaling_factor=2.446, rope_theta=10_000.0, use_rag=True,
    dtype="float32", kda_layers=(0, 1), kda_num_heads=2, kda_head_dim=16)
# B x probe x bucket capacity (2 x 4 x 128) under the 4096 rows: IVF
MEMORY = port.MemoryConfig(max_memories=4096, feature_dim=64,
                           k_centroids=64, probe_centroids=4)
TRAIN = port.TrainingConfig(memory_warmup_steps=0, enable_thalamus=False,
                            endocrine_memory_gating=False,
                            enable_amygdala=False, warmup_steps=1,
                            max_steps=100, lr=1e-3)
LOSS = dict(label_smoothing=TRAIN.label_smoothing,
            entropy_lambda=TRAIN.entropy_lambda)
MEM = dict(w_cosine=MEMORY.w_cosine, w_temporal=MEMORY.w_temporal)


def core_inputs(seed, T, H=2, d=16, N=2, dtype=torch.float32):
    """(q, k, v, g, beta) drawn as the layer makes them: q, k unit per
    head (q times d^-1/2), g = -U(1, 16) softplus(unit normal) per channel
    (the published A_log's draw, dt_bias 0), beta a sigmoid."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(N, T, H, d, generator=gen, dtype=dtype)
               for _ in range(3))
    q = F.normalize(q, dim=-1) * d ** -0.5
    k = F.normalize(k, dim=-1)
    a = torch.empty(H, dtype=dtype).uniform_(1.0, 16.0, generator=gen)
    g = -a[:, None] * F.softplus(torch.randn(N, T, H, d, generator=gen,
                                             dtype=dtype))
    beta = torch.sigmoid(torch.randn(N, T, H, generator=gen, dtype=dtype))
    return [t.requires_grad_(True) for t in (q, k, v, g, beta)]


def _rel(got, want):
    return ((got - want).norm() / want.norm()).item()


PATHS = {"loop": kda.kda_chunk_loop, "chunked": kda.kda_chunked}


@pytest.mark.parametrize("T", [50, 64, 200])
@pytest.mark.parametrize("path", list(PATHS))
def test_chunked_core_matches_the_recurrence(path, T):
    """Forward and every gradient (q, k, v, g, beta) of each path against
    the recurrence token by token; T below, at and not a multiple of the
    chunk, over several chunks. At these gates the factorisation through
    exp(-G) of the chunk's running sum overflows f32."""
    x = core_inputs(T, T)
    G = x[3].detach()[:, :64].cumsum(1)
    assert torch.isinf(torch.exp(-G)).any() or T < 64
    want = ref.kda_recurrence(*x)
    do = torch.randn(want.shape, generator=torch.Generator().manual_seed(9))
    gw = torch.autograd.grad(want, x, do)
    got = PATHS[path](*x)
    gg = torch.autograd.grad(got, x, do)
    assert _rel(got, want) <= 1e-5
    for name, a, b in zip("q k v g beta".split(), gg, gw):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


def test_paths_count_and_agree_on_bf16_inputs():
    """The layer's inputs as the bf16 model hands them (q, k, v bf16):
    the CPU entry point counts `path.kda_loop` and returns f32, and the
    chunked path agrees with it."""
    x = [t.detach() for t in core_inputs(5, 130)]
    x[:3] = [t.bfloat16() for t in x[:3]]
    c0 = counters["path.kda_loop"]
    o = kda.kda(*x)
    assert counters["path.kda_loop"] == c0 + 1 and o.dtype == torch.float32
    assert _rel(kda.kda_chunked(*x), o) <= 1e-5


def _intra_inputs(seed, n=3, C=64, d=16):
    q, k, _, g, beta = core_inputs(seed, n * C, H=1, d=d, N=1)
    shape = (n, C, d)
    G = g.detach().reshape(shape).cumsum(1).requires_grad_(True)
    return (q.detach().reshape(shape).requires_grad_(True),
            k.detach().reshape(shape).requires_grad_(True), G,
            beta.detach().reshape(n, C).requires_grad_(True))


def _state_inputs(seed, heads=2, chunks=5, C=8, d=16):
    gen = torch.Generator().manual_seed(seed)
    W, Ubar, Khat = (0.1 * torch.randn(heads, chunks, C, d, generator=gen)
                     for _ in range(3))
    D = torch.rand(heads, chunks, d, generator=gen)
    return [t.requires_grad_(True) for t in (W, Ubar, Khat, D)]


@pytest.mark.parametrize("which", ["intra", "state"])
def test_card_passes_backward_matches_autograd(which):
    """The plain versions of the card's backward passes (the kernels'
    oracles) against autograd through the plain forward passes."""
    gen = torch.Generator().manual_seed(4)
    if which == "intra":
        x = _intra_inputs(3)
        outs = kernels.intra_fwd_plain(*x)
        dA, dP = (torch.randn(o.shape, generator=gen) for o in outs)
        got = kernels.intra_bwd_plain(*(t.detach() for t in x), dA, dP)
    else:
        x = _state_inputs(3)
        outs = kernels.state_fwd_plain(*x)
        dA, dP = (torch.randn(o.shape, generator=gen) for o in outs)
        W, _, Khat, D = (t.detach() for t in x)
        dS, dU = kernels.state_bwd_plain(dA, dP, W, Khat, D)
        h, U = (o.detach() for o in outs)
        got = (-(dU @ h.transpose(-1, -2)), dU, U @ dS.transpose(-1, -2),
               (h * dS).sum(-1))
    want = torch.autograd.grad(outs, x, (dA, dP))
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5


def test_the_intra_pass_is_exact_where_the_decay_underflows():
    """A decay of ~1000 nats over the chunk: A and P stay finite and each
    pair's weight is exp(G_t - G_i) taken alone (the pair t = i reads its
    own product, undecayed)."""
    q, k, G, beta = (t.detach() for t in _intra_inputs(7))
    G = G * 40.0
    A, P = kernels.intra_fwd_plain(q, k, G, beta)
    assert torch.isfinite(A).all() and torch.isfinite(P).all()
    diag = (q * k).sum(-1)
    assert torch.allclose(torch.diagonal(P, dim1=-2, dim2=-1), diag,
                          rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------
# the LM against the reference
# ---------------------------------------------------------------------

def _trainer(seed=3, model=MODEL):
    t = Trainer(port.AuraConfig(model=model, memory=MEMORY, training=TRAIN),
                seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 7)
    rows = torch.randn(MEMORY.max_memories, MEMORY.feature_dim, generator=g)
    st = engine.bulk_load(MEMORY, t.hippocampus.state, rows,
                          torch.zeros(rows.shape[0], MEMORY.spatial_dims))
    t.hippocampus.state = engine.rebuild_centroids(
        MEMORY, st, torch.Generator().manual_seed(seed))
    # the drawn weights are lecun-normal; make the biases and norms other
    # than their constants so that their gradients are exercised
    with torch.no_grad():
        for n, p in t.model.named_parameters():
            if n.endswith(("bias", "dt_bias")) or "norm" in n:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return t


class _Record:
    """Wraps `engine.retrieve_auto` and every MoE layer's `route` to keep
    the program's retrieved rows and picks."""

    def __init__(self, monkeypatch, model):
        self.slots, self.picks = [], []
        real = engine.retrieve_auto

        def retrieve(config, state, queries, query_locations=None, k=5):
            res = real(config, state, queries, query_locations, k)
            self.slots.append(res.indices.clone())
            return res
        monkeypatch.setattr(engine, "retrieve_auto", retrieve)
        for moe in model.moe_layers:
            route = moe.route

            def keep(x, route=route):
                top, w = route(x)
                self.picks.append(top.clone())
                return top, w
            monkeypatch.setattr(moe, "route", keep)

    def choices(self, m=MODEL):
        it = iter(self.picks)
        return [None if i < m.first_k_dense_replace
                else next(it).view(B, L, -1) for i in range(m.num_layers)]


def _biases(model, m=MODEL):
    return [None if i < m.first_k_dense_replace else
            model.layers[i].ffn.gate.e_score_correction_bias.clone()
            for i in range(m.num_layers)]


def _ids(seed, n=B):
    return torch.randint(0, MODEL.vocab_size, (n, L),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want, rel, what, floor=0.0):
    scale = max(want.abs().max().item(), floor, 1e-6)
    err = (got - want).abs().max().item()
    assert err <= rel * scale, (what, err, scale)


def test_the_pattern_builds_each_kind_of_layer():
    model = port.HippocampalTransformer(MODEL, MEMORY, device="cpu")
    kinds = [type(layer.attention) for layer in model.layers]
    assert kinds == [KimiDeltaAttention, KimiDeltaAttention,
                     LatentAttention]
    assert MODEL.latent_stem and DeepSeekV3Config().latent_stem
    assert not port.ModelConfig().latent_stem
    assert [MODEL.delta_rule_layer(i) for i in range(3)] == [True, True,
                                                             False]
    assert not DeepSeekV3Config().delta_rule_layer(0)
    a_log = model.layers[0].attention.A_log.detach()
    assert ((a_log >= 0) & (a_log <= math.log(16.0))).all()


@pytest.mark.parametrize("blocked", [False, True])
def test_port_matches_the_reference(monkeypatch, blocked):
    """Logits, loss and every gradient, with the retrieval query's
    gradient through the engine's plain IVF path; blocked, the reference
    runs KDA chunk by chunk (chunks of 32) and attention in blocks of 16
    queries."""
    t = _trainer()
    model = t.model
    rec = _Record(monkeypatch, model)
    ids = _ids(1)
    c0 = counters["path.kda_loop"]
    out, _ = model(ids, memory_state=t.hippocampus.state, use_memory=True)
    assert counters["path.kda_loop"] == c0 + len(MODEL.kda_layers)
    loss = hippocampal_loss(out.logits[:, :-1], ids[:, 1:], None, **LOSS)
    loss.backward()
    P = {n: p.detach().clone().requires_grad_(True)
         for n, p in model.named_parameters()}
    r = ref.KimiLinear(P, dataclasses.asdict(MODEL), MEM, blocked=blocked,
                       q_block=16, chunk=32)
    state = t.hippocampus.state
    logits, summary, gap = r.forward(ids, state.features, rec.slots,
                                     rec.choices(), _biases(model))
    _close(out.logits, logits.detach(), 2e-5, "logits")
    _close(out.memory_summary, summary.detach(), 2e-5, "summary")
    assert gap.item() == 0.0            # the picks are the reference's
    want, grads, _, gap2 = ref.loss_and_grads(
        r, LOSS, ids, ids, state.features, rec.slots, rec.choices(),
        _biases(model))
    assert abs(loss.item() - want) <= 2e-5 * abs(want)
    assert gap2 == 0.0
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    floor = 1e-3 * max(g.abs().max().item() for g in grads.values())
    for n, g in grads.items():
        _close(named[n].grad, g, 1e-4, n, floor)
    assert named["layers.0.attention.A_log"].grad.abs().sum() > 0


def _adamw(P, grads, mu, nu, count, t):
    """ClippedAdamW's update (optax's order) on dicts, f32."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = 1.0 if norm < t.gradient_clip else t.gradient_clip / norm
    c = count + 1
    warm = min(max(1, t.warmup_steps), t.max_steps - 1)
    if count < warm:
        lr = t.lr * count / warm
    else:
        frac = min(count - warm, t.max_steps - warm) / (t.max_steps - warm)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        lr = t.lr * ((1 - t.min_lr_ratio) * cos + t.min_lr_ratio)
    for k in P:
        g = grads[k] * scale
        mu[k] = 0.1 * g + 0.9 * mu[k]
        nu[k] = 0.001 * g * g + 0.999 * nu[k]
        u = (mu[k] / (1 - 0.9 ** c)) / (torch.sqrt(nu[k] / (1 - 0.999 ** c))
                                         + 1e-8)
        P[k] = P[k] - lr * (u + t.weight_decay * P[k])


def test_train_steps_and_the_bias_update(monkeypatch):
    """Two `train_step`s (the first at learning rate 0) against the
    reference's gradients through the same AdamW, with each MoE layer's
    bias moved by rate * sign(mean load - load) of the step's picks."""
    t = _trainer(seed=5)
    model = t.model
    rec = _Record(monkeypatch, model)
    P = {n: p.detach().clone() for n, p in model.named_parameters()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    rows = t.hippocampus.state.features.clone()
    moe_idx = [i for i in range(MODEL.num_layers)
               if i >= MODEL.first_k_dense_replace]
    bias = {i: torch.zeros(MODEL.n_routed_experts) for i in moe_idx}
    for step in range(2):
        rec.slots, rec.picks = [], []
        ids = _ids(10 + step)
        t.train_step(ids, ids)
        leaves = {k: v.clone().requires_grad_(True) for k, v in P.items()}
        r = ref.KimiLinear(leaves, dataclasses.asdict(MODEL), MEM)
        biases = [bias.get(i) for i in range(MODEL.num_layers)]
        temporal = math.exp(-step * MEMORY.seconds_per_step
                            / MEMORY.temporal_tau)
        _, grads, summary, gap = ref.loss_and_grads(
            r, LOSS, ids, ids, rows, rec.slots, rec.choices(), biases,
            temporal)
        assert gap == 0.0
        _adamw(P, grads, mu, nu, step, TRAIN)
        for i, picks in zip(moe_idx, rec.picks):
            load = torch.bincount(picks.reshape(-1),
                                  minlength=MODEL.n_routed_experts).float()
            bias[i] += MODEL.router_bias_rate * torch.sign(load.mean() - load)
            got = model.layers[i].ffn.gate.e_score_correction_bias
            assert torch.equal(got, bias[i])
        if step % TRAIN.memory_store_interval == 0:
            rows[torch.arange(B) % rows.shape[0]] = summary
    # Adam's first steps are about the sign of each entry's gradient: an
    # entry whose gradient is rounding moves at random, so each leaf is
    # held by the norm of its error
    for n, p in model.named_parameters():
        err = (p.detach() - P[n]).norm() / P[n].norm()
        assert err <= 1e-4, (n, err)


def test_the_block_refuses_a_kv_cache_and_a_mesh():
    model = port.HippocampalTransformer(MODEL, MEMORY, device="cpu")
    with pytest.raises(NotImplementedError):
        model.init_kv_caches(1, 8)
    with pytest.raises(ValueError):
        model(_ids(0), kv_caches=(), cache_index=0)
    t = Trainer(port.AuraConfig(model=MODEL, memory=MEMORY, training=TRAIN),
                seed=1, device="cpu")
    with pytest.raises(NotImplementedError, match="one rank"):
        t.shard_to_mesh(object())


# ---------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------

@pytest.mark.parametrize("control", [None, "bf16_state", "no_delta"])
def test_reference_chunks_match_its_recurrence(control):
    """The reference's chunk-by-chunk evaluation (the benchmark's, with
    the state checkpointed at chunk ends) against its own recurrence,
    forward and gradients, with and without each control; and the
    controls move the output."""
    x = core_inputs(21, 150)
    do = torch.randn(2, 150, 2, 16, generator=torch.Generator()
                     .manual_seed(2))
    want = ref.kda_recurrence(*x, control=control)
    got = ref.kda_chunks(*x, chunk=64, control=control)
    tol = 1e-5 if control != "bf16_state" else 2e-2    # rounded at other
    assert _rel(got, want) <= tol                       # points
    if control is None:
        gw = torch.autograd.grad(want, x, do)
        for a, b in zip(torch.autograd.grad(got, x, do), gw):
            assert _rel(a, b) <= 1e-5
    else:
        assert _rel(got, ref.kda_chunks(*x, chunk=64)) > 1e-4


def test_the_reference_imports_only_torch():
    tree = ast.parse(inspect.getsource(ref))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"torch", "__future__", "typing"}, names


def test_the_reference_names_every_parameter_of_the_port():
    model = port.HippocampalTransformer(MODEL, MEMORY, device="cpu")
    named = {n: tuple(p.shape) for n, p in model.named_parameters()}
    spec = {n: s for n, s, _, _ in ref.param_spec(dataclasses.asdict(MODEL))}
    assert spec == named
