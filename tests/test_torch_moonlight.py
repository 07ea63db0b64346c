"""DeepSeek-V3's block (Moonlight-16B-A3B's) in the port's LM against the
plain reference (`aura_snn_rag_tpu_torch/reference/moonlight.py`), on the
CPU at a small size in f32 on seeded random weights: hidden 64, 4 heads,
kv rank 32, nope 16 / rope 8 / v 16, 16 routed experts of width 24 (4
held), top 3, 1 shared expert, 1 dense + 2 MoE layers, sequences of 64 in
batches of 2, memory on (a bank whose batches of 2 retrieve through the
engine's plain IVF path).

The reference takes the program's retrieved rows and expert picks as
inputs, so each comparison here is of the arithmetic alone. Tolerances
(f32 on both sides, sums in other orders): logits and loss to 2e-5 of
their scale, each gradient to 1e-4 of its norm.
"""

import dataclasses

import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.config import DeepSeekV3Config, KimiLinearConfig
from aura_snn_rag_tpu_torch.memory import engine
from aura_snn_rag_tpu_torch.models.layers import MoEFFN
from aura_snn_rag_tpu_torch.ops import experts as ex
from aura_snn_rag_tpu_torch.reference import kimi_linear as kimi_ref
from aura_snn_rag_tpu_torch.reference import moonlight as ref
from aura_snn_rag_tpu_torch.training.losses import hippocampal_loss
from aura_snn_rag_tpu_torch.training.trainer import Trainer
from aura_snn_rag_tpu_torch.utils.trace import counters

B, L = 2, 64
MODEL = DeepSeekV3Config(
    vocab_size=256, embedding_dim=64, num_layers=3, num_heads=4,
    intermediate_size=96, max_seq_len=L, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=16, experts_held=4, experts_offset=4,
    num_experts_per_tok=3, n_shared_experts=1, moe_intermediate_size=24,
    routed_scaling_factor=2.446, rope_theta=50_000.0, use_rag=True,
    dtype="float32")
# B x probe x bucket capacity (2 x 4 x 128) under the 4096 rows: IVF
MEMORY = port.MemoryConfig(max_memories=4096, feature_dim=64,
                           k_centroids=64, probe_centroids=4)
TRAIN = port.TrainingConfig(memory_warmup_steps=0, enable_thalamus=False,
                            endocrine_memory_gating=False,
                            enable_amygdala=False, warmup_steps=1,
                            max_steps=100, lr=1e-3)


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
            if n.endswith("bias") or "norm" in n:
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

    def choices(self, m):
        it = iter(self.picks)
        return [None if i < m.first_k_dense_replace
                else next(it).view(B, L, -1) for i in range(m.num_layers)]


def _reference(model, P, state, rec, m=MODEL, **kw):
    biases = [None if i < m.first_k_dense_replace else
              model.layers[i].ffn.gate.e_score_correction_bias.clone()
              for i in range(m.num_layers)]
    return ref.Moonlight(P, dataclasses.asdict(m), dict(
        w_cosine=MEMORY.w_cosine, w_temporal=MEMORY.w_temporal), **kw), \
        biases


def _ids(seed, n=B):
    return torch.randint(0, MODEL.vocab_size, (n, L),
                         generator=torch.Generator().manual_seed(seed))


def _loss_kw():
    return dict(label_smoothing=TRAIN.label_smoothing,
                entropy_lambda=TRAIN.entropy_lambda)


def _close(got, want, rel, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * max(scale, 1e-6), (what, err, scale)


@pytest.mark.parametrize("blocked", [False, True])
def test_port_matches_the_reference(monkeypatch, blocked):
    """Logits, loss and every gradient, with the retrieval query's
    gradient through the engine's plain IVF path (kernel B's plain
    version and the annex chain on the CPU)."""
    t = _trainer()
    model = t.model
    rec = _Record(monkeypatch, model)
    ids = _ids(1)
    c0 = counters["path.ivf_v3r"]
    out, _ = model(ids, memory_state=t.hippocampus.state, use_memory=True)
    assert counters["path.ivf_v3r"] == c0 + MODEL.num_layers
    assert out.place_activity is None
    loss = hippocampal_loss(out.logits[:, :-1], ids[:, 1:], None,
                            **_loss_kw())
    loss.backward()
    P = {n: p.detach().clone().requires_grad_(True)
         for n, p in model.named_parameters()}
    r, biases = _reference(model, P, t.hippocampus.state, rec,
                           blocked=blocked, q_block=16)
    state = t.hippocampus.state
    logits, summary, gap = r.forward(ids, state.features, rec.slots,
                                     rec.choices(MODEL), biases)
    _close(out.logits, logits.detach(), 2e-5, "logits")
    _close(out.memory_summary, summary.detach(), 2e-5, "summary")
    assert gap.item() == 0.0            # the picks are the reference's
    want, grads, _, gap2 = ref.loss_and_grads(
        r, dict(label_smoothing=TRAIN.label_smoothing,
                entropy_lambda=TRAIN.entropy_lambda), ids, ids,
        state.features, rec.slots, rec.choices(MODEL), biases)
    assert abs(loss.item() - want) <= 2e-5 * abs(want)
    assert gap2 == 0.0
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for n, g in grads.items():
        _close(named[n].grad, g, 1e-4, n)
    assert named["layers.1.query_proj.weight"].grad.abs().sum() > 0


def _adamw(P, grads, mu, nu, count, t):
    """ClippedAdamW's update (optax's order) on dicts, f32."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = 1.0 if norm < t.gradient_clip else t.gradient_clip / norm
    c = count + 1
    warm = min(max(1, t.warmup_steps), t.max_steps - 1)
    if count < warm:
        lr = t.lr * count / warm
    else:
        import math
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
        r = ref.Moonlight(leaves, dataclasses.asdict(MODEL), dict(
            w_cosine=MEMORY.w_cosine, w_temporal=MEMORY.w_temporal))
        biases = [bias.get(i) for i in range(MODEL.num_layers)]
        temporal = torch.exp(torch.tensor(-step * MEMORY.seconds_per_step
                                          / MEMORY.temporal_tau)).item()
        _, grads, summary, gap = ref.loss_and_grads(
            r, dict(label_smoothing=TRAIN.label_smoothing,
                    entropy_lambda=TRAIN.entropy_lambda), ids, ids, rows,
            rec.slots, rec.choices(MODEL), biases, temporal)
        assert gap == 0.0
        _adamw(P, grads, mu, nu, step, TRAIN)
        for i, picks in zip(moe_idx, rec.picks):
            load = torch.bincount(picks.reshape(-1),
                                  minlength=MODEL.n_routed_experts).float()
            bias[i] += MODEL.router_bias_rate * torch.sign(load.mean() - load)
            got = model.layers[i].ffn.gate.e_score_correction_bias
            assert torch.equal(got, bias[i])
            assert not model.layers[i].ffn.step_load.any()
        if step % TRAIN.memory_store_interval == 0:
            at = torch.arange(B) % rows.shape[0]
            rows[at] = summary       # the bank's oldest rows: 0 and 1
    # Adam's first steps are about the sign of each entry's gradient: an
    # entry whose gradient is rounding (an embedding row no id reached)
    # moves at random, so each leaf is held by the norm of its error
    for n, p in model.named_parameters():
        err = (p.detach() - P[n]).norm() / P[n].norm()
        assert err <= 1e-4, (n, err)
    moved = sum((p.detach() - q).abs().sum().item() for p, q in
                zip(model.parameters(),
                    _trainer(seed=5).model.parameters()))
    assert moved > 0


def _share(x, m_full, state, offset, held):
    """The MoE layer of the share holding experts offset .. offset +
    held - 1, with the full layer's weights."""
    m = dataclasses.replace(m_full, experts_held=held, experts_offset=offset)
    moe = MoEFFN(m, device="cpu")
    with torch.no_grad():
        for n, p in moe.named_parameters():
            full = state[n]
            p.copy_(full[offset:offset + held] if n.startswith("experts.")
                    else full)
    return moe(x), moe


# Moonlight's layer: 16 experts in four shares of 4, top 3 (its case as
# it was); Kimi-Linear's: 32 experts (256 published) in four shares of 8,
# top 8, 1 shared, width 16, hidden 64
SHARES = {
    "moonlight": (MODEL, ref.Moonlight, 4),
    "kimi_linear": (KimiLinearConfig(
        vocab_size=256, embedding_dim=64, num_layers=2, num_heads=4,
        intermediate_size=96, max_seq_len=L, n_routed_experts=32,
        experts_held=8, num_experts_per_tok=8, n_shared_experts=1,
        moe_intermediate_size=16, routed_scaling_factor=2.446,
        dtype="float32", kda_layers=(0,)), kimi_ref.KimiLinear, 4)}


@pytest.mark.parametrize("model", list(SHARES))
def test_shares_of_the_experts_add_up_to_the_uncut_layer(model):
    """Four shares of the experts (the shared expert, the router and
    everything else counted once) add up to the uncut reference's MoE
    layer over all of them."""
    cfg, reference, n_shares = SHARES[model]
    E = cfg.n_routed_experts
    held = E // n_shares
    full = dataclasses.replace(cfg, experts_held=E, experts_offset=0)
    torch.manual_seed(4)
    whole = MoEFFN(full, device="cpu")
    port.models.layers.initialize(whole, torch.Generator().manual_seed(2))
    state = dict(whole.named_parameters())
    x = torch.randn(B, L, cfg.embedding_dim)
    outs, shared = [], None
    for s in range(n_shares):
        y, moe = _share(x, full, state, held * s, held)
        outs.append(y.detach())
        shared = moe.shared_experts(x).detach()
    total = sum(outs) - (n_shares - 1) * shared
    top, _ = whole.route(x.reshape(-1, cfg.embedding_dim))
    P = {f"layers.1.ffn.{n}": p.detach() for n, p in state.items()}
    r = reference(P, dataclasses.asdict(full), {})
    want = r.moe(x, "layers.1", top.view(B, L, -1))
    _close(total, want, 2e-5, "sum of shares")
    # and a share alone is not the whole layer
    assert (outs[0] - want).abs().max() > 1e-2


def _expert_case(skew, T=96, D=64, I=24, held=8, off=8, k=6):
    """Inputs of the held experts in bf16 under a bias that sends every
    token to the held experts (skew 10: T * k picks, the buffer's worst
    case), to none of them (-10), or neither (0)."""
    gen = torch.Generator().manual_seed(int(skew) + 20)
    x = torch.randn(T, D, generator=gen).bfloat16().requires_grad_(True)
    w13 = (torch.randn(held, 2 * I, D, generator=gen) / 8).bfloat16() \
        .requires_grad_(True)
    w2 = (torch.randn(held, D, I, generator=gen) / 5).bfloat16() \
        .requires_grad_(True)
    bias = torch.zeros(64)
    bias[off:off + held] = skew
    s = torch.rand(T, 64, generator=gen)
    top = torch.topk(s + bias, k).indices
    w = s.gather(-1, top).requires_grad_(True)
    g = torch.randn(T, D, generator=gen)
    return x, w13, w2, top, w, off, g


def _grouped_matches_the_loop(x, w13, w2, top, w, off, g, picked):
    y1 = ex.held_experts_grouped(x, w13, w2, top, w, off)
    y2 = ex.held_experts_loop(x, w13, w2, top, w, off)
    assert torch.isfinite(y1.float()).all()
    _close(y1.float(), y2.float(), 1e-2, "grouped forward")
    got = torch.autograd.grad((y1.float() * g).sum(), [x, w13, w2, w])
    if picked == 0:                     # nothing here: a zero output
        assert not y1.float().any() and not y2.float().any()
        assert all(not a.float().any() for a in got)
        return
    want = torch.autograd.grad((y2.float() * g).sum(), [x, w13, w2, w])
    for a, b, n in zip(got, want, ["x", "w13", "w2", "w"]):
        assert torch.isfinite(a.float()).all(), n
        _close(a.float(), b.float(), 2e-2, n)       # bf16 products


@pytest.mark.parametrize("skew", [0.0, 10.0, -10.0])
def test_grouped_experts_drop_no_token(skew):
    """The grouped products (bf16, `torch._grouped_mm`) against the plain
    loop, forward and backward, under a bias that sends every token to the
    held experts (skew 10: T * k picks, the buffer's worst case), to none
    of them (-10), or neither: no pick is lost."""
    x, w13, w2, top, w, off, g = _expert_case(skew)
    T, k = top.shape
    held = w13.shape[0]
    plan = ex.dispatch_plan(top, held, off)
    picked = ((top >= off) & (top < off + held)).sum().item()
    assert (plan.pos < plan.src.shape[0]).sum().item() == picked
    assert (plan.src >= 0).sum().item() == picked
    if skew > 0:
        assert picked == T * k
    assert plan.src.shape[0] == ex.capacity(T, k, held)
    _grouped_matches_the_loop(x, w13, w2, top, w, off, g, picked)


@pytest.mark.parametrize("skew", [0.0, 10.0, -10.0])
@pytest.mark.parametrize("plain", [
    "gather_rows_plain", "swiglu_plain", "combine_plain",
    "grad_gather_plain", "swiglu_bwd_plain"])
def test_each_expert_pass_touches_only_the_filled_rows(monkeypatch, plain,
                                                        skew):
    """Each pass's plain version (the CPU path of the grouped Function)
    with every row buffer NaN from the start: its rows from the groups'
    end up to the buffer's size stay NaN (never written), its filled rows
    are finite, and the grouped output and its gradients still match the
    loop (no pass read a NaN row)."""
    x, w13, w2, top, w, off, g = _expert_case(skew)
    T, k = top.shape
    held = w13.shape[0]
    R = ex.capacity(T, k, held)
    n = int(ex.dispatch_plan(top, held, off).offs[-1])
    assert n < R                         # ragged at every skew
    monkeypatch.setattr(ex, "_rows", lambda R, width, like: torch.full(
        (R, width), float("nan"), dtype=like.dtype, device=like.device))
    outs = []
    real = getattr(ex, plain)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        outs.extend(out if isinstance(out, tuple) else (out,))
        return out

    monkeypatch.setattr(ex, plain, spy)
    picked = ((top >= off) & (top < off + held)).sum().item()
    _grouped_matches_the_loop(x, w13, w2, top, w, off, g, picked)
    assert outs, plain
    for t in outs:
        if t.shape[0] == R:
            assert torch.isnan(t[n:].float()).all(), plain
            assert torch.isfinite(t[:n].float()).all(), plain
        else:                            # per token: [T, D] or [T, k]
            assert torch.isfinite(t.float()).all(), plain


def test_the_block_refuses_a_kv_cache():
    model = port.HippocampalTransformer(MODEL, MEMORY, device="cpu")
    with pytest.raises(NotImplementedError):
        model.init_kv_caches(1, 8)
    with pytest.raises(ValueError):
        model(_ids(0), kv_caches=(), cache_index=0)
    with pytest.raises(ValueError):
        port.HippocampalTransformer(dataclasses.replace(
            MODEL, tie_word_embeddings=True), MEMORY, device="cpu")


def test_the_reference_imports_only_torch():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(ref))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"torch", "__future__", "typing"}, names
