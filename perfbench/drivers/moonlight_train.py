"""Training steps of the Moonlight LM (DeepSeek-V3's block) with episodic
memory live, on one chip's share of its experts and vocabulary.

The configuration is the published `config.json`'s keys (its cut listed
in `BENCHMARK.json`'s `reduced`), the deployment it stands for, the
port's settings, the memory and the training groups; `configs` turns
them into the port's `DeepSeekV3Config`. `Trainer.train_step(ids,
labels)` runs back to back on batches of `batch` x `seq` token ids drawn
uniformly over the vocabulary slice from the seed (labels = ids), with
the trainer's bank holding the full bank of rows drawn from the seed and
its index built (`lm_train.build_bank`), so every step's retrieval (B x
probe x bucket under the bank's rows: kernel B and the annex pass,
forward and backward) and every `memory_store_interval`-th step's write
meet a live index. The window covers whole steps and ends on a device
sync; `train_tokens_per_s` is its tokens over its time.

Set-up builds one `Trainer`, copies in the weights the benchmark drew
(`moonlight_plain.param_spec`), puts the bank in place and drives the
first `checked_steps` steps through `train_step` as the window would,
keeping each memory layer's query and rows (a wrapper on
`engine.retrieve_auto`), each MoE layer's picks (a wrapper on each
`MoEFFN.route`), each step's loss, the first step's clipped gradient
(mu / (1 - b1)) and the weights' change over the steps, per leaf as
norms. The device's memory peak is reset before the window, so
`memory_peak_bytes` is the training's. In traced runs the program's spans
are on (`program_trace.SpanProfiler`), the harness's `train_step` span is
opened, a bounded number of steps is profiled, and each MoE layer's
expert tally (`MoEFFN.load_tally`) is read before and after the traced
steps (outside them).

The check (`reference.moonlight_train`, f32 with TF32 off, sequence by
sequence with every layer recomputed in the backward), once the window
has closed and the trainer is freed, follows the checked steps with the
program's rows and picks:
- `grad_err` and `change_err`: as `lm_train` computes them (the median
  leaf's gap of the first clipped gradient's and of the change's norms);
- `expert_err`: the held experts' own leaves (each MoE layer's
  `gate_up_proj` and `down_proj`, 16 of 171), which the median leaf
  does not see: the widest relative gap of their first clipped
  gradient's and change's norms;
- `ret_gap`: `lm_train`'s measure (the widest gap, at any rank, by which
  the retrieved rows' exact scores lie below the exact top-k's, over the
  bank's rows as the step met them) taken over the rows the IVF index
  offers the query: the live rows of its nearest `probe_centroids`
  clusters (by L2 to the index's centroids, in f64) and of the overflow
  annex, as the index stood at the call (its centroids and each slot's
  row, kept by the wrapper). At this bank a query from the model's hidden
  states finds most of its exact top 5 over the whole bank outside the
  probed clusters (PERF.md), so the whole-bank measure would judge the
  index and not the retrieval;
- `route_gap`: per token, how far the least of the program's picked
  experts' biased scores lies below the reference's own k-th best biased
  score, the widest over every token, MoE layer and step (0 where the
  program's picks are the reference's top k; ties and near-ties to the
  program's bf16 rounding read small).
The steps' loss gap is printed and not compared.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import sys
import time

import torch

from perfbench import core, data, trace
from perfbench.counts import moonlight as counts
from perfbench.drivers import lm_train
from perfbench.reference import (engine_exact, moonlight_plain,
                                 moonlight_train)

# the run seed's streams (lm_train's: rows 1, index 6, trainer 10)
PARAMS, TOKENS = 12, 13
B1 = 0.9
# the held experts' leaves
EXPERT_LEAVES = (".ffn.experts.gate_up_proj", ".ffn.experts.down_proj")

# the published config's keys -> the port's `DeepSeekV3Config` fields
KEYS = {"hidden_size": "embedding_dim", "num_hidden_layers": "num_layers",
        "num_attention_heads": "num_heads",
        "intermediate_size": "intermediate_size",
        "max_position_embeddings": "max_seq_len", "vocab_size": "vocab_size",
        "kv_lora_rank": "kv_lora_rank",
        "qk_nope_head_dim": "qk_nope_head_dim",
        "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
        "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
        "first_k_dense_replace": "first_k_dense_replace",
        "n_routed_experts": "experts_held",
        "num_experts_per_tok": "num_experts_per_tok",
        "n_shared_experts": "n_shared_experts",
        "moe_intermediate_size": "moe_intermediate_size",
        "routed_scaling_factor": "routed_scaling_factor",
        "tie_word_embeddings": "tie_word_embeddings"}
# what the port's block implements of the published config
REQUIRED = {"model_type": "deepseek_v3", "q_lora_rank": None,
            "hidden_act": "silu", "topk_method": "noaux_tc", "n_group": 1,
            "topk_group": 1, "moe_layer_freq": 1, "attention_bias": False,
            "num_nextn_predict_layers": 0, "scoring_func": "sigmoid",
            "norm_topk_prob": True}


def configs(run):
    """(model dict of `DeepSeekV3Config` fields, memory dict, training
    dict, `AuraConfig`), with the test sizes' overrides."""
    from aura_snn_rag_tpu_torch.config import (
        AuraConfig, DeepSeekV3Config, MemoryConfig, TrainingConfig)
    c = run.config
    for k, v in REQUIRED.items():
        if c.get(k) != v:
            raise core.BenchError(f"{k} {c.get(k)!r}: the port's block "
                                  f"takes {v!r}")
    if c["num_key_value_heads"] != c["num_attention_heads"]:
        raise core.BenchError("latent attention has a key per head")
    dep = c["deployment"]
    m = {port: c[key] for key, port in KEYS.items()}
    m.update(c["port"], n_routed_experts=dep["router_experts"],
             experts_offset=dep["experts_offset"],
             router_bias_rate=c["training"]["router_bias_rate"])
    m.update(run.sizes.get("model", {}))
    mc = DeepSeekV3Config(**m)
    m = dataclasses.asdict(mc)
    mem = dict(c["memory"], **run.sizes.get("memory", {}))
    t = {k: v for k, v in c["training"].items() if k != "router_bias_rate"}
    t.update(run.sizes.get("training", {}))
    cfg = AuraConfig(model=mc, memory=MemoryConfig(**mem),
                     training=TrainingConfig(**t))
    return m, mem, dict(t, router_bias_rate=m["router_bias_rate"]), cfg


def weights(run, m):
    return data.params(moonlight_plain.param_spec(m), run.device,
                       core.sub_seed(run.seed, PARAMS))


def feed(run, m, tr, n):
    """[n, batch, seq] token ids, uniform over the vocabulary slice."""
    gen = data.generator(run.device, core.sub_seed(run.seed, TOKENS))
    return torch.randint(0, m["vocab_size"], (n, tr["batch"], tr["seq"]),
                         device=run.device, generator=gen)


class Recorder:
    """Stands in for `engine.retrieve_auto` (each call's query and slots),
    for each MoE layer's `route` (its picks) and for the optimizer's
    `step` (each loss) while `on`."""

    def __init__(self, retrieve, opt_step, moes):
        self.retrieve, self.opt_step = retrieve, opt_step
        self.on = False
        self.calls, self.picks, self.losses = [], [], []
        for moe in moes:
            moe.route = self._route(moe.route)

    def _route(self, route):
        def keep(x):
            top, w = route(x)
            if self.on:
                self.picks.append(top.detach().clone())
            return top, w
        return keep

    def retrieve_auto(self, config, state, queries, query_locations=None,
                      k=5):
        res = self.retrieve(config, state, queries, query_locations, k)
        if self.on:
            live = (state.cluster_gen >= 0) & (
                state.cluster_gen >= state.count - state.max_memories)
            index = (state.centroids.clone(),
                     torch.where(live, state.cluster_slot, -1))
            self.calls.append((queries.detach().clone(),
                               res.indices.detach().clone(), index))
        return res

    def step(self, loss, lr_scale=1.0):
        if self.on:
            self.losses.append(loss.detach().clone())
        return self.opt_step(loss, lr_scale)


def build(run, cfg, params):
    from aura_snn_rag_tpu_torch.training.trainer import Trainer
    trainer = Trainer(cfg, seed=lm_train.trainer_seed(run),
                      device=run.device)
    names = dict(trainer.model.named_parameters())
    if set(names) != set(params):
        raise core.BenchError(
            f"the model's parameters differ from the reference's: "
            f"{sorted(set(names) ^ set(params))[:6]}")
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(params[name])              # views of the flat buffer
    return trainer


def _span_profiler():
    """`program_trace.SpanProfiler`, or, inside `program_trace.py`'s own
    run (which puts its SpanProfiler in `trace.Profiler`'s place), that
    one."""
    if isinstance(trace.Profiler, functools.partial):
        return trace.Profiler
    from perfbench.program_trace import SpanProfiler
    return SpanProfiler


def _allocator(dev) -> None:
    """The caching allocator with expandable segments, as large training
    jobs run it (PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True): the
    step's 4.5 GB optimizer temporaries and [R, .] expert buffers beside
    the activations of 32,768 tokens otherwise strand ~27 GB in segments
    too small for the next 4.5 GB block (an out-of-memory on the card at
    48 GB in use). Set before the run's first allocation."""
    if dev.type == "cuda":
        setting = getattr(torch._C, "_accelerator_setAllocatorSettings",
                          None) or torch.cuda.memory._set_allocator_settings
        setting("expandable_segments:True")


def _memory_events(dev) -> dict:
    """The caching allocator's counts of device mappings and of retries
    after a failed allocation (each retry frees every cached block)."""
    stats = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
    return {k: stats.get(k, 0) for k in ("num_alloc_retries",
                                         "num_device_alloc",
                                         "num_device_free")}


def _held(moes, m) -> float:
    """The held experts' assignments tallied so far, over every layer."""
    lo, n = m["experts_offset"], m["experts_held"]
    return sum(float(moe.load_tally[lo:lo + n].sum()) for moe in moes)


def run(run: core.Run) -> core.Outcome:
    from aura_snn_rag_tpu_torch.memory import engine

    tr = run.traffic
    dev = run.device
    m, mem, t, cfg = configs(run)
    n_check = int(tr["checked_steps"])
    n_feed = int(run.sizes.get("feed_steps", tr["feed_steps"]))

    # ---- set-up ---------------------------------------------------------
    stages = [("start", run.setup_s())]
    _allocator(dev)
    params = weights(run, m)
    trainer = build(run, cfg, params)
    del params              # drawn again from the seed when needed
    stages.append(("trainer", run.setup_s()))
    trainer.hippocampus.state = lm_train.build_bank(run, cfg.memory)
    batches = feed(run, m, tr, n_feed)
    stages.append(("bank", run.setup_s()))
    opt = trainer.optimizer
    moes = trainer.model.moe_layers
    real_retrieve = engine.retrieve_auto
    rec = Recorder(real_retrieve, opt.step, moes)
    engine.retrieve_auto = rec.retrieve_auto
    opt.step = rec.step
    prof = _span_profiler()(run.trace, dev)
    traced = None
    trace_steps = int(run.sizes.get("trace_steps", tr["trace_steps"]))
    leaves = [(k, p.numel()) for k, p in trainer.model.named_parameters()]
    try:
        calls, picks = [], []
        rec.on = True
        for s in range(n_check):
            rec.calls, rec.picks = [], []
            trainer.train_step(batches[s], batches[s])
            calls.append(rec.calls)
            picks.append(rec.picks)
            if s == 0:
                grad0 = lm_train._by_leaf(opt.state.mu.float() / (1 - B1),
                                          leaves)
        rec.on = False
        stages.append(("checked steps", run.setup_s()))
        change = {}
        params = weights(run, m)
        with torch.no_grad():
            for name, p in trainer.model.named_parameters():
                change[name] = (p - params[name]).norm().item()
        del params
        losses = torch.stack(rec.losses).float().cpu()
        if dev.type == "cuda":
            # no empty_cache(): the window's first steps would map the
            # freed blocks again, 2 MB at a time, which stalls the host
            # for seconds under the profiler
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        held0 = _held(moes, m)
        setup_s = run.setup_s()
        stages.append(("change", setup_s))
        print("perfbench: set-up stages (s): " + ", ".join(
            f"{a} {t - t0:.2f}" for (_, t0), (a, t) in zip(stages,
                                                          stages[1:]))
            + f" (imports and card {stages[0][1]:.2f})", file=sys.stderr)
        mem0 = _memory_events(dev)

        # ---- the window -------------------------------------------------
        n = 0
        core.quiet_gc()
        prof.start()
        t0 = time.perf_counter()
        while True:
            ids = batches[(n_check + n) % n_feed]
            with run.span("bench:train_step"):
                trainer.train_step(ids, ids)
            n += 1
            if run.trace and n >= trace_steps:
                break
            if not run.trace and time.perf_counter() - t0 >= run.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        traced = prof.stop()
        print("perfbench: the window's allocator events: " + ", ".join(
            f"{k} {v - mem0[k]}" for k, v in _memory_events(dev).items()),
            file=sys.stderr)
        held = _held(moes, m) - held0
    finally:
        engine.retrieve_auto = real_retrieve
        opt.__dict__.pop("step", None)
        for moe in moes:                # the wrappers close over them
            moe.__dict__.pop("route", None)
        prof.stop()

    B, L = tr["batch"], tr["seq"]
    e2e = {"train_tokens_per_s": n * B * L / window_s, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    window_counts = {
        "model_flops": n * counts.train_flops(m, B, L, held / max(n, 1)),
        "expert_flops": 3.0 * counts.expert_flops(m, held),
        "mla_core_flops": n * m["num_layers"]
        * counts.attention_core_flops(m, B, L),
        "steps": n, "held_assignments": held}
    first = m["first_k_dense_replace"]
    program = {"losses": losses, "grad": grad0, "change": change,
               "calls": calls,
               "choices": [[None] * first + [c.view(B, L, -1) for c in p]
                           for p in picks]}
    del trainer, opt, rec, moes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(run, (m, mem, t), batches[:n_check], program)
    return core.Outcome(e2e, checks, attempted=n, failed=0,
                        memory_peak_bytes=peak, trace=traced,
                        counts=window_counts)


def _slots(program):
    """Per step, each memory layer's [N, k] retrieved slots."""
    return [[c[1].clamp(min=0) for c in step] for step in program["calls"]]


def _reference(run, cfgs, feed_batches, program, choices, linear,
               half_batch=False):
    m, mem, t = cfgs
    rows = lm_train.bank_rows(run, configs(run)[3].memory)
    moonlight_plain.tf32_off()
    with engine_exact.tf32(False):
        res = moonlight_train.train_steps(
            weights(run, m), m, mem, t, feed_batches, rows, _slots(program),
            choices, linear, half_batch=half_batch)
    return res, rows


def _as_numbers(res, P0):
    return {"losses": res["losses"],
            "grad": {k: v.norm().item() for k, v in res["grad"].items()},
            "change": {k: (res["params"][k] - P0[k]).norm().item()
                       for k in P0}}


def _route(run, gap):
    return core.Check("route_gap", gap, run.config["limits"]["route_gap"])


def _experts(run, ref, got):
    """`expert_err` of `got` against `ref` (`_as_numbers`' dicts): the
    widest |got - ref| / ref over the held experts' leaves, of the first
    clipped gradient's norms and of the change's. The worst leaf is
    printed."""
    gaps = {(what, k): abs(got[what][k] - r) / r
            for what in ("grad", "change")
            for k, r in ref[what].items() if k.endswith(EXPERT_LEAVES)}
    worst = max(gaps, key=gaps.get)
    print(f"perfbench: expert leaves' worst {worst[0]} {worst[1]}: gap "
          f"{gaps[worst]!r}", file=sys.stderr)
    return core.Check("expert_err", gaps[worst],
                      run.config["limits"]["expert_err"])


def _train_numbers(run, ref, got):
    return lm_train._numbers(run, ref, got) + [_experts(run, ref, got)]


def judge(run, cfgs, feed_batches, program):
    """The compared numbers of the checked steps."""
    ref, rows = _reference(run, cfgs, feed_batches, program,
                           program["choices"], moonlight_plain.plain_linear)
    got = {"losses": program["losses"].tolist(), "grad": program["grad"],
           "change": program["change"]}
    banks = lm_train._banks(rows, ref["writes"], len(program["calls"]))
    P0 = weights(run, cfgs[0])
    return (_train_numbers(run, _as_numbers(ref, P0), got)
            + [_retrieval(run, cfgs, banks, program["calls"], "program")]
            + [_route(run, max(ref["route_gaps"]))])


def judge_control(run, cfgs, feed_batches, program):
    """The control: the reference with fp8 products (`lm_plain.fp8_linear`,
    forward and backward) routing by its own picks, judged against the f32
    reference that follows those picks; and retrieval by products whose
    inputs are rounded to TF32."""
    from perfbench.reference import lm_plain
    low, rows = _reference(run, cfgs, feed_batches, program, None,
                           lm_plain.fp8_linear)
    ref, _ = _reference(run, cfgs, feed_batches, program, low["picks"],
                        moonlight_plain.plain_linear)
    P0 = weights(run, cfgs[0])
    banks = lm_train._banks(rows, ref["writes"], len(program["calls"]))
    return (_train_numbers(run, _as_numbers(ref, P0), _as_numbers(low, P0))
            + [_retrieval(run, cfgs, banks, program["calls"], "control",
                          tf32=True)]
            + [_route(run, max(ref["route_gaps"]))])


def _offered(mem, index, q):
    """The slots the IVF index offers query q [D]: the live rows of its
    nearest P clusters by L2 to the centroids (f64) and of the annex."""
    cent, slots = index
    K = cent.shape[0]
    G = min(mem["overflow_buckets"], K // 4)
    P = min(mem["probe_centroids"], K - G)
    c = cent.double()
    d = (c * c).sum(-1) - 2.0 * (c @ q.double())
    top = torch.topk(-d, P).indices
    cand = torch.cat([slots[top].reshape(-1), slots[K - G:].reshape(-1)])
    return torch.unique(cand[cand >= 0]).long()


def _retrieval(run, cfgs, banks, calls, what: str, tf32: bool = False):
    """`ret_gap` of the rows retrieved in `calls` (per step, each memory
    layer's (query, slots, index)) over the rows the index offered each
    query, by f64 cosine over the step's bank; with `tf32`, of the
    answers the control gives instead: the offered rows' top k by
    products whose inputs are rounded to TF32. The exact top-k rows
    missed are printed beside it."""
    m, mem, _ = cfgs
    k = int(m["num_retrieved"])
    gap, missed, total = 0.0, 0, 0
    for bank, step_calls in zip(banks, calls):
        for q, got_slots, index in step_calls:
            for b in range(q.shape[0]):
                cand = _offered(mem, index, q[b]).to(bank.device)
                rows = bank[cand].double()
                rows = rows * torch.rsqrt((rows * rows).sum(-1, keepdim=True)
                                          + 1e-12)
                qb = q[b].double() / q[b].double().norm()
                cos = rows @ qb
                top, at = torch.topk(cos, k)
                if tf32:
                    r = engine_exact.round_tf32(rows.float())
                    pick = torch.topk(r @ engine_exact.round_tf32(
                        qb.float()[:, None])[:, 0], k).indices
                    ans = cand[pick]
                else:
                    ans = got_slots[b].long().to(bank.device)
                if bool((ans < 0).any()):
                    gap = float("inf")
                    continue
                u = bank[ans].double()
                u = u * torch.rsqrt((u * u).sum(-1, keepdim=True) + 1e-12)
                have = (u @ qb).sort(descending=True).values
                gap = max(gap, float((top - have).max()))
                missed += int((~torch.isin(cand[at], ans)).sum())
                total += k
    print(f"perfbench: {what} retrieval: {missed} of {total} exact top-{k} "
          f"offered rows missed (not compared)", file=sys.stderr)
    return core.Check("ret_gap", mem["w_cosine"] * gap,
                      run.config["limits"]["ret_gap"])


def judge_faults(run, cfgs, feed_batches, program):
    """The numbers of a fault a training step can have, put in the
    program's place: half of the batch left out (the loss's mean over the
    other half), following the program's rows and picks. A step that
    returns its state unchanged reads 1 on `change_err` by the measure
    itself; rows or picks altered where they are produced are read by
    the tests (`perfbench/test_perfbench_moonlight.py`)."""
    ref, _ = _reference(run, cfgs, feed_batches, program,
                        program["choices"], moonlight_plain.plain_linear)
    half, _ = _reference(run, cfgs, feed_batches, program,
                         program["choices"], moonlight_plain.plain_linear,
                         half_batch=True)
    P0 = weights(run, cfgs[0])
    return {"half_batch": _train_numbers(run, _as_numbers(ref, P0),
                                         _as_numbers(half, P0))}
