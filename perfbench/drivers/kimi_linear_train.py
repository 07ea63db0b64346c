"""Training steps of the Kimi-Linear LM (Kimi Delta Attention beside NoPE
latent attention, DeepSeek-V3's MoE) with episodic memory live, on one
chip's share of its experts and vocabulary.

The run is `moonlight_train`'s (its recorder, trainer, bank, allocator
and the check's retrieval and routing measures are taken from there) on
this configuration: the published `config.json`'s keys (its cut listed in
`BENCHMARK.json`'s `reduced`), the deployment it stands for, the port's
settings, the memory and the training groups; `configs` turns them into
the port's `KimiLinearConfig` (`linear_attn_config`'s 1-based
`kda_layers` become 0-based). `Trainer.train_step(ids, labels)` runs
back to back on batches of `batch` x `seq` token ids drawn uniformly over
the vocabulary slice from the seed (labels = ids), every step's retrieval
and every `memory_store_interval`-th step's write meeting a live index.
The window covers whole steps and ends on a device sync;
`train_tokens_per_s` is its tokens over its time.

The check (`reference.kimi_linear_train`, f32 with TF32 off, sequence by
sequence with every layer recomputed in the backward, Kimi Delta
Attention chunk by chunk), once the window has closed and the trainer is
freed, follows the checked steps with the program's rows and picks:
`grad_err`, `change_err` and `expert_err` as `moonlight_train` computes
them; `kda_err`, the same measure as `expert_err` over the KDA layers'
own leaves (`A_log`, `dt_bias`, the convolutions, the gate's, the output
gate's and beta's projections; the change's without `A_log`, see
`KDA_LEAVES`), which the median leaf does not see; `kda_core_err`, the
first KDA layer's core on the first checked step (its inputs and output
as the program had them) against the reference's core in f32 on the
same inputs, which sees the precision of the core's state that the
model's numbers do not (a state rounded to bf16 decays within a few
tokens at these gates, under the bf16 noise of the rest); `ret_gap` and
`route_gap` as `moonlight_train` measures them.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from perfbench import core, data
from perfbench.counts import kimi_linear as counts
from perfbench.counts import moonlight as moon_counts
from perfbench.drivers import lm_train, moonlight_train as moon
from perfbench.reference import (engine_exact, kimi_linear_plain,
                                 kimi_linear_train)

# the run seed's streams (lm_train's: rows 1, index 6, trainer 10;
# moonlight_train's: weights 12, tokens 13)
PARAMS, TOKENS, DECAYS = 12, 13, 14
B1 = 0.9
# the KDA layers' own leaves; `kda_err` reads the change of all but the
# first: over the checked steps the learning rate is 0, then lr /
# warmup_steps (5e-8), under one f32 ulp of most of A_log's entries
# (0.7-2.8), so each moves by 0 or 1 ulp as rounding decides and its
# change norm counts ulps (`_ulps` prints them)
KDA_LEAVES = (".A_log", ".dt_bias", "_conv1d.weight", ".f_a_proj.weight",
              ".f_b_proj.weight", ".g_a_proj.weight", ".g_b_proj.weight",
              ".b_proj.weight")

# the published config's keys -> the port's `KimiLinearConfig` fields
KEYS = {"hidden_size": "embedding_dim", "num_hidden_layers": "num_layers",
        "num_attention_heads": "num_heads",
        "intermediate_size": "intermediate_size",
        "model_max_length": "max_seq_len", "vocab_size": "vocab_size",
        "kv_lora_rank": "kv_lora_rank",
        "qk_nope_head_dim": "qk_nope_head_dim",
        "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
        "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
        "first_k_dense_replace": "first_k_dense_replace",
        "num_experts": "experts_held",
        "num_experts_per_token": "num_experts_per_tok",
        "num_shared_experts": "n_shared_experts",
        "moe_intermediate_size": "moe_intermediate_size",
        "routed_scaling_factor": "routed_scaling_factor",
        "tie_word_embeddings": "tie_word_embeddings",
        "mla_use_nope": "mla_use_nope"}
LINEAR = {"num_heads": "kda_num_heads", "head_dim": "kda_head_dim",
          "short_conv_kernel_size": "short_conv_kernel_size"}
CHUNK = 64               # the reference core's chunk for `kda_core_err`
# what the port's block implements of the published config
REQUIRED = {"model_type": "kimi_linear", "q_lora_rank": None,
            "hidden_act": "silu", "num_expert_group": 1, "topk_group": 1,
            "use_grouped_topk": True, "moe_layer_freq": 1,
            "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
            "num_nextn_predict_layers": 0, "rope_scaling": None}


def configs(run):
    """(model dict of `KimiLinearConfig` fields, memory dict, training
    dict, `AuraConfig`), with the test sizes' overrides."""
    from aura_snn_rag_tpu_torch.config import (
        AuraConfig, KimiLinearConfig, MemoryConfig, TrainingConfig)
    c = run.config
    for k, v in REQUIRED.items():
        if c.get(k) != v:
            raise core.BenchError(f"{k} {c.get(k)!r}: the port's block "
                                  f"takes {v!r}")
    if c["num_key_value_heads"] != c["num_attention_heads"]:
        raise core.BenchError("latent attention has a key per head")
    lin = c["linear_attn_config"]
    n_layers = c["num_hidden_layers"]
    if sorted(lin["kda_layers"] + lin["full_attn_layers"]) != list(
            range(1, n_layers + 1)):
        raise core.BenchError("every layer is KDA or full, once")
    dep = c["deployment"]
    m = {port: c[key] for key, port in KEYS.items()}
    m.update({port: lin[key] for key, port in LINEAR.items()})
    m.update(c["port"], n_routed_experts=dep["router_experts"],
             experts_offset=dep["experts_offset"],
             kda_layers=tuple(i - 1 for i in lin["kda_layers"]),
             router_bias_rate=c["training"]["router_bias_rate"])
    m.update(run.sizes.get("model", {}))
    m["kda_layers"] = tuple(m["kda_layers"])
    mc = KimiLinearConfig(**m)
    m = dataclasses.asdict(mc)
    mem = dict(c["memory"], **run.sizes.get("memory", {}))
    t = {k: v for k, v in c["training"].items() if k != "router_bias_rate"}
    t.update(run.sizes.get("training", {}))
    cfg = AuraConfig(model=mc, memory=MemoryConfig(**mem),
                     training=TrainingConfig(**t))
    return m, mem, dict(t, router_bias_rate=m["router_bias_rate"]), cfg


def weights(run, m):
    """The weights from the seed (`kimi_linear_plain.param_spec`): every
    "log_uniform" tensor (`A_log`) drawn as log U(1, scale) from a stream
    of its own."""
    spec = kimi_linear_plain.param_spec(m)
    P = data.params([(n, s, "const", 0.0) if i == "log_uniform"
                     else (n, s, i, x) for n, s, i, x in spec], run.device,
                    core.sub_seed(run.seed, PARAMS))
    gen = data.generator(run.device, core.sub_seed(run.seed, DECAYS))
    for name, shape, init, scale in spec:
        if init == "log_uniform":
            P[name] = torch.empty(shape, device=run.device).uniform_(
                1.0, scale, generator=gen).log_()
    return P


class _CoreTap:
    """Wraps `models.layers.kda` (the KDA layers' core): while `on`, keeps
    the first call's inputs and output on the host, for `kda_core_err`."""

    def __init__(self, real):
        self.real, self.on, self.seen = real, False, None

    def __call__(self, q, k, v, g, beta):
        o = self.real(q, k, v, g, beta)
        if self.on and self.seen is None:
            self.seen = [t.detach().cpu() for t in (q, k, v, g, beta, o)]
        return o


def _ulps(P, P0, who):
    """Prints how far `P`'s A_log entries moved from `P0`'s, in f32 ulps
    of their start (see `KDA_LEAVES`)."""
    moves = []
    for k, p0 in P0.items():
        if k.endswith(".A_log"):
            p0 = p0.detach().float()
            a = p0.abs()
            ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
            moves.append(((P[k].detach().float() - p0).abs() / ulp)
                         .flatten())
    if moves:
        d = torch.cat(moves)
        print(f"perfbench: {who}'s A_log over the checked steps: "
              f"{int((d > 0).sum())} of {d.numel()} entries moved, by at "
              f"most {d.max().item():.3g} f32 ulps of their start",
              file=sys.stderr)


def run(run: core.Run) -> core.Outcome:
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.models import layers

    tr = run.traffic
    dev = run.device
    m, mem, t, cfg = configs(run)
    n_check = int(tr["checked_steps"])
    n_feed = int(run.sizes.get("feed_steps", tr["feed_steps"]))

    # ---- set-up ---------------------------------------------------------
    stages = [("start", run.setup_s())]
    moon._allocator(dev)
    params = weights(run, m)
    trainer = moon.build(run, cfg, params)
    del params              # drawn again from the seed when needed
    stages.append(("trainer", run.setup_s()))
    trainer.hippocampus.state = lm_train.build_bank(run, cfg.memory)
    batches = moon.feed(run, m, tr, n_feed)
    stages.append(("bank", run.setup_s()))
    opt = trainer.optimizer
    moes = trainer.model.moe_layers
    real_retrieve = engine.retrieve_auto
    rec = moon.Recorder(real_retrieve, opt.step, moes)
    engine.retrieve_auto = rec.retrieve_auto
    opt.step = rec.step
    real_kda = layers.kda
    tap = layers.kda = _CoreTap(real_kda)
    prof = moon._span_profiler()(run.trace, dev)
    traced = None
    trace_steps = int(run.sizes.get("trace_steps", tr["trace_steps"]))
    leaves = [(k, p.numel()) for k, p in trainer.model.named_parameters()]
    try:
        calls, picks = [], []
        rec.on = tap.on = True
        for s in range(n_check):
            rec.calls, rec.picks = [], []
            trainer.train_step(batches[s], batches[s])
            calls.append(rec.calls)
            picks.append(rec.picks)
            if s == 0:
                grad0 = lm_train._by_leaf(opt.state.mu.float() / (1 - B1),
                                          leaves)
        rec.on = tap.on = False
        stages.append(("checked steps", run.setup_s()))
        change = {}
        params = weights(run, m)
        with torch.no_grad():
            for name, p in trainer.model.named_parameters():
                change[name] = (p - params[name]).norm().item()
        _ulps(dict(trainer.model.named_parameters()), params, "the program")
        del params
        losses = torch.stack(rec.losses).float().cpu()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        held0 = moon._held(moes, m)
        setup_s = run.setup_s()
        stages.append(("change", setup_s))
        print("perfbench: set-up stages (s): " + ", ".join(
            f"{a} {t - t0:.2f}" for (_, t0), (a, t) in zip(stages,
                                                          stages[1:]))
            + f" (imports and card {stages[0][1]:.2f})", file=sys.stderr)
        mem0 = moon._memory_events(dev)

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
            f"{k} {v - mem0[k]}" for k, v in moon._memory_events(
                dev).items()), file=sys.stderr)
        held = moon._held(moes, m) - held0
    finally:
        engine.retrieve_auto = real_retrieve
        layers.kda = real_kda
        opt.__dict__.pop("step", None)
        for moe in moes:                # the wrappers close over them
            moe.__dict__.pop("route", None)
        prof.stop()

    B, L = tr["batch"], tr["seq"]
    e2e = {"train_tokens_per_s": n * B * L / window_s, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    n_kda = len(m["kda_layers"])
    window_counts = {
        "model_flops": n * counts.train_flops(m, B, L, held / max(n, 1)),
        "expert_flops": 3.0 * moon_counts.expert_flops(m, held),
        "mla_core_flops": n * (m["num_layers"] - n_kda)
        * moon_counts.attention_core_flops(m, B, L),
        "kda_core_flops": n * n_kda * 3.0 * counts.kda_core_flops(m, B, L),
        "kda_core_bytes": n * n_kda * counts.kda_core_bytes(m, B, L),
        "steps": n, "held_assignments": held}
    first = m["first_k_dense_replace"]
    program = {"losses": losses, "grad": grad0, "change": change,
               "calls": calls, "core": tap.seen,
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


def _reference(run, cfgs, feed_batches, program, choices, linear,
               kda_control=None):
    m, mem, t = cfgs
    rows = lm_train.bank_rows(run, configs(run)[3].memory)
    kimi_linear_plain.tf32_off()
    with engine_exact.tf32(False):
        res = kimi_linear_train.train_steps(
            weights(run, m), m, mem, t, feed_batches, rows,
            moon._slots(program), choices, linear, kda_control=kda_control)
    return res, rows


def _leaves(run, ref, got, name, ends, change_ends=None):
    """The widest |got - ref| / ref over the leaves whose names end with
    one of `ends`, of the first clipped gradient's norms, and of the
    change's over those that end with one of `change_ends` (default
    `ends`); the worst leaf of each is printed."""
    sets = {"grad": ends, "change": change_ends or ends}
    worst = {}
    for what, e in sets.items():
        gaps = {k: abs(got[what][k] - r) / r
                for k, r in ref[what].items() if k.endswith(e) and r > 0}
        k = max(gaps, key=gaps.get)
        worst[what] = gaps[k]
        print(f"perfbench: {name}'s worst {what} {k}: gap {gaps[k]!r}",
              file=sys.stderr)
    return core.Check(name, max(worst.values()),
                      run.config["limits"][name])


def _train_numbers(run, ref, got):
    return lm_train._numbers(run, ref, got) + [
        _leaves(run, ref, got, "expert_err", moon.EXPERT_LEAVES),
        _leaves(run, ref, got, "kda_err", KDA_LEAVES, KDA_LEAVES[1:])]


def _core(run, seen, control=None):
    """`kda_core_err`: max |o - want| / max |want| over the core's output
    on the inputs `seen` holds, `want` the reference's chunk by chunk in
    f32 and `o` the program's (`seen`'s last) or, under `control`, the
    reference's with that control."""
    *x, o = (t.to(run.device).float() for t in seen)
    kimi_linear_plain.tf32_off()
    with torch.no_grad():
        want = kimi_linear_plain.kda_chunks(*x, CHUNK)
        if control is not None:
            o = kimi_linear_plain.kda_chunks(*x, CHUNK, control)
    gap = ((o - want).abs().max() / want.abs().max()).item()
    return core.Check("kda_core_err", gap,
                      run.config["limits"]["kda_core_err"])


def _numbers(run, m, res, who=None):
    """`moonlight_train._as_numbers` of a reference's result, against the
    seed's weights drawn again; with `who`, A_log's moves are printed."""
    P0 = weights(run, m)
    if who:
        _ulps(res["params"], P0, who)
    return moon._as_numbers(res, P0)


def judge(run, cfgs, feed_batches, program):
    """The compared numbers of the checked steps."""
    t0 = time.perf_counter()
    ref, rows = _reference(run, cfgs, feed_batches, program,
                           program["choices"], kimi_linear_plain.plain_linear)
    got = {"losses": program["losses"].tolist(), "grad": program["grad"],
           "change": program["change"]}
    banks = lm_train._banks(rows, ref["writes"], len(program["calls"]))
    gap = max(ref["route_gaps"])
    ref = _numbers(run, cfgs[0], ref, "the reference")
    out = (_train_numbers(run, ref, got) + [_core(run, program["core"])]
           + [moon._retrieval(run, cfgs, banks, program["calls"],
                              "program")]
           + [moon._route(run, gap)])
    print(f"perfbench: the check took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return out


def judge_control(run, cfgs, feed_batches, program):
    """The control: the reference with fp8 products (`lm_plain.fp8_linear`,
    forward and backward) routing by its own picks, judged against the f32
    reference that follows those picks; and retrieval by products whose
    inputs are rounded to TF32. Each reference's result is reduced to its
    numbers before the next runs (two at once do not fit beside 32k
    tokens' activations)."""
    from perfbench.reference import lm_plain
    low, rows = _reference(run, cfgs, feed_batches, program, None,
                           lm_plain.fp8_linear)
    picks = low["picks"]
    low = _numbers(run, cfgs[0], low)
    ref, _ = _reference(run, cfgs, feed_batches, program, picks,
                        kimi_linear_plain.plain_linear)
    banks = lm_train._banks(rows, ref["writes"], len(program["calls"]))
    gap = max(ref["route_gaps"])
    return (_train_numbers(run, _numbers(run, cfgs[0], ref), low)
            + [moon._retrieval(run, cfgs, banks, program["calls"],
                               "control", tf32=True)]
            + [moon._route(run, gap)])


def judge_faults(run, cfgs, feed_batches, program):
    """The KDA layers' controls put in the program's place, following the
    program's rows and picks: the state pass in bf16 ("bf16_state") and
    the delta correction left out ("no_delta"), each judged against the
    f32 reference, its core too (`kda_core_err`)."""
    ref = _numbers(run, cfgs[0], _reference(
        run, cfgs, feed_batches, program, program["choices"],
        kimi_linear_plain.plain_linear)[0])
    out = {}
    for control in ("bf16_state", "no_delta"):
        low = _numbers(run, cfgs[0], _reference(
            run, cfgs, feed_batches, program, program["choices"],
            kimi_linear_plain.plain_linear, control)[0])
        out[control] = _train_numbers(run, ref, low) + [
            _core(run, program["core"], control)]
    return out
