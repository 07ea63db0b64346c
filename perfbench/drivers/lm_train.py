"""Training steps of the LM with episodic memory live.

`Trainer.train_step(ids, labels)` runs back to back on batches of
`batch` x `seq` token ids drawn from the seed (labels = ids; every row
differs), with the trainer's bank holding the full bank of rows drawn
from the seed and its index built, so every step's retrieval and every
`memory_store_interval`-th step's write meet a live index. The window
covers whole steps and ends on a device sync; `train_tokens_per_s` is
its tokens over its time.

Set-up builds one `Trainer` from the configuration, copies in the
weights the benchmark drew (the model's through its optimizer's flat
buffer, and the amygdala's), puts the bank in place, and drives the
first `checked_steps` steps through `train_step` as the window would.
Those steps are the checked ones: the harness keeps the weights before
them, the optimizer's first moment after the first (the first clipped
gradient is mu / (1 - b1)), the weights after the last, each step's
loss (the tensor the optimizer is given), and the query and the bank
rows of every memory layer's retrieval in each (a wrapper on
`engine.retrieve_auto`).
The same trainer then runs the window. In traced runs the spans
`train_step`, `retrieve_auto` and `optimizer` are opened and a bounded
number of steps is profiled.

The check (`reference.lm_train`, in the configuration's bf16), once the
window has closed and the trainer is freed, follows the checked steps:
- `grad_err`: per leaf, the gap between the norms of the program's and
  the reference's first clipped gradient, over the larger of the
  reference leaf's norm and the median leaf's; the median leaf's gap
  (the worst leaf's, one of the memory gates' [1, D] weights or a hybrid
  gate's scalar, swings from seed to seed with the rounding of their
  sums over every position, and is printed beside it);
- `change_err`: the same gap for the weights' change over the checked
  steps, the median leaf's, over the leaves whose reference gradient is
  at least a thousandth of the median leaf's (a key bias's gradient is
  nought to rounding under softmax, and Adam moves it by round-off
  alone); the worst leaf's is printed beside it: at the warmup's first
  learning rates Adam's step is about the sign of each entry's gradient,
  and a small leaf whose entries' gradients are mostly rounding turns
  those signs at random (PERF.md);
- `ret_gap`: every retrieval of the checked steps (each memory layer's
  recorded query and rows), against the exact top-k by f64 cosine over
  the bank as the step met it (the rows drawn from the seed, with the
  reference's own writes of the store steps before it): the widest gap,
  at any rank, by which the retrieved rows' exact combined scores lie
  below the exact top-k's (every row of the bank has the same age and
  strength in these steps, so the combined score ranks as the cosine).
  A swap of two rows that tie costs nothing, where a recall would count
  it: the exact top-k rows missed are printed and not compared (the
  program's f32 rerank swaps rows that tie to its rounding).
The steps' loss gap is printed and not compared: neither the control
nor a fault reads far enough above the program's readings (PERF.md).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from perfbench import core, data, trace
from perfbench.counts import lm as lm_counts
from perfbench.reference import engine_exact, lm_plain, lm_train

# the run seed's streams
ROWS, PARAMS, INDEX, TOKENS, TRAINER, AMYGDALA = 1, 2, 6, 9, 10, 11
B1 = 0.9


def configs(run):
    """(model dict, memory dict, training dict, `AuraConfig`): the
    configuration's groups, with the test sizes' overrides."""
    from aura_snn_rag_tpu_torch.config import (AuraConfig, MemoryConfig,
                                               ModelConfig, TrainingConfig)
    m, mem, t = (dict(run.config[g], **run.sizes.get(g, {}))
                 for g in ("model", "memory", "training"))
    mc = ModelConfig(**dict(m, snn_layers=tuple(m["snn_layers"])))
    return m, mem, t, AuraConfig(model=mc, memory=MemoryConfig(**mem),
                                 training=TrainingConfig(**t))


def bank_rows(run, memcfg) -> torch.Tensor:
    d = run.config["data"]
    return data.rows(run.device, core.sub_seed(run.seed, ROWS),
                     memcfg.max_memories, memcfg.feature_dim,
                     d["n_centers"], d["center_scale"])


def build_bank(run, memcfg):
    """The bank: every row drawn from the seed, `bulk_load`ed, and its
    index built."""
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.memory.state import init_memory_state
    rows = bank_rows(run, memcfg)
    state = init_memory_state(memcfg, run.device)
    state = engine.bulk_load(memcfg, state, rows, torch.zeros(
        memcfg.max_memories, memcfg.spatial_dims, device=run.device))
    del rows
    return engine.rebuild_centroids(memcfg, state, torch.Generator()
                                    .manual_seed(core.sub_seed(run.seed,
                                                               INDEX)))


def trainer_seed(run) -> int:
    return core.sub_seed(run.seed, TRAINER) % 2 ** 31


def amygdala_spec(D: int, hidden: int = 64):
    return [("fc1.weight", (hidden, D), "normal", 1.0 / D ** 0.5),
            ("fc1.bias", (hidden,), "const", 0.0),
            ("fc2.weight", (2, hidden), "normal", 1.0 / hidden ** 0.5),
            ("fc2.bias", (2,), "const", 0.0)]


def feed(run, m, tr, n):
    """[n, batch, seq] token ids drawn from the seed."""
    gen = data.generator(run.device, core.sub_seed(run.seed, TOKENS))
    return torch.randint(0, m["vocab_size"], (n, tr["batch"], tr["seq"]),
                         device=run.device, generator=gen)


class Recorder:
    """Stands in for `engine.retrieve_auto` (keeping each call's query and
    slots while `on`) and for the optimizer's `step` (keeping each loss)."""

    def __init__(self, retrieve, opt_step, run):
        self.retrieve, self.opt_step, self.run = retrieve, opt_step, run
        self.on = False
        self.calls, self.losses = [], []

    def retrieve_auto(self, config, state, queries, query_locations=None,
                      k=5):
        with self.run.span("bench:retrieve_auto"):
            res = self.retrieve(config, state, queries, query_locations, k)
        if self.on:
            self.calls.append((queries.detach().clone(),
                               res.indices.detach().clone()))
        return res

    def step(self, loss, lr_scale=1.0):
        if self.on:
            self.losses.append(loss.detach().clone())
        with self.run.span("bench:optimizer"):
            return self.opt_step(loss, lr_scale)


def build(run, cfg, m, params):
    from aura_snn_rag_tpu_torch.training.trainer import Trainer
    trainer = Trainer(cfg, seed=trainer_seed(run), device=run.device)
    names = dict(trainer.model.named_parameters())
    if set(names) != set(params):
        raise core.BenchError(
            f"the model's parameters differ from the reference's: "
            f"{sorted(set(names) ^ set(params))[:6]}")
    amyg = data.params(amygdala_spec(m["embedding_dim"]), run.device,
                       core.sub_seed(run.seed, AMYGDALA))
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(params[name])              # views of the flat buffer
        if trainer.amygdala is not None:
            for name, p in trainer.amygdala.named_parameters():
                p.copy_(amyg[name])
    return trainer, amyg


def run(run: core.Run) -> core.Outcome:
    from aura_snn_rag_tpu_torch.memory import engine

    tr = run.traffic
    dev = run.device
    m, mem, t, cfg = configs(run)
    n_check = int(tr["checked_steps"])
    n_feed = int(run.sizes.get("feed_steps", tr["feed_steps"]))

    # ---- set-up ---------------------------------------------------------
    params = data.params(lm_plain.param_spec(m), dev,
                         core.sub_seed(run.seed, PARAMS))
    trainer, amyg = build(run, cfg, m, params)
    trainer.hippocampus.state = build_bank(run, cfg.memory)
    batches = feed(run, m, tr, n_feed)
    opt = trainer.optimizer
    real_retrieve = engine.retrieve_auto
    rec = Recorder(real_retrieve, opt.step, run)
    engine.retrieve_auto = rec.retrieve_auto
    opt.step = rec.step
    prof = trace.Profiler(run.trace, dev)
    traced, trace_steps = None, int(run.sizes.get("trace_steps",
                                                   tr["trace_steps"]))
    try:
        p0 = opt.flat.detach().clone()
        calls = []
        rec.on = True
        for s in range(n_check):
            rec.calls = []
            trainer.train_step(batches[s], batches[s])
            calls.append(rec.calls)
            if s == 0:
                grad0 = opt.state.mu.float() / (1 - B1)
        rec.on = False
        p_end = opt.flat.detach().clone()
        losses = torch.stack(rec.losses).float().cpu()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = run.setup_s()

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
    finally:
        engine.retrieve_auto = real_retrieve
        opt.__dict__.pop("step", None)
        prof.stop()

    tokens = n * tr["batch"] * tr["seq"]
    e2e = {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    counts = {"model_flops": n * lm_counts.train_flops(m, tr["batch"],
                                                       tr["seq"])}
    leaves = [(k, p.numel()) for k, p in trainer.model.named_parameters()]
    program = {"losses": losses, "grad": _by_leaf(grad0, leaves),
               "change": _by_leaf(p_end - p0, leaves), "calls": calls,
               "seeds": dropout_seeds(trainer_seed(run), n_check)}
    del trainer, opt, rec, grad0, p0, p_end
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(run, (m, mem, t), (params, amyg), (batches[:n_check],
                                                      program))
    return core.Outcome(e2e, checks, attempted=n, failed=0,
                        memory_peak_bytes=peak, trace=traced, counts=counts)


def dropout_seeds(seed: int, n: int):
    """The dropout seed of each of the first n steps: the trainer draws
    one a step (a micro-batch) from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(2 ** 62)) for _ in range(n)]


def _by_leaf(flat, leaves):
    out, at = {}, 0
    for name, k in leaves:
        out[name] = flat[at:at + k].norm().item()
        at += k
    return out


def _gaps(prog: dict, ref: dict, keep=None, what: str = "") -> dict:
    """Per leaf: |prog - ref| over max(ref, the median leaf). Names the
    worst leaf on standard error."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}
    worst = max(gaps, key=gaps.get)
    print(f"perfbench: {what} worst leaf {worst}: {prog[worst]!r} against "
          f"{ref[worst]!r} (median leaf {med!r}), gap {gaps[worst]!r}",
          file=sys.stderr)
    return gaps


def _reference(run, cfgs, weights, feed_batches, program, linear,
               half_batch=False):
    """The reference's steps, following the program's retrieved rows, and
    the bank rows it starts from."""
    m, mem, t = cfgs
    params, amyg = weights
    dt = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
    rows = bank_rows(run, configs(run)[3].memory)
    L = m["num_layers"]
    slots = [[c[i][1][:, None, :].expand(-1, feed_batches.shape[2], -1)
              for i in range(L)] for c in program["calls"]]
    with engine_exact.tf32(False):
        res = lm_train.train_steps(params, amyg, m, mem, t, feed_batches,
                                   rows, slots, program["seeds"], dt,
                                   linear, half_batch)
    return res, rows


def _banks(rows, writes, n_steps):
    """The bank's rows as each step's retrieval meets them: `rows` with
    the reference's writes of the steps before it."""
    out, bank = [], rows
    for step in range(n_steps):
        for at_step, at, summary in writes:
            if at_step == step - 1:
                bank = bank.clone()
                bank[at] = summary
        out.append(bank)
    return out


def _retrieval(run, banks, calls, what: str, k: int):
    """`ret_gap` of the rows retrieved in `calls` (per step, each memory
    layer's (query, slots)) over the step's bank; the exact top-k rows
    missed are printed beside it."""
    hits = total = 0
    gap = 0.0
    for bank, step_calls in zip(banks, calls):
        q = torch.cat([c[0] for c in step_calls])
        s = torch.cat([c[1] for c in step_calls])
        h, g = engine_exact.rank_check(bank, q, s, k)
        hits, total, gap = hits + h, total + s.numel(), max(gap, g)
    print(f"perfbench: {what} retrieval: {total - hits} of {total} exact "
          f"top-{k} rows missed (not compared)", file=sys.stderr)
    return [core.Check("ret_gap", run.config["memory"]["w_cosine"] * gap,
                       run.config["limits"]["ret_gap"])]


def _numbers(run, ref, got):
    """`grad_err` and `change_err` of `got` (the program's, or the
    control's) against `ref`, each a dict of the step losses and the
    per-leaf norms of the first clipped gradient and of the change."""
    limits = run.config["limits"]
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"]))
    print(f"perfbench: steps' loss gap {loss!r} (not compared)",
          file=sys.stderr)
    med = float(np.median(list(ref["grad"].values())))
    moved = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    grad = _gaps(got["grad"], ref["grad"], what="grad")
    change = _gaps(got["change"], ref["change"], moved, "change")
    return [core.Check("grad_err", float(np.median(list(grad.values()))),
                       limits["grad_err"]),
            core.Check("change_err", float(np.median(list(
                change.values()))), limits["change_err"])]


def _as_numbers(res, P0):
    return {"losses": res["losses"],
            "grad": {k: v.norm().item() for k, v in res["grad"].items()},
            "change": {k: (res["params"][k] - P0[k]).norm().item()
                       for k in P0}}


def _k(run) -> int:
    return int(run.config["model"]["num_retrieved"])


def judge(run, cfgs, weights, checked):
    """The compared numbers of the checked steps."""
    feed_batches, program = checked
    ref, rows = _reference(run, cfgs, weights, feed_batches, program,
                           lm_plain.plain_linear)
    got = {"losses": program["losses"].tolist(), "grad": program["grad"],
           "change": program["change"]}
    banks = _banks(rows, ref["writes"], len(program["calls"]))
    return _numbers(run, _as_numbers(ref, weights[0]), got) + _retrieval(
        run, banks, program["calls"], "program", _k(run))


def judge_control(run, cfgs, weights, checked):
    """The control: the reference with fp8 products in the program's
    place, and retrieval by products whose inputs are rounded to TF32."""
    feed_batches, program = checked
    ref, rows = _reference(run, cfgs, weights, feed_batches, program,
                           lm_plain.plain_linear)
    low, _ = _reference(run, cfgs, weights, feed_batches, program,
                        lm_plain.fp8_linear)
    banks = _banks(rows, ref["writes"], len(program["calls"]))
    k = _k(run)
    tf32 = [[(q, engine_exact.control(bank, q, {"w_cosine": 1.0,
                                                "w_temporal": 0.0}, k)[0])
             for q, _ in step_calls]
            for bank, step_calls in zip(banks, program["calls"])]
    return _numbers(run, _as_numbers(ref, weights[0]),
                    _as_numbers(low, weights[0])) + _retrieval(
        run, banks, tf32, "control", k)


def judge_faults(run, cfgs, weights, checked):
    """The numbers of the faults a training step can have, each put in
    the program's place: {fault: checks}. A step that returns its state
    unchanged reads 1 on `change_err` by the measure itself; half of the
    batch left out (the loss's mean over the other half) is run; an
    answer altered where it is produced (each retrieval's first row of
    its first query moved to the next bank row) is read on the
    retrieval's numbers, as the reference follows the rows the program
    injected."""
    feed_batches, program = checked
    res, rows = _reference(run, cfgs, weights, feed_batches, program,
                           lm_plain.plain_linear)
    ref = _as_numbers(res, weights[0])
    half, _ = _reference(run, cfgs, weights, feed_batches, program,
                         lm_plain.plain_linear, half_batch=True)
    banks = _banks(rows, res["writes"], len(program["calls"]))
    altered = []
    for step_calls in program["calls"]:
        altered.append([])
        for q, s in step_calls:
            s = s.clone()
            s[0, 0] = (s[0, 0] + 1) % rows.shape[0]
            altered[-1].append((q, s))
    return {"half_batch": _numbers(run, ref, _as_numbers(half, weights[0])),
            "altered_answer": _retrieval(run, banks, altered, "altered",
                                         _k(run))}
