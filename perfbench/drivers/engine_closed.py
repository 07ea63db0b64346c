"""Closed-loop retrieval from the episodic-memory engine.

One client sends requests back to back: each is a batch of queries near
stored rows, of a size drawn in [batch_min, batch_max] (every size
equally often, in an order drawn from the seed), through the traffic's
`entry`:
- "retrieve": `engine.retrieve(cfg, state, q, None, k, aux=aux)` with the
  aux sidecar built once per bank state (what `HippocampalFormation.
  retrieve_batch` calls); results stay on the device, and the window
  ends on a device sync. Reports `qps`.
- "retrieve_auto": `engine.retrieve_auto(cfg, state, q, None, k)`, which
  picks the path and builds what it needs per call; each request's
  slots and scores are copied to the host before the next is sent.
  Reports `qps` and `query_p95_ms` (call to answer on the host).

Set-up draws the bank's rows on the device from the configuration's
data seed (runs with different seeds differed by up to 4% in `qps` when
each drew its own bank, and two runs of one seed by 0.05%: the bank's
cluster sizes set a batch's work), `bulk_load`s them, builds the index
(`rebuild_centroids`), draws a pool of requests from the run's seed and
calls the entry once per request size. After the window a sample of
answers drawn from the seed is judged by `reference.engine_exact`
against rows drawn again from the seed, once the program's state is
freed.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench import core, data, trace
from perfbench.counts import ivf as ivf_counts
from perfbench.counts.peaks import bound_s
from perfbench.reference import engine_exact

ROWS, QUERIES, INDEX, SAMPLE = 1, 2, 3, 4          # seed streams


def memory_config(run):
    from aura_snn_rag_tpu_torch.config import MemoryConfig
    cfg = dict(run.config["memory"])
    cfg.update(run.sizes.get("memory", {}))
    return MemoryConfig(**cfg)


def bank_rows(run, cfg) -> torch.Tensor:
    """The bank's rows, drawn from the configuration's data seed: every
    run seed meets the same bank (its cluster sizes set the work of a
    batch), with its own queries."""
    d = run.config["data"]
    return data.rows(run.device, core.sub_seed(d["seed"], ROWS),
                     cfg.max_memories, cfg.feature_dim, d["n_centers"],
                     d["center_scale"])


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(run: core.Run) -> core.Outcome:
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.memory.state import init_memory_state

    tr = run.traffic
    dev = run.device
    cfg = memory_config(run)
    k = int(run.config["top_k"])
    n_pool = int(run.sizes.get("pool_requests", tr["pool_requests"]))

    # ---- set-up: rows, requests, bank, index --------------------------
    feats = bank_rows(run, cfg)
    qgen = data.generator(dev, core.sub_seed(run.seed, QUERIES))
    sizes = data.balanced_sizes(tr["batch_min"], tr["batch_max"], n_pool,
                                qgen)
    pool = torch.split(data.queries_near(feats, qgen, sum(sizes),
                                         tr["query_noise"]), sizes)
    state = init_memory_state(cfg, dev)
    state = engine.bulk_load(cfg, state, feats, torch.zeros(
        cfg.max_memories, cfg.spatial_dims, device=dev))
    del feats
    state = engine.rebuild_centroids(
        cfg, state, torch.Generator().manual_seed(
            core.sub_seed(run.config["data"]["seed"], INDEX)))
    if tr["entry"] == "retrieve":
        aux = engine.build_ivf_aux(cfg, state)

        def call(q):
            return engine.retrieve(cfg, state, q, None, k, aux=aux)
    else:
        def call(q):
            return engine.retrieve_auto(cfg, state, q, None, k)
    to_host = tr["results"] == "host"
    for s in sorted(set(sizes)):                  # every shape, once
        r = call(pool[sizes.index(s)])
        if to_host:
            r.indices.cpu()
    _sync(dev)
    setup_s = run.setup_s()

    # ---- the window ----------------------------------------------------
    seconds = min(run.seconds, tr["trace_seconds"]) if run.trace \
        else run.seconds
    prof = trace.Profiler(run.trace, dev)
    answers, lat = {}, []
    n = n_queries = 0
    core.quiet_gc()
    prof.start()
    t0 = time.perf_counter()
    while True:
        i = n % n_pool
        ta = time.perf_counter()
        with run.span("bench:" + tr["entry"]):
            r = call(pool[i])
        if to_host:
            with run.span("bench:to_host"):
                answers[i] = (r.indices.cpu(), r.scores.cpu())
            lat.append(time.perf_counter() - ta)
        else:
            answers[i] = (r.indices, r.scores)
        n += 1
        n_queries += sizes[i]
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    traced = prof.stop()
    del r

    e2e = {"qps": n_queries / window_s, "setup_s": setup_s}
    if to_host:
        e2e["query_p95_ms"] = core.p95(lat) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0

    # ---- what the per-layer readers count ------------------------------
    counts = {"calls": n, "kernel_b_calls": n, "queries": n_queries}
    info = {}
    if traced is not None:
        info["kernel_counts"] = _kernel_counts(cfg, state, pool, sizes, n,
                                               k)

    # ---- judge a sample of the window's answers ------------------------
    sgen = torch.Generator().manual_seed(core.sub_seed(run.seed, SAMPLE))
    done = sorted(answers)
    n_check = min(int(run.sizes.get("check_requests",
                                    tr["check_requests"])), len(done))
    pick = [done[j] for j in torch.randperm(len(done), generator=sgen)
            [:n_check].tolist()]
    sample = [(pool[i], answers[i][0], answers[i][1]) for i in pick]
    del state, answers, call
    if tr["entry"] == "retrieve":
        del aux
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(run, cfg, sample, k)
    return core.Outcome(e2e, checks, attempted=n, failed=0,
                        memory_peak_bytes=peak, trace=traced, counts=counts,
                        info=info)


def judge(run, cfg, sample, k):
    """The compared numbers for (queries, slots, scores) answers."""
    rows = bank_rows(run, cfg)
    q, slots, scores = engine_exact.cat_answers(sample, rows.device)
    weights = {"w_cosine": cfg.w_cosine, "w_temporal": cfg.w_temporal}
    return engine_exact.judge(rows, q, slots, scores, weights, k,
                              run.config["limits"])


def judge_control(run, cfg, sample, k):
    """The same numbers for the control's answers to the same queries:
    the reference one precision down in the program's place."""
    rows = bank_rows(run, cfg)
    q, _, _ = engine_exact.cat_answers(sample, rows.device)
    weights = {"w_cosine": cfg.w_cosine, "w_temporal": cfg.w_temporal}
    slots, scores = engine_exact.control(rows, q, weights, k)
    return engine_exact.judge(rows, q, slots, scores, weights, k,
                              run.config["limits"])


def _kernel_counts(cfg, state, pool, sizes, n, k):
    """Bytes and operations of kernel B and of the whole call, averaged
    over the requests of the window (the pool cycles), from the probes the
    engine picks and the bank's filled rows."""
    from aura_snn_rag_tpu_torch.memory.engine import KPAD
    K, C, D = state.k_centroids, state.bucket_capacity, state.feature_dim
    G = min(cfg.overflow_buckets, K // 4)
    P = min(cfg.probe_centroids, K - G)
    fills = state.bucket_fill.clamp(max=C).long()
    annex = int(fills[K - G:].sum()) if G else 0
    used = min(n, len(pool))
    kb = whole = 0.0
    for i in range(used):
        top_c = ivf_counts.probes(pool[i], state.centroids, P)
        kb += bound_s(*ivf_counts.kernel_b(fills, top_c, D, KPAD))[0]
        whole += bound_s(*ivf_counts.retrieve_call(fills, top_c, K, D, k,
                                                   annex, KPAD))[0]
    return {"kernel_b_bound_s": kb / used, "call_bound_s": whole / used,
            "annex_rows": annex}
