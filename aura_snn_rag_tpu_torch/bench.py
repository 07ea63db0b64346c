"""The retrieval benchmark on the port (counterpart of the root `bench.py`,
which runs the same steps on the JAX package): episodic retrieval QPS on
one card at 1M vectors, recall@10 against exact search, index build time,
and the ratio to a host-CPU baseline of the reference's retrieval math.

    python -m aura_snn_rag_tpu_torch.bench [--small] [--n=N] [--bf16]
        [--kernel=v2|v3|v3r] [--flat-score=bf16|f32]
        [--flat-strategy=scan|blockmax] [--flat-tile-m=T]
        [--flat-block-funnel=F] [--batch=B] [--rerank=R] [--flat-recall=X]
        [--rescue=R] [--rescue-width=W] [--ingest-dtype=f16|u16|f32]
        [--ingest-f32] [--device cuda]

The flags are `bench.py`'s, with its defaults: 1,000,000 x 768 rows
(`--small`: 100,000), int8 coarse rows (`--bf16`: bf16), K = 4096
centroids probed 64 (`--small`: 1024 and 32), a 64-bucket overflow annex
(`--small`: 8), 2 Lloyd iterations, k = 10, rerank 128, a bf16 flat
score chain, and 16 batches of 1024 queries (`--small`: 8 of 32).
`--flat-tile-m` and `--flat-recall` go into `MemoryConfig` as in the JAX
script, and the port's engine ignores them by design: its block-max
kernel scans contiguous 8-row blocks, and its coarse funnels are exact
top-k. `--sharded=N` is refused: the JAX script hands it to
`benchmarks/bench_sharded_scaling.py`, a JAX script of the benchmark
folder, which has no counterpart here.

The data is `bench.py`'s, bit for bit: numpy `RandomState` draws of
clustered rows and of queries near them. Rows are shipped to the device
as f16 (`--ingest-dtype`), so the stored bank holds f16-rounded rows;
recall@10 is taken against an exact f32 search over the stored bank on
the device (TF32 off), and against exact search over the unrounded rows
on the host (`recall_at_10_vs_f32_data`). The baseline
(`ReferenceMathIndex`) is the reference's centroid index in torch on the
host CPU. On CUDA the kernels are built before any timer starts.

Prints one JSON line with the JAX script's 16 keys.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory import (
    bulk_load, init_memory_state, rebuild_centroids, retrieve, retrieve_flat)
from aura_snn_rag_tpu_torch.memory.engine import build_ivf_aux
from aura_snn_rag_tpu_torch.memory.state import MemoryState

D = 768
LLOYD_ITERS = 2
TOPK = 10
N_EVAL = 1024               # queries held to the device's exact search
N_FIDELITY = 128            # queries held to exact search over f32 rows
ORACLE_CHUNK = 128          # queries per exact product on the device
BASELINE_K = 256            # the reference's own defaults
BASELINE_PROBE = 8


# ----------------------------------------------------------------------
# data, recall, the host baseline (copies of bench.py's)
# ----------------------------------------------------------------------

def make_data(n, d, n_centers=1024, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, d).astype(np.float32) * 2.0
    assign = rng.randint(0, n_centers, n)
    feats = centers[assign] + rng.randn(n, d).astype(np.float32)
    return feats, centers


def make_queries(feats, n_queries, seed=1):
    """Queries near random stored rows, as `bench.py`'s main draws them."""
    rng = np.random.RandomState(seed)
    pick = rng.randint(0, len(feats), n_queries)
    return feats[pick] + 0.5 * rng.randn(len(pick), feats.shape[1]).astype(
        np.float32)


def exact_topk_numpy(feats, queries, k):
    """Exact combined-score top-k (cosine + temporal·strength; all strengths
    1 and ages 0 here, so ranking reduces to cosine)."""
    fn = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
    qn = queries / (np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12)
    out = np.zeros((len(queries), k), np.int64)
    for i in range(0, len(queries), 8):
        cos = qn[i:i + 8] @ fn.T
        out[i:i + 8] = np.argpartition(-cos, k, axis=1)[:, :k]
        # order within top-k
        row = cos[np.arange(len(cos))[:, None], out[i:i + 8]]
        order = np.argsort(-row, axis=1)
        out[i:i + 8] = out[i:i + 8][np.arange(len(cos))[:, None], order]
    return out


def recall_at_k(approx, exact):
    return float(np.mean([
        len(set(a.tolist()) & set(e.tolist())) / exact.shape[1]
        for a, e in zip(approx, exact)]))


class ReferenceMathIndex:
    """The reference's centroid index math, implemented fresh in torch-CPU.

    Build: sample-k init + 1 Lloyd iteration (hippocampal.py:345-377).
    Query: top-8 centroid probe, per-centroid membership mask loop
    (:262-270), normalized-matmul cosine, combined score × strength, top-k
    (:272-307). Strength/temporal terms are constant here (fresh bank).
    It is the host baseline and always runs on the host CPU.
    """

    def __init__(self, feats_np, k_centroids=BASELINE_K, seed=0):
        t = torch
        self.feats = t.from_numpy(feats_np)
        n = self.feats.shape[0]
        g = t.Generator().manual_seed(seed)
        perm = t.randperm(n, generator=g)[:k_centroids]
        cents = self.feats[perm].clone()
        # one Lloyd iteration, chunked cdist
        assign = t.empty(n, dtype=t.long)
        for i in range(0, n, 131072):
            d = t.cdist(self.feats[i:i + 131072], cents)
            assign[i:i + 131072] = d.argmin(dim=1)
        for cid in range(k_centroids):
            m = assign == cid
            if m.any():
                cents[cid] = self.feats[m].mean(dim=0)
        for i in range(0, n, 131072):
            d = t.cdist(self.feats[i:i + 131072], cents)
            assign[i:i + 131072] = d.argmin(dim=1)
        self.centroids = cents
        self.assign = assign
        self.feats_norm = t.nn.functional.normalize(self.feats, dim=1)

    def query(self, q_np, k=TOPK, probe=BASELINE_PROBE):
        t = torch
        q = t.from_numpy(q_np)
        c_d = t.norm(self.centroids - q, dim=1)
        top_c = t.topk(-c_d, k=probe).indices
        mask = t.zeros_like(self.assign, dtype=t.bool)
        for cid in top_c:                       # reference's Python loop
            mask |= (self.assign == cid)
        cand = t.nonzero(mask, as_tuple=False).squeeze(-1)
        qn = t.nn.functional.normalize(q.unsqueeze(0), dim=1)
        sims = (qn @ self.feats_norm[cand].T).squeeze(0)
        kk = min(k, cand.numel())
        top = t.topk(sims, kk)
        return cand[top.indices].numpy()


# ----------------------------------------------------------------------
# the engine half: ingest, rebuild, timed retrieval, the exact oracle
# ----------------------------------------------------------------------

class EngineResult(NamedTuple):
    flat_qps: float
    ivf_qps: float
    build_s: float               # the warm rebuild
    build_cold_s: float          # the first rebuild
    ingest_s: float              # host f16 cast, upload, bulk_load
    approx_idx: np.ndarray       # [n_queries, k] flat results, every batch
    exact_idx: np.ndarray        # [n_eval, k] the device's exact search
    n_eval: int
    state: MemoryState
    ivf_idx: np.ndarray          # [n_queries, k] IVF results, every batch
    ivf_scores: np.ndarray       # [n_queries, k]


def memory_config(n: int, k_centroids: int, probe: int, overflow_buckets: int,
                  coarse_dtype: str = "int8", **kernel_kw) -> MemoryConfig:
    """`bench.py`'s MemoryConfig (bench.py:171-180) at explicit sizes;
    `kernel_kw` are its flag overrides (ivf_kernel, flat_strategy, ...)."""
    return MemoryConfig(max_memories=n, feature_dim=D, k_centroids=k_centroids,
                        probe_centroids=probe, retrieve_k=TOPK,
                        bucket_overprovision=2.0,
                        rebuild_lloyd_iters=LLOYD_ITERS,
                        coarse_dtype=coarse_dtype,
                        overflow_buckets=overflow_buckets,
                        n_place_cells=16, n_grid_cells=8, n_time_cells=4,
                        **kernel_kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _upload(feats: np.ndarray, ingest_dtype: str,
            dev: torch.device) -> torch.Tensor:
    """The rows on the device as f32, shipped as f32, f16 or the f16 bits
    as uint16 reinterpreted as f16."""
    if ingest_dtype == "f32":
        host = torch.from_numpy(feats)
    elif ingest_dtype == "u16":
        u16 = feats.astype(np.float16).view(np.uint16)
        host = torch.from_numpy(u16).view(torch.float16)
    elif ingest_dtype == "f16":
        host = torch.from_numpy(feats.astype(np.float16))
    else:
        raise ValueError(f"ingest dtype {ingest_dtype!r}, expected f16, "
                         f"u16 or f32")
    return host.to(dev).float()


def exact_topk(features: torch.Tensor, queries: torch.Tensor, k: int,
               chunk: int = ORACLE_CHUNK) -> torch.Tensor:
    """Exact cosine top-k [Q, k] over every stored row: f32 products with
    TF32 off (restored after), `chunk` queries at a time."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fnb = features * torch.rsqrt(
            (features * features).sum(1, keepdim=True) + 1e-12)
        out = []
        for i in range(0, queries.shape[0], chunk):
            qc = queries[i:i + chunk]
            qcn = qc * torch.rsqrt((qc * qc).sum(1, keepdim=True) + 1e-12)
            out.append(torch.topk(qcn @ fnb.T, k, dim=1).indices)
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def engine_bench(feats: np.ndarray, queries: np.ndarray, cfg: MemoryConfig,
                 batch: int, n_batches: int, ingest_dtype: str = "f16",
                 device="cuda") -> EngineResult:
    """`bench.py`'s `tpu_bench` on the port: the rows ingested and the
    index built twice (cold, then warm), then `n_batches` batches of
    `batch` queries through `retrieve_flat` and through `retrieve` with
    the aux sidecar built once, each after one warm-up call, and the
    exact oracle over the first min(1024, len(queries)) queries."""
    dev = resolve_device(device)
    n = feats.shape[0]
    state = init_memory_state(cfg, dev)
    _sync(dev)
    t_ing = time.perf_counter()
    f = _upload(feats, ingest_dtype, dev)
    state = bulk_load(cfg, state, f, torch.zeros((n, cfg.spatial_dims),
                                                 device=dev))
    _sync(dev)
    ingest_s = time.perf_counter() - t_ing
    del f

    t0 = time.perf_counter()
    state = rebuild_centroids(cfg, state, torch.Generator().manual_seed(0))
    _sync(dev)
    build_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = rebuild_centroids(cfg, state, torch.Generator().manual_seed(1))
    _sync(dev)
    build_s = time.perf_counter() - t0

    q = torch.from_numpy(queries).to(dev)
    batches = [q[i * batch:(i + 1) * batch] for i in range(n_batches)]

    def timed(fn):
        fn(batches[0])                                   # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        results = [fn(b) for b in batches]
        _sync(dev)
        dt = time.perf_counter() - t0
        return n_batches * batch / dt, results

    flat_qps, flat_results = timed(
        lambda b: retrieve_flat(cfg, state, b, None, TOPK))
    # IVF with its metadata sidecar built once (a pure function of the
    # bank state, cached per mutation by the serving wrapper)
    aux = build_ivf_aux(cfg, state)
    _sync(dev)
    ivf_qps, ivf_results = timed(
        lambda b: retrieve(cfg, state, b, None, TOPK, aux=aux))

    def cat(results, field):
        return torch.cat([getattr(r, field) for r in results]).cpu().numpy()

    n_eval = min(N_EVAL, len(queries))
    exact_idx = exact_topk(state.features, q[:n_eval], TOPK).cpu().numpy()
    return EngineResult(flat_qps, ivf_qps, build_s, build_cold_s, ingest_s,
                        cat(flat_results, "indices"), exact_idx, n_eval,
                        state, cat(ivf_results, "indices"),
                        cat(ivf_results, "scores"))


# ----------------------------------------------------------------------
# the command line
# ----------------------------------------------------------------------

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.bench", allow_abbrev=False,
        description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="100,000 rows, K = 1024, probe 32, 8 batches of 32")
    ap.add_argument("--n", type=int, default=None, help="rows in the bank")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 coarse rows (default int8)")
    ap.add_argument("--kernel", default=None, choices=("v2", "v3", "v3r"),
                    help="IVF kernel generation")
    ap.add_argument("--flat-score", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--flat-strategy", default=None,
                    choices=("scan", "blockmax"))
    ap.add_argument("--flat-tile-m", type=int, default=None,
                    help="kept in MemoryConfig; unused by the port")
    ap.add_argument("--flat-block-funnel", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None, help="query batch")
    ap.add_argument("--rerank", type=int, default=128)
    ap.add_argument("--flat-recall", type=float, default=None,
                    help="kept in MemoryConfig; unused by the port")
    ap.add_argument("--rescue", type=int, default=None)
    ap.add_argument("--rescue-width", type=int, default=None)
    ap.add_argument("--ingest-dtype", default=None,
                    choices=("f16", "u16", "f32"))
    ap.add_argument("--ingest-f32", action="store_true",
                    help="alias of --ingest-dtype=f32")
    ap.add_argument("--sharded", type=int, default=None,
                    help="refused: the JAX script's sharded-scaling run has "
                         "no counterpart in the port")
    ap.add_argument("--device", default="cuda")
    return ap


class Settings(NamedTuple):
    """Sizes and the MemoryConfig of one run, from the flags."""
    cfg: MemoryConfig
    batch: int
    n_batches: int
    baseline_queries: int
    ingest_dtype: str
    device: str


def settings(args: argparse.Namespace) -> Settings:
    n = args.n or (100_000 if args.small else 1_000_000)
    kernel_kw = {"flat_score_dtype": args.flat_score}
    for key, value in (("ivf_kernel", args.kernel),
                       ("flat_strategy", args.flat_strategy),
                       ("flat_tile_m", args.flat_tile_m),
                       ("flat_block_funnel", args.flat_block_funnel),
                       ("rerank_candidates", args.rerank),
                       ("flat_funnel_recall", args.flat_recall)):
        if value:
            kernel_kw[key] = value
    if args.rescue is not None:
        kernel_kw["flat_rescue_queries"] = args.rescue
    if args.rescue_width is not None:
        kernel_kw["flat_rescue_width"] = args.rescue_width
    cfg = memory_config(
        n, 1024 if args.small else 4096, 32 if args.small else 64,
        8 if args.small else 64, "bf16" if args.bf16 else "int8",
        **kernel_kw)
    ingest = args.ingest_dtype or ("f32" if args.ingest_f32 else "f16")
    return Settings(cfg, args.batch or (32 if args.small else 1024),
                    8 if args.small else 16, 8 if args.small else 16,
                    ingest, args.device)


class BenchResult(NamedTuple):
    line: dict                   # the JSON line's object
    engine: EngineResult


def run(argv: Optional[Sequence[str]] = None) -> BenchResult:
    """The benchmark at the flags in `argv`; returns its JSON object and
    the engine half's results (the bank state, every batch's results)."""
    args = parser().parse_args(argv)
    if args.sharded is not None:
        raise SystemExit(
            "bench: --sharded is not supported by the port: bench.py hands "
            "it to benchmarks/bench_sharded_scaling.py, a JAX script whose "
            "folder has no counterpart here")
    s = settings(args)
    dev = resolve_device(s.device)
    if dev.type == "cuda":
        # nvcc before any timer: no build time in a QPS or a build time
        from aura_snn_rag_tpu_torch.ops.cuda import _build
        _build.build_all()
        for stem in _build.SOURCES:
            _build.load(stem)
    n = s.cfg.max_memories
    feats, _ = make_data(n, D)
    queries = make_queries(feats, s.batch * s.n_batches)

    eng = engine_bench(feats, queries, s.cfg, s.batch, s.n_batches,
                       s.ingest_dtype, dev)
    # recall@10 against the device's exact search over the stored bank
    recall = recall_at_k(eng.approx_idx[:eng.n_eval], eng.exact_idx)
    # fidelity against exact search over the original f32 rows (the f16
    # ingest rounds the stored rows ~5e-4)
    n_fid = min(N_FIDELITY, len(queries))
    exact_f32 = exact_topk_numpy(feats, queries[:n_fid], TOPK)
    recall_f32 = recall_at_k(eng.approx_idx[:n_fid], exact_f32)

    # the host baseline (reference math); median per-query latency
    t0 = time.perf_counter()
    ref = ReferenceMathIndex(feats)
    ref_build_s = time.perf_counter() - t0
    ref_results: List[np.ndarray] = []
    lats = []
    for i in range(s.baseline_queries):
        t0 = time.perf_counter()
        ref_results.append(ref.query(queries[i]))
        lats.append(time.perf_counter() - t0)
    ref_qps = 1.0 / float(np.median(lats))
    ref_recall = recall_at_k(np.stack([r[:TOPK] for r in ref_results]),
                             exact_f32[:s.baseline_queries])

    qps = eng.flat_qps
    line = {
        "metric": f"episodic retrieval QPS/chip @ {n} vectors "
                  f"(recall@10 matched)",
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / ref_qps, 2),
        "recall_at_10": round(recall, 4),
        "recall_eval_queries": eng.n_eval,
        "recall_at_10_vs_f32_data": round(recall_f32, 4),
        "baseline_recall_at_10": round(ref_recall, 4),
        "baseline_qps": round(ref_qps, 2),
        "ivf_qps": round(eng.ivf_qps, 1),
        "index_build_s": round(eng.build_s, 3),
        "index_build_cold_s": round(eng.build_cold_s, 3),
        "ingest_transfer_s": round(eng.ingest_s, 3),
        "baseline_build_s": round(ref_build_s, 3),
        "n_vectors": n,
        "coarse_dtype": s.cfg.coarse_dtype,
    }
    return BenchResult(line, eng)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
