"""Small-batch retrieval latency on the port, IVF against the flat scan
(counterpart of `benchmarks/bench_retrieval_latency.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_retrieval_latency
        [--small] [--batches 1,8,32,128] [--reps 5] [--kernel v2|v3|v3r]
        [--device cuda]

The JAX script's configuration: 1,000,000 x 768 rows (`--small`:
100,000), K = 4096 centroids probed 64 (`--small`: 1024 and 32), a
64-bucket overflow annex (`--small`: 8), 2 Lloyd iterations, bf16
coarse rows, k = 10. The rows and the first 128 queries are the JAX
script's, bit for bit (`RandomState(0)`: clustered rows, then queries
near random rows). The JAX script has no more than those 128 queries, so
there a batch above 128 is 128 queries; here the queries past 128 come
from `RandomState(1)` by the same recipe, so each batch holds B queries.

For each batch, IVF (`retrieve` with the aux sidecar built once: kernel
B at the default v3r, D at `--kernel v3`, E at `--kernel v2`) and the
flat scan (`retrieve_flat`) are called once to warm up, once alone
(`wall_latency_ms`, to the card's finish) and max(reps, 10) times back to
back (`device_ms` per call, to the card's finish after the last), with
recall@10 of the last call's result against exact numpy search.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import (
    _sync, exact_topk_numpy, make_data, memory_config, recall_at_k)
from aura_snn_rag_tpu_torch.memory import (
    bulk_load, init_memory_state, rebuild_centroids, retrieve, retrieve_flat)
from aura_snn_rag_tpu_torch.memory.engine import build_ivf_aux

D = 768
TOPK = 10
N_QUERIES = 128              # the JAX script's query count
EXTRA_SEED = 1               # the queries past the JAX script's 128


def sizes(small: bool):
    """(rows, centroids, probe, overflow buckets) of the configuration."""
    return ((100_000, 1024, 32, 8) if small
            else (1_000_000, 4096, 64, 64))


def make_inputs(n: int, n_queries: int = N_QUERIES):
    """(rows [n, D], queries [max(128, n_queries), D]): the JAX script's
    rows and 128 queries, then more from `RandomState(1)`."""
    rng = np.random.RandomState(0)
    feats, _ = make_data(n, D, rng=rng)
    queries = feats[rng.randint(0, n, N_QUERIES)] + \
        0.1 * rng.randn(N_QUERIES, D).astype(np.float32)
    if n_queries > N_QUERIES:
        extra = np.random.RandomState(EXTRA_SEED)
        m = n_queries - N_QUERIES
        queries = np.concatenate([queries, feats[extra.randint(0, n, m)]
                                  + 0.1 * extra.randn(m, D).astype(
                                      np.float32)])
    return feats, queries


def build_index(cfg, feats: np.ndarray, dev: torch.device):
    """The bank: `bulk_load` of the rows, then `rebuild_centroids` (its
    initial centroids from a CPU generator seeded 0)."""
    n = feats.shape[0]
    state = init_memory_state(cfg, dev)
    state = bulk_load(cfg, state, torch.from_numpy(feats).to(dev),
                      torch.zeros((n, 2), device=dev))
    state = rebuild_centroids(cfg, state, torch.Generator().manual_seed(0))
    _sync(dev)
    return state


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_retrieval_latency",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batches", default="1,8,32,128")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernel", default="", choices=("", "v2", "v3", "v3r"),
                    help="override MemoryConfig.ivf_kernel")
    ap.add_argument("--device", default="cuda")
    return ap


class LatencyResult(NamedTuple):
    line: dict                          # the JSON line
    # "ivf_B8" -> the last call's (indices, scores)
    results: Dict[str, Tuple[np.ndarray, np.ndarray]]
    calls: Dict[str, int]               # "ivf_B8" -> calls made
    exact: np.ndarray                   # [n_queries, k] exact top-k
    cfg: object                         # the MemoryConfig


def run(argv: Optional[Sequence[str]] = None) -> LatencyResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    batches = [int(b) for b in args.batches.split(",")]
    n, k_centroids, probe, overflow = sizes(args.small)
    if dev.type == "cuda":
        # nvcc before any timer
        from aura_snn_rag_tpu_torch.ops.cuda import _build
        _build.build_all()
        _build.load("ivf_scan")
    kernel_kw = {"ivf_kernel": args.kernel} if args.kernel else {}
    cfg = memory_config(n, k_centroids, probe, overflow, "bf16", **kernel_kw)
    feats, queries = make_inputs(n, max(batches))
    state = build_index(cfg, feats, dev)
    print("index built", file=sys.stderr, flush=True)

    # exact reference ranking for recall
    exact = exact_topk_numpy(feats, queries, TOPK)
    del feats
    # the metadata sidecar is a pure function of the bank state, built
    # once per mutation by the serving path
    aux = build_ivf_aux(cfg, state)
    _sync(dev)

    def ivf(c, s, q, loc, kk):
        return retrieve(c, s, q, loc, kk, aux=aux)

    reps = max(args.reps, 10)
    out = {"metric": "retrieval latency IVF vs flat", "n_vectors": n}
    results, calls = {}, {}
    for B in batches:
        qb = torch.from_numpy(queries[:B]).to(dev)
        for name, fn in (("ivf", ivf), ("flat", retrieve_flat)):
            res = fn(cfg, state, qb, None, TOPK)             # warm-up
            _sync(dev)
            t0 = time.perf_counter()
            res = fn(cfg, state, qb, None, TOPK)
            _sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for _ in range(reps):
                res = fn(cfg, state, qb, None, TOPK)
            _sync(dev)
            dev_ms = (time.perf_counter() - t0) * 1e3 / reps
            got = res.indices.cpu().numpy()
            r = recall_at_k(got, exact[:B])
            key = f"{name}_B{B}"
            out[key] = {
                "wall_latency_ms": round(wall_ms, 3),
                "device_ms": round(dev_ms, 3),
                "device_qps": round(B / (dev_ms / 1e3), 1),
                "recall_at_10": round(r, 4)}
            results[key] = (got, res.scores.cpu().numpy())
            calls[key] = reps + 2
            print(f"{name} B={B}: wall {wall_ms:.2f} ms  device "
                  f"{dev_ms:.2f} ms  {B / (dev_ms / 1e3):,.0f} QPS "
                  f"recall={r:.3f}", file=sys.stderr, flush=True)
    return LatencyResult(out, results, calls, exact, cfg)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
