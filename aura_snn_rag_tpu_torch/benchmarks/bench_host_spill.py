"""The host-spilled bank's benchmark on the port (counterpart of
`benchmarks/bench_host_spill.py`): 10,000,000 x 768 rows on one card,
the int8 coarse rows on the device and the exact f32 rows in host RAM
(`memory/host_spill.SpilledBank`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_host_spill [--small]
        [--n=N] [--batch=B] [--batches=NB] [--breakdown]
        [--funnel-blocks=F] [--funnel-rows=R] [--sweep=fb64r192,...]
        [--device cuda]

The flags are the JAX script's, with its defaults: 10M rows (`--small`:
1M), a funnel of 64 8-row blocks per query, the config's row funnel,
query batches of 128 (also the coalesce width of `retrieve_stream`), and
max(2, 2048 / B) batches (`--small`: 1024 / B). `--breakdown` prints the
per-batch stages before the line: dispatch (enqueue every funnel),
device funnel (from the same start until the card is done), transfer
(slot ids to the host) and host rerank. `--sweep` measures each
(`flat_block_funnel`, `spill_funnel_rows`[, `spill_query_chunk`]) item
against the one ingested bank, one line each.

The rows are the JAX script's, bit for bit: `chunk_factory`'s numpy
draws, made chunk by chunk during `bulk_load_chunked`. The queries are
stored rows plus noise from `RandomState(7)`. The device funnel runs
kernel A (`ops/cuda/flat_scan.py`) ceil(B / `spill_query_chunk`) times
per dispatch, and the host rerank runs in C++ (`native/`). The exact
ground truth is the cosine top-10 of every stored row for the first 256
queries, in chunks of rows on the run's device (f32 products, TF32
off), the JAX script's chunked numpy search. `hbm_resident_gb` is the
device bank's bytes (int8 rows, per-row scale, strength and timestamp),
`host_resident_gb` the host's f32 rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import _sync, recall_at_k
from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory.host_spill import SpilledBank

D = 768
TOPK = 10
N_EVAL = 256            # queries scored against the exact ground truth
N_CENTERS = 4096
CHUNK = 262_144         # rows per ingest chunk and per ground-truth chunk
QUERY_SEED = 7


def parse_sweep_item(item: str) -> Tuple[int, int, Optional[int]]:
    """"fb64r192" -> (64, 192, None); "fb64r192qc512" -> (64, 192, 512)."""
    fb, rest = item[2:].split("r")
    qc = None
    if "qc" in rest:
        rest, qc = rest.split("qc")
        qc = int(qc)
    return int(fb), int(rest), qc


def chunk_factory(seed0: int = 0):
    """The JAX script's rows: `make(offset, b)` draws b clustered rows from
    `RandomState(1000 + offset)` around 4096 centres of
    `RandomState(seed0)`, so the full f32 bank never exists twice."""
    rng0 = np.random.RandomState(seed0)
    centers = rng0.randn(N_CENTERS, D).astype(np.float32) * 2.0

    def make(offset, b):
        rng = np.random.RandomState(1000 + offset)
        assign = rng.randint(0, N_CENTERS, b)
        return centers[assign] + rng.randn(b, D).astype(np.float32)

    return make


def make_queries(host_features: np.ndarray, n_rows: int,
                 n_queries: int) -> np.ndarray:
    """Stored rows at random offsets plus 0.5 x noise, from the bank's own
    host rows (`RandomState(7)`, as the JAX script)."""
    rng = np.random.RandomState(QUERY_SEED)
    q_off = rng.randint(0, max(1, n_rows - CHUNK), n_queries)
    queries = host_features[q_off].astype(np.float32).copy()
    queries += 0.5 * rng.randn(n_queries, host_features.shape[1]).astype(
        np.float32)
    return queries


def exact_ground_truth(host_features: np.ndarray, n_rows: int,
                       queries: np.ndarray, k: int,
                       device) -> np.ndarray:
    """The exact cosine top-k [Q, k] over the first n_rows host rows:
    CHUNK rows at a time on `device`, f32 products with TF32 off, each
    chunk's top-k merged into the running best."""
    dev = torch.device(device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
        qn = q / (q.norm(dim=1, keepdim=True) + 1e-12)
        best_v = torch.full((len(queries), k), -1e30, device=dev)
        best_i = torch.zeros((len(queries), k), dtype=torch.long, device=dev)
        for off in range(0, n_rows, CHUNK):
            rows = torch.from_numpy(host_features[off:min(off + CHUNK,
                                                          n_rows)]).to(dev)
            rn = rows / (rows.norm(dim=1, keepdim=True) + 1e-12)
            v, i = torch.topk(qn @ rn.T, min(k, rows.shape[0]), dim=1)
            best_v, pick = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            best_i = torch.cat([best_i, i + off], 1).gather(1, pick)
        return best_i.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_host_spill",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="1,000,000 rows")
    ap.add_argument("--n", type=int, default=None, help="rows in the bank")
    ap.add_argument("--batch", type=int, default=128,
                    help="queries per funnel dispatch")
    ap.add_argument("--batches", type=int, default=None,
                    help="batches in the measured stream")
    ap.add_argument("--breakdown", action="store_true",
                    help="print the per-batch stages before the line")
    ap.add_argument("--funnel-blocks", type=int, default=64,
                    help="8-row blocks reranked per query")
    ap.add_argument("--funnel-rows", type=int, default=None,
                    help="second-stage row funnel (spill_funnel_rows)")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated fb<F>r<R>[qc<Q>] items")
    ap.add_argument("--device", default="cuda")
    return ap


class Measured(NamedTuple):
    breakdown: Optional[dict]     # the breakdown line, or None
    line: dict                    # the JSON line
    indices: np.ndarray           # [n_queries, k] of the timed stream
    dispatches: List[int]         # queries of every funnel dispatch made


class SpillResult(NamedTuple):
    configs: List[Measured]       # one per configuration (sweep item)
    truth: np.ndarray             # [n_eval, k] exact ground truth
    queries: np.ndarray
    bank: SpilledBank


class Stream(NamedTuple):
    qps: float                    # of the timed stream
    results: list                 # its RetrievalResults, one per batch
    stages_ms: Optional[dict]     # ms per batch of each stage, or None
    funnel_bytes: Optional[int]   # one batch's slot ids pulled to the host
    dispatches: List[int]         # queries of every funnel dispatch made


def measure(bank: SpilledBank, batches: Sequence[np.ndarray],
            breakdown: bool) -> Stream:
    """At the bank's config: one warm call at the full batch, the timed
    stream coalesced at the batch, then (with `breakdown`) the stages of
    each batch, unrounded."""
    dev = bank.device
    batch = batches[0].shape[0]
    n_q = sum(b.shape[0] for b in batches)
    dispatches = [batch]
    bank.retrieve(batches[0])                              # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    # coalesce pinned to the dispatch batch, so --batch is the one knob;
    # the results are on the host when the call returns
    results = bank.retrieve_stream(batches, coalesce=batch)
    qps = n_q / (time.perf_counter() - t0)
    dispatches += [b.shape[0] for b in batches]
    if not breakdown:
        return Stream(qps, results, None, None, dispatches)
    _sync(dev)
    t0 = time.perf_counter()
    inflight = [bank._dispatch_funnel(b) for b in batches]
    dispatch_s = time.perf_counter() - t0
    _sync(dev)
    device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pulled = [f.cpu().numpy() for _, _, f in inflight]
    transfer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for (qn_b, B, _), f in zip(inflight, pulled):
        bank._host_rerank(qn_b, B, f, TOPK, None)
    rerank_s = time.perf_counter() - t0
    dispatches += [b.shape[0] for b in batches]
    n = len(batches)
    stages_ms = {"dispatch": dispatch_s / n * 1e3,
                 "device_funnel": device_s / n * 1e3,
                 "transfer": transfer_s / n * 1e3,
                 "host_rerank": rerank_s / n * 1e3}
    return Stream(qps, results, stages_ms, pulled[0].nbytes, dispatches)


def breakdown_line(bank: SpilledBank, stream: Stream, n_rows: int) -> dict:
    """The JAX script's breakdown line from a measured stream."""
    return {
        "breakdown_per_batch_ms": {name: round(ms, 1) for name, ms
                                   in stream.stages_ms.items()},
        "funnel_bytes_per_batch": stream.funnel_bytes,
        "funnel_blocks": bank.config.flat_block_funnel,
        "funnel_rows": bank.config.spill_funnel_rows,
        "n_vectors": n_rows,
    }


def report(bank: SpilledBank, qps: float, results, truth: np.ndarray,
           ingest_s: float, n_rows: int, batch: int) -> Tuple[dict,
                                                              np.ndarray]:
    got = np.concatenate([r.indices for r in results])
    recall = recall_at_k(got[:len(truth)], truth)
    dev = bank.dev
    device_bytes = sum(t.numel() * t.element_size() for t in (
        dev.coarse, dev.scale, dev.strength, dev.timestamp))
    line = {
        "metric": f"host-spilled retrieval QPS @ {n_rows} vectors",
        "value": round(qps, 1), "unit": "queries/s",
        "recall_at_10": round(recall, 4),
        "ingest_s": round(ingest_s, 1),
        "n_vectors": n_rows, "coarse_dtype": "int8",
        "batch": batch,
        "funnel_blocks": bank.config.flat_block_funnel,
        "funnel_rows": bank.config.spill_funnel_rows,
        "query_chunk": bank.config.spill_query_chunk,
        "hbm_resident_gb": round(device_bytes / 2**30, 2),
        "host_resident_gb": round(bank.host_features.nbytes / 2**30, 2),
    }
    return line, got


def stream_sizes(args: argparse.Namespace) -> Tuple[int, int, int]:
    """(rows, queries per batch, batches) from the flags."""
    n = args.n or (1_000_000 if args.small else 10_000_000)
    n_batches = args.batches or max(2, (1024 if args.small else 2048)
                                    // args.batch)
    return n, args.batch, n_batches


def run(argv: Optional[Sequence[str]] = None) -> SpillResult:
    """The benchmark at the flags in `argv`: ingest, the exact ground
    truth, then each configuration's measurement."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    n, batch, n_batches = stream_sizes(args)
    if dev.type == "cuda":
        # nvcc before any timer
        from aura_snn_rag_tpu_torch.ops.cuda import _build
        _build.build_all()
        _build.load("flat_scan")
    rows_kw = ({} if args.funnel_rows is None
               else {"spill_funnel_rows": args.funnel_rows})
    cfg = MemoryConfig(
        max_memories=n, feature_dim=D, retrieve_k=TOPK, coarse_dtype="int8",
        flat_block_funnel=args.funnel_blocks,
        # index settings the spilled bank never reads, kept small
        k_centroids=16, n_place_cells=8, n_grid_cells=4, n_time_cells=2,
        **rows_kw)
    bank = SpilledBank(cfg, device=dev)
    make = chunk_factory()
    _sync(dev)
    t0 = time.perf_counter()
    bank.bulk_load_chunked(make, n, chunk=CHUNK)
    _sync(dev)
    ingest_s = time.perf_counter() - t0

    queries = make_queries(bank.host_features, n, batch * n_batches)
    batches = [queries[i * batch:(i + 1) * batch] for i in range(n_batches)]
    truth = exact_ground_truth(bank.host_features, n, queries[:N_EVAL],
                               TOPK, dev)

    configs = []
    items = (None,) if args.sweep is None else args.sweep.split(",")
    for item in items:
        if item is not None:
            fb, rows, qc = parse_sweep_item(item)
            qc_kw = {} if qc is None else {"spill_query_chunk": qc}
            bank.config = dataclasses.replace(
                bank.config, flat_block_funnel=fb, spill_funnel_rows=rows,
                **qc_kw)
        stream = measure(bank, batches, args.breakdown)
        line, got = report(bank, stream.qps, stream.results, truth,
                           ingest_s, n, batch)
        stages = (breakdown_line(bank, stream, n) if args.breakdown
                  else None)
        configs.append(Measured(stages, line, got, stream.dispatches))
    return SpillResult(configs, truth, queries, bank)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the benchmark and print its line(s), each configuration's
    breakdown line first; returns the lines."""
    out = []
    for m in run(argv).configs:
        for obj in (m.breakdown, m.line):
            if obj is not None:
                print(json.dumps(obj), flush=True)
                out.append(obj)
    return out


if __name__ == "__main__":
    main()
