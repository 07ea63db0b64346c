"""The IVF dispatch's time per stage on the port (counterpart of
`benchmarks/bench_retrieval_breakdown.py`). Each stage runs as its own
call, once to warm up and then `--reps` times back to back, fenced at the
card's finish:

  1. aux_build      the [K, 8, C] metadata sidecar (`build_ivf_aux`)
  2. centroid_topP  centroid product + top-P
  3. kernel_v2      kernel E, `ivf_topk_scores`: per-probe coarse top-k
  4. kernel_v1      kernel C, `ivf_scan_scores`: the probed blocks'
                    cosines, with no selection
  5. kernel_v3      kernel D, `ivf_candidates`: coarse top-kk across probes
  6. funnel_rerank  the v2 funnel's coarse top-kk, exact f32 rerank, top-k
  7. full_v3        `retrieve` with the aux built once, at the config's
                    default kernel (v3r, kernel B: the JAX script's label
                    for its default config)
  8. full_v3r       the same with ivf_kernel v3r (kernel B)
  9. full_v2        the same with ivf_kernel v2 (kernel E)
 10. full_noaux     `retrieve` building the aux per call (kernel B)

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_retrieval_breakdown
        [--small] [--batches 1,8] [--reps 16] [--device cuda]

The configuration, rows and queries are `bench_retrieval_latency`'s. On
the card the stage kernels are the CUDA kernels, through their wrappers
in `ops/cuda/ivf_scan.py`; on the CPU their plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import _sync, memory_config
from aura_snn_rag_tpu_torch.benchmarks import bench_retrieval_latency as lat
from aura_snn_rag_tpu_torch.memory import retrieve
from aura_snn_rag_tpu_torch.memory.engine import NEG_INF, build_ivf_aux
from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import (
    ivf_candidates, ivf_scan_scores, ivf_topk_scores)
from aura_snn_rag_tpu_torch.ops.scoring import combined_score, l2norm

TOPK = 10
STAGES = ("aux_build", "centroid_topP", "kernel_v2", "kernel_v1",
          "kernel_v3", "funnel_rerank", "full_v3", "full_v3r", "full_v2",
          "full_noaux")


def stage_centroid(state, q: torch.Tensor, probe: int):
    """(qn [B, D], top_c [B, P]): the nearest `probe` centroids by L2."""
    qn = l2norm(q)
    c2 = (state.centroids ** 2).sum(-1)
    cdist = c2[None, :] - 2.0 * (q @ state.centroids.T)
    return qn, torch.topk(-cdist, probe, dim=1).indices


def stage_funnel(cfg, state, qn: torch.Tensor, sc: torch.Tensor,
                 sl: torch.Tensor, per_k: int, kk: int, k: int):
    """The v2 funnel: the per-probe coarse top-k, its top-kk, the exact
    f32 rerank of those rows and the final top-k -> (slots, scores)."""
    B = qn.shape[0]
    combined = sc[:, :, :per_k].reshape(B, -1)
    slots = sl[:, :, :per_k].clamp(min=0).reshape(B, -1).long()
    valid = combined > NEG_INF / 2
    if combined.shape[-1] > kk:
        _, pick = torch.topk(combined, kk, dim=1)
        slots, valid = slots.gather(1, pick), valid.gather(1, pick)
    exact_cos = torch.einsum("bkd,bd->bk",
                             l2norm(state.features[slots].float()), qn)
    exact = combined_score(cfg, state, exact_cos, slots, None)
    exact = torch.where(valid, exact, NEG_INF)
    scores, pick2 = torch.topk(exact, k, dim=1)
    return slots.gather(1, pick2), scores


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_retrieval_breakdown",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    return ap


class BreakdownResult(NamedTuple):
    line: dict                              # the JSON line
    outputs: Dict[int, Dict[str, object]]   # B -> stage -> its last output
    calls: Dict[int, Dict[str, int]]        # B -> stage -> calls made


def run(argv: Optional[Sequence[str]] = None) -> BreakdownResult:
    """The breakdown at the flags in `argv`. `calls[B]["kernel_v2"]`
    counts the untimed call that makes the funnel's input too."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    batches = [int(b) for b in args.batches.split(",")]
    n, k_centroids, probe, overflow = lat.sizes(args.small)
    if dev.type == "cuda":
        # nvcc before any timer
        from aura_snn_rag_tpu_torch.ops.cuda import _build
        _build.build_all()
        _build.load("ivf_scan")
    cfg = memory_config(n, k_centroids, probe, overflow, "bf16")
    cfg_v2 = dataclasses.replace(cfg, ivf_kernel="v2")
    cfg_v3r = dataclasses.replace(cfg, ivf_kernel="v3r")
    feats, queries = lat.make_inputs(n, max(batches))
    state = lat.build_index(cfg, feats, dev)
    del feats
    print("index built", file=sys.stderr, flush=True)

    C = state.bucket_capacity
    kk = min(max(cfg.rerank_candidates, 4 * TOPK), probe * C)
    per_k = min(max(TOPK, -(-kk // probe)), C)
    KK = -(-kk // 128) * 128
    aux = build_ivf_aux(cfg, state)
    _sync(dev)

    out = {"metric": "ivf retrieval stage breakdown", "n_vectors": n,
           "probe": probe, "bucket_capacity": C, "per_k": per_k}
    outputs, calls = {}, {}

    def timed(label, fn):
        r = fn()                                         # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            r = fn()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / args.reps
        print(f"  {label:16s} {ms:8.3f} ms", file=sys.stderr, flush=True)
        outputs[B][label] = r
        calls[B][label] = calls[B].get(label, 0) + args.reps + 1
        return round(ms, 3)

    for B in batches:
        qb = torch.from_numpy(queries[:B]).to(dev)
        print(f"B={B}:", file=sys.stderr, flush=True)
        outputs[B], calls[B] = {}, {}
        res = {}
        res["aux_build_ms"] = timed("aux_build",
                                    lambda: build_ivf_aux(cfg, state))
        qn, top_c = stage_centroid(state, qb, probe)
        res["centroid_topP_ms"] = timed(
            "centroid_topP", lambda: stage_centroid(state, qb, probe))
        sc, sl = ivf_topk_scores(state.clustered, aux, qn, top_c, per_k)
        calls[B]["kernel_v2"] = 1
        res["kernel_v2_ms"] = timed(
            "kernel_v2",
            lambda: ivf_topk_scores(state.clustered, aux, qn, top_c, per_k))
        res["kernel_v1_ms"] = timed(
            "kernel_v1", lambda: ivf_scan_scores(state.clustered, qn, top_c))
        res["kernel_v3_ms"] = timed(
            "kernel_v3",
            lambda: ivf_candidates(state.clustered, aux, qn, top_c, KK))
        res["funnel_rerank_ms"] = timed(
            "funnel_rerank",
            lambda: stage_funnel(cfg, state, qn, sc, sl, per_k, kk, TOPK))
        res["full_v3_ms"] = timed(
            "full_v3", lambda: retrieve(cfg, state, qb, None, TOPK, aux=aux))
        res["full_v3r_ms"] = timed(
            "full_v3r",
            lambda: retrieve(cfg_v3r, state, qb, None, TOPK, aux=aux))
        res["full_v2_ms"] = timed(
            "full_v2",
            lambda: retrieve(cfg_v2, state, qb, None, TOPK, aux=aux))
        res["full_noaux_ms"] = timed(
            "full_noaux", lambda: retrieve(cfg, state, qb, None, TOPK))
        out[f"B{B}"] = res
    return BreakdownResult(out, outputs, calls)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the breakdown and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
