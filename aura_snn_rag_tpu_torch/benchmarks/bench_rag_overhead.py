"""Memory's share of a training step on the port, RAG-live against
memory off (counterpart of `benchmarks/bench_rag_overhead.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_rag_overhead
        [--steps=30] [--batch=16] [--device cuda]

A `Trainer` at `get_full_config()` (768 wide, 12 RAG layers, seq 512)
with remat "dots", the given batch, memory from step 0, no thalamus gate,
a bf16 first moment; its bank of 100,000 holds 80,000 `RandomState(0)`
rows (`bulk_load`, no index). It times, per step after one warm-up step:

- memory off (`_run_step(use_memory=False)`), the step that 6 x params x
  tokens is divided by in each MFU;
- RAG-live without episodic writes: 12 `MemoryAugmentedLayer`s, each one
  `retrieve_auto` over the bank;
- RAG-live with a write of the batch's summaries at every step;

then, alone, the 12 retrievals of one batch of random queries
(`retrieve_auto` at the model's k) and one write of a [batch, 768] batch
(`write_memories`), 10 times each, with the analytic bytes of the
retrievals. At batch 16, `retrieve_auto` takes the flat scan (16 x probe
8 x capacity 896 >= 100,000 rows), PyTorch ops with no kernel of the
port's; a batch of 8 or less would take IVF v3r once the bank has an
index (it has none here, so brute force).

MFU divides by the H100 SXM's dense bf16 tensor-core peak, 989 TFLOPS
(NVIDIA's datasheet gives 1,979 with sparsity); the metric names the
card the run took.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch import config as cfg_mod
from aura_snn_rag_tpu_torch._device import (
    H100_SXM_BF16_PEAK_FLOPS, resolve_device)
from aura_snn_rag_tpu_torch.bench import _sync
from aura_snn_rag_tpu_torch.memory import engine
from aura_snn_rag_tpu_torch.training.trainer import Trainer

SEED_ROWS = 80_000                    # rows the bank holds
ISOLATED_REPS = 10


def full_config():
    """The configuration the benchmark trains: `get_full_config()`."""
    return cfg_mod.get_full_config()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_rag_overhead",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30,
                    help="timed steps per variant")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    return ap


class RagOverheadResult(NamedTuple):
    line: dict                    # the JSON line
    losses: List[float]           # every step's loss, the warm-ups too
    config: object                # the AuraConfig trained


def run(argv: Optional[Sequence[str]] = None) -> RagOverheadResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    batch, steps = args.batch, args.steps
    full = full_config()
    full = full.replace(
        model=dataclasses.replace(full.model,
                                  use_gradient_checkpointing=True,
                                  gradient_checkpoint_policy="dots"),
        training=dataclasses.replace(
            full.training, batch_size=batch, memory_warmup_steps=0,
            enable_thalamus=False, optimizer_mu_dtype="bfloat16",
            metrics_fetch_interval=10))
    trainer = Trainer(full, seed=0, device=dev)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    L = full.model.max_seq_len
    D = full.memory.feature_dim
    tokens_per_step = batch * L
    flops_per_step = 6 * n_params * tokens_per_step

    # a bank of SEED_ROWS rows, so retrieval scans a realistic count
    rng = np.random.RandomState(0)
    seed_feats = rng.randn(SEED_ROWS, D).astype(np.float32)
    hf = trainer.hippocampus
    hf._set_state(engine.bulk_load(
        full.memory, hf.state, torch.from_numpy(seed_feats).to(dev),
        torch.zeros((SEED_ROWS, 2), device=dev)))
    ids = torch.from_numpy(
        rng.randint(0, full.model.vocab_size, (batch, L))).to(dev)
    metrics = []

    def timed_steps(use_memory, store_memory, n=steps):
        metrics.append(trainer._run_step(ids, ids, use_memory,
                                         store_memory))      # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            metrics.append(trainer._run_step(ids, ids, use_memory,
                                             store_memory))
        _sync(dev)
        return (time.perf_counter() - t0) / n

    t_off = timed_steps(False, False)
    t_rag = timed_steps(True, False)
    t_rag_store = timed_steps(True, True)
    losses = [float(m[0]) for m in metrics]

    # isolated retrieval: the 12 per-layer retrievals the RAG step adds
    n_rag_layers = full.model.num_layers
    q = torch.from_numpy(rng.randn(batch, D).astype(np.float32)).to(dev)

    def retrieval_only(ms, q):
        outs = [engine.retrieve_auto(full.memory, ms, q, None,
                                     full.model.num_retrieved).scores
                for _ in range(n_rag_layers)]
        return torch.stack(outs).sum()

    with torch.no_grad():
        retrieval_only(hf.state, q)                       # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(ISOLATED_REPS):
            retrieval_only(hf.state, q)
        _sync(dev)
    t_retr = (time.perf_counter() - t0) / ISOLATED_REPS

    # isolated write of one [B, D] batch (in place: the bank's rows past
    # the seeded ones)
    wfeats = torch.from_numpy(rng.randn(batch, D).astype(np.float32)).to(dev)
    wl = torch.zeros((batch, 2), device=dev)
    ms2 = engine.write_memories(full.memory, hf.state, wfeats, wl)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(ISOLATED_REPS):
        ms2 = engine.write_memories(full.memory, ms2, wfeats, wl)
    _sync(dev)
    t_write = (time.perf_counter() - t0) / ISOLATED_REPS

    def mfu(t):
        return flops_per_step / t / H100_SXM_BF16_PEAK_FLOPS

    # analytic bytes of the retrievals (a bf16 scan of the active rows per
    # layer)
    retr_bytes = n_rag_layers * SEED_ROWS * D * 2
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")
    line = {
        "metric": f"RAG overhead attribution (full preset, one {card})",
        "n_params": n_params, "batch": batch, "seq_len": L,
        "step_ms_memory_off": round(t_off * 1e3, 2),
        "step_ms_rag_no_store": round(t_rag * 1e3, 2),
        "step_ms_rag_store": round(t_rag_store * 1e3, 2),
        "mfu_memory_off": round(mfu(t_off), 4),
        "mfu_rag_no_store": round(mfu(t_rag), 4),
        "mfu_rag_store_every_step": round(mfu(t_rag_store), 4),
        "isolated_retrieval_ms": round(t_retr * 1e3, 2),
        "isolated_write_ms": round(t_write * 1e3, 2),
        "retrieval_gap_ms": round((t_rag - t_off) * 1e3, 2),
        "store_gap_ms": round((t_rag_store - t_rag) * 1e3, 2),
        "retrieval_hbm_gb_per_step": round(retr_bytes / 1e9, 3),
        "tok_s_rag_live_store10": round(
            tokens_per_step / (t_rag + 0.1 * (t_rag_store - t_rag)), 1),
    }
    return RagOverheadResult(line, losses, full)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
