"""Minimal end-to-end training (counterpart of `examples/train_tiny.py`).

    python -m aura_snn_rag_tpu_torch.examples.train_tiny [--steps 100]
        [--preset debug] [--device cuda]

The preset's hippocampal transformer (debug by default) trained on
`synthesize_sequences` (256 sequences) with the modulator stack, memory
on after 20 steps, the thalamus gate off and a sleep phase every 50
steps; a line every 20 steps (loss, perplexity, memory on or off, the
bank's count), the tokens/s of the whole run, then 16 tokens generated
from the first sequence's first 8. The sampler draws from a
`torch.Generator` seeded 0 (the script's `PRNGKey(0)` draws other bits).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch import config as cfg_mod
from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.generation import generate
from aura_snn_rag_tpu_torch.training.data import (
    batch_iterator, synthesize_sequences)
from aura_snn_rag_tpu_torch.training.trainer import Trainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.train_tiny",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--preset", default="debug")
    ap.add_argument("--device", default="cuda")
    return ap


class TinyResult(NamedTuple):
    lines: List[str]              # what the run printed
    metrics: List[Dict]           # every train_step's metrics
    generated: List[int]          # the 16 new tokens
    trainer: Trainer


def run(argv: Optional[Sequence[str]] = None) -> TinyResult:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = getattr(cfg_mod, f"get_{args.preset}_config")()
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, max_steps=args.steps, memory_warmup_steps=20,
        enable_thalamus=False, sleep_interval=50))

    out = Lines()
    trainer = Trainer(cfg, seed=0, device=dev)
    seqs = synthesize_sequences(cfg.model, n_sequences=256)
    it = batch_iterator(seqs, cfg.training.batch_size)

    metrics = []
    t0 = time.time()
    for step in range(args.steps):
        ids = next(it)
        m = trainer.train_step(ids, ids)
        metrics.append(m)
        if step % 20 == 0:
            out(f"step {step}: loss={m['loss']:.4f} "
                f"ppl={math.exp(min(m['ce'], 20)):.1f} "
                f"mem={'on' if m['use_memory'] else 'off'} "
                f"bank={trainer.hippocampus.memory_count}")
    dt = time.time() - t0
    tok_s = args.steps * cfg.training.batch_size * cfg.model.max_seq_len / dt
    out(f"trained {args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")

    ids = generate(trainer.model, torch.as_tensor(seqs[:1, :8]), 16,
                   torch.Generator(device=dev).manual_seed(0))
    generated = np.asarray(ids[0, 8:].cpu()).tolist()
    out("generated:", generated)
    return TinyResult(out, metrics, generated, trainer)


def main(argv: Optional[Sequence[str]] = None) -> TinyResult:
    """Train, generate and print the script's lines."""
    return run(argv)


if __name__ == "__main__":
    main()
