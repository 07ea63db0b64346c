"""Flagship-scale training on an on-disk token corpus (counterpart of
`examples/train_flagship.py`).

    python -m aura_snn_rag_tpu_torch.examples.train_flagship --preset full
        --steps 10000 --corpus DIR --log runs/flagship.jsonl
        [--device cuda]

The corpus folder is what `tools/build_offline_corpus.py` writes:
`train.npy` and `val.npy` (flat uint16 token streams) and `meta.json`
(its `vocab_size` sets the model's). The preset (full by default: 768
wide, 12 layers) trains in chunks of `--chunk` steps (`train_chunk`, one
read of the metrics per chunk) on random windows of the train stream,
with the thalamic and endocrine memory vetoes off; each chunk appends a
JSONL record (loss, ce, perplexity, tokens/s, MFU, the bank's count, the
seconds so far, and at every `--eval-every` steps the loss over up to 8
validation batches of 8) to `--log`, and a checkpoint is saved every
`--save-every` steps and at the end. MFU is 6 x parameters x tokens/s
over the H100 SXM's dense bf16 peak (`_device.H100_SXM_BF16_PEAK_FLOPS`).
A run with a checkpoint in `--checkpoint-dir` resumes at its step; the
first chunk after the restore runs on the restored state.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from aura_snn_rag_tpu_torch import config as cfg_mod
from aura_snn_rag_tpu_torch._device import (
    H100_SXM_BF16_PEAK_FLOPS, resolve_device)
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
from aura_snn_rag_tpu_torch.training.data import TokenStream
from aura_snn_rag_tpu_torch.training.trainer import Trainer


def count_params(trainer: Trainer) -> int:
    return sum(p.numel() for p in trainer.model.parameters())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.train_flagship",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="full")
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--corpus", default="/root/data/corpus")
    ap.add_argument("--batch", type=int, default=0,
                    help="override preset batch size")
    ap.add_argument("--chunk", type=int, default=20,
                    help="train steps per metrics read")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--save-every", type=int, default=2500)
    ap.add_argument("--log", default="runs/flagship.jsonl")
    ap.add_argument("--checkpoint-dir", default="checkpoints_flagship")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="override preset max_seq_len")
    ap.add_argument("--grad-checkpoint", action="store_true")
    ap.add_argument("--ckpt-policy", default="full",
                    help="remat policy: full | dots (save matmul outputs, "
                         "recompute only elementwise work)")
    ap.add_argument("--mu-dtype", default="",
                    help="AdamW first-moment dtype override (e.g. bfloat16 "
                         "halves the first moment's bytes)")
    ap.add_argument("--memory-warmup", type=int, default=-1,
                    help="override memory_warmup_steps (0 = RAG live from "
                         "step 0; useful for short throughput probes)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the same as --device cpu)")
    ap.add_argument("--device", default="cuda")
    return ap


def config(args, vocab_size: int):
    """The preset with the corpus's vocabulary and the script's
    overrides."""
    cfg = getattr(cfg_mod, f"get_{args.preset}_config")()
    model_kw = dict(vocab_size=vocab_size)
    if args.seq_len:
        model_kw["max_seq_len"] = args.seq_len
    if args.grad_checkpoint:
        model_kw["use_gradient_checkpointing"] = True
        model_kw["gradient_checkpoint_policy"] = args.ckpt_policy
    train_kw = dict(max_steps=args.steps,
                    # thalamic veto off for unattended long runs: with a
                    # fresh model the gate clamps low and silently disables
                    # memory
                    enable_thalamus=False,
                    # likewise the hormone memory veto: accuracy=exp(-loss)
                    # saturates near 0 at converged LM loss, so the gate
                    # would shut episodic memory off permanently mid-run
                    # (hormone LR scaling stays active)
                    endocrine_memory_gating=False)
    if args.batch:
        train_kw["batch_size"] = args.batch
    if args.mu_dtype:
        train_kw["optimizer_mu_dtype"] = args.mu_dtype
    if args.memory_warmup >= 0:
        train_kw["memory_warmup_steps"] = args.memory_warmup
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_kw),
        training=dataclasses.replace(cfg.training, **train_kw))


class FlagshipResult(NamedTuple):
    lines: List[str]
    start: int                    # the step the run resumed at
    records: List[Dict]           # the JSONL records, the final one last
    trainer: Trainer


def run(argv: Optional[Sequence[str]] = None) -> FlagshipResult:
    args = parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    with open(os.path.join(args.corpus, "meta.json")) as f:
        meta = json.load(f)
    cfg = config(args, meta["vocab_size"])

    out = Lines()
    L = cfg.model.max_seq_len
    B = cfg.training.batch_size
    train = TokenStream(os.path.join(args.corpus, "train.npy"), L, seed=0)
    val = TokenStream(os.path.join(args.corpus, "val.npy"), L, seed=1)
    out(f"corpus: {train.n_tokens/1e6:.1f}M train / "
        f"{val.n_tokens/1e6:.1f}M val tokens, vocab {meta['vocab_size']}")

    trainer = Trainer(cfg, seed=0, device=dev)
    n_params = count_params(trainer)
    flops_per_tok = 6 * n_params
    out(f"model: {n_params/1e6:.1f}M params, B={B}, L={L}, "
        f"chunk={args.chunk}")

    ckpt = CheckpointManager(args.checkpoint_dir)
    start = ckpt.restore(trainer)
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)

    def run_eval():
        losses = []
        for batch in val.eval_batches(8, max_batches=8):
            losses.append(trainer.eval_loss(batch, batch))
        l = float(np.mean(losses))
        return l, math.exp(min(l, 20.0))

    records = []
    step = start
    t_start = time.time()
    tokens_done = 0
    with open(args.log, "a", buffering=1) as logf:
        while step < args.steps:
            n = min(args.chunk, args.steps - step)
            chunk = train.sample_chunk(n, B)
            t0 = time.time()
            m = trainer.train_chunk(chunk, chunk)
            dt = time.time() - t0
            step += n
            tokens = n * B * L
            tokens_done += tokens
            tok_s = tokens / dt
            mfu = flops_per_tok * tok_s / H100_SXM_BF16_PEAK_FLOPS
            rec = {"step": step, "loss": m["loss"], "ce": m["ce"],
                   "ppl": math.exp(min(m["ce"], 20.0)),
                   "tok_s": round(tok_s), "mfu": round(mfu, 4),
                   "mem_count": int(trainer.hippocampus.memory_count),
                   "elapsed_s": round(time.time() - t_start)}
            if step % args.eval_every < n:
                rec["val_loss"], rec["val_ppl"] = run_eval()
            logf.write(json.dumps(rec) + "\n")
            records.append(rec)
            out(rec)
            if step % args.save_every < n or step >= args.steps:
                ckpt.save(step, trainer, m["loss"])
                out(f"checkpoint @ {step}")

        avg_tok_s = tokens_done / (time.time() - t_start)
        final = {"final": True, "steps": step, "avg_tok_s": round(avg_tok_s),
                 "avg_mfu": round(flops_per_tok * avg_tok_s
                                  / H100_SXM_BF16_PEAK_FLOPS, 4),
                 "n_params": n_params}
        final["val_loss"], final["val_ppl"] = run_eval()
        logf.write(json.dumps(final) + "\n")
    records.append(final)
    out(final)
    return FlagshipResult(out, start, records, trainer)


def main(argv: Optional[Sequence[str]] = None) -> FlagshipResult:
    """Train, log and print the script's lines."""
    return run(argv)


if __name__ == "__main__":
    main()
