"""WikiText-2 training with validation perplexity and checkpoints
(counterpart of `examples/train_wikitext2.py`).

    python -m aura_snn_rag_tpu_torch.examples.train_wikitext2
        [--steps 1000] [--preset test] [--eval-every 100]
        [--checkpoint-dir checkpoints_wt2] [--device cuda]

GPT-2-tokenised WikiText-2 through `load_hf_streaming` (4096 sequences,
ids clipped into the model's vocabulary) when `datasets` and
`transformers` import, else 1024 synthetic sequences; a tenth (at least
8) held out for validation. Resumes from the newest checkpoint in
`--checkpoint-dir`; every `--eval-every` steps the perplexity of up to
32 held-out sequences in batches of 8, and a checkpoint when it is the
best so far.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from aura_snn_rag_tpu_torch import config as cfg_mod
from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.training import data as data_mod
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
from aura_snn_rag_tpu_torch.training.trainer import Trainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.train_wikitext2",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--preset", default="test")
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--checkpoint-dir", default="checkpoints_wt2")
    ap.add_argument("--device", default="cuda")
    return ap


class WikiResult(NamedTuple):
    lines: List[str]
    start: int                    # the step the run resumed at
    val_ppl: List[float]          # each evaluation's perplexity
    best_ppl: float
    trainer: Trainer


def run(argv: Optional[Sequence[str]] = None) -> WikiResult:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = getattr(cfg_mod, f"get_{args.preset}_config")()
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, max_steps=args.steps, enable_thalamus=False))

    out = Lines()
    try:
        seqs = data_mod.load_hf_streaming(
            "wikitext", "wikitext-2-raw-v1", "gpt2",
            seq_len=cfg.model.max_seq_len, max_sequences=4096)
        # gpt2 vocab is 50257; clip into the model vocab
        seqs = np.clip(seqs, 0, cfg.model.vocab_size - 1)
        out(f"wikitext-2: {seqs.shape}")
    except ImportError:
        seqs = data_mod.synthesize_sequences(cfg.model, n_sequences=1024)
        out(f"synthetic fallback: {seqs.shape}")

    n_val = max(8, len(seqs) // 10)
    train_seqs, val_seqs = seqs[n_val:], seqs[:n_val]

    trainer = Trainer(cfg, seed=0, device=dev)
    ckpt = CheckpointManager(args.checkpoint_dir)
    start = ckpt.restore(trainer)
    it = data_mod.batch_iterator(train_seqs, cfg.training.batch_size)

    best_ppl = float("inf")
    ppls = []
    for step in range(start, args.steps):
        ids = next(it)
        m = trainer.train_step(ids, ids)
        if step % args.eval_every == 0:
            val_losses = [trainer.eval_loss(val_seqs[i:i + 8],
                                            val_seqs[i:i + 8])
                          for i in range(0, min(len(val_seqs), 32), 8)]
            val_ppl = math.exp(min(float(np.mean(val_losses)), 20))
            ppls.append(val_ppl)
            out(f"step {step}: train_loss={m['loss']:.4f} "
                f"val_ppl={val_ppl:.1f}")
            if val_ppl < best_ppl:
                best_ppl = val_ppl
                ckpt.save(step, trainer, m["loss"])
    out(f"best val ppl: {best_ppl:.1f}")
    return WikiResult(out, start, ppls, best_ppl, trainer)


def main(argv: Optional[Sequence[str]] = None) -> WikiResult:
    """Train, evaluate and print the script's lines."""
    return run(argv)


if __name__ == "__main__":
    main()
