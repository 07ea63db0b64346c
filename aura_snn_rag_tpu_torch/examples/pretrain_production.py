"""Production-style pretraining: wake/sleep, monitoring, diagnostics
(counterpart of `examples/pretrain_production.py`).

    python -m aura_snn_rag_tpu_torch.examples.pretrain_production
        [--steps 500] [--preset debug] [--checkpoint-dir checkpoints_prod]
        [--monitor-interval 30] [--device cuda]

Data: WikiText-2 through `load_hf_streaming` (1024 sequences) when
`datasets` and `transformers` import, else 512 synthetic sequences.
Training resumes from the newest checkpoint; memory comes on after a
tenth of the steps (at least 10), sleep replay every fifth (at least
50), the thalamus gate off. A daemon thread prints the step, loss,
perplexity, bank count, the card's memory in use (`get_memory_stats`;
the label `hbm`: the H100's memory is HBM3) and the ETA every
`--monitor-interval` seconds. A checkpoint at each `save_steps` step
whose loss is the best so far and at the end; at every quarter of the
run the next-token distribution of the batch's first 8 tokens
(`generation_diagnostics`: entropy, top probability, top-5 mass,
effective vocabulary, a collapse flag). A step that runs out of card
memory is retried once after `torch.cuda.empty_cache()`; any other error
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch import config as cfg_mod
from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.training import data as data_mod
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
from aura_snn_rag_tpu_torch.training.trainer import Trainer
from aura_snn_rag_tpu_torch.utils import get_memory_stats


@torch.no_grad()
def generation_diagnostics(model, prompt_ids) -> Dict:
    """Entropy, top-k mass and collapse of the model's next-token
    distribution after `prompt_ids` [1, L], without memory."""
    out, _ = model(torch.as_tensor(np.asarray(prompt_ids)).to(
        model.device, torch.long), use_memory=False)
    logits = out.logits[0, -1].float()
    probs = torch.softmax(logits, -1)
    logp = torch.log_softmax(logits, -1)
    entropy = float(-(probs * logp).sum())
    top5 = torch.topk(probs, 5).values
    diag = {
        "entropy": round(entropy, 3),
        "max_prob": round(float(probs.max()), 4),
        "top5_mass": round(float(top5.sum()), 4),
        "effective_vocab": round(math.exp(entropy), 1),
    }
    diag["collapse_warning"] = bool(diag["max_prob"] > 0.9
                                    or entropy < 1.0)
    return diag


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.pretrain_production",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--preset", default="debug")
    ap.add_argument("--checkpoint-dir", default="checkpoints_prod")
    ap.add_argument("--monitor-interval", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    return ap


def config(args):
    """The preset with the script's training changes."""
    cfg = getattr(cfg_mod, f"get_{args.preset}_config")()
    return cfg.replace(training=dataclasses.replace(
        cfg.training, max_steps=args.steps,
        memory_warmup_steps=max(10, args.steps // 10),
        sleep_interval=max(50, args.steps // 5),
        enable_thalamus=False))


class ProductionResult(NamedTuple):
    lines: List[str]
    losses: List[float]           # every step's reported loss
    diagnostics: List[Dict]
    retries: int                  # steps retried after running out of memory
    trainer: Trainer


def run(argv: Optional[Sequence[str]] = None) -> ProductionResult:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config(args)
    out = Lines()

    # data: HF streaming with synthetic fallback
    try:
        seqs = data_mod.load_hf_streaming(seq_len=cfg.model.max_seq_len,
                                          max_sequences=1024)
        source = "wikitext-2 (HF streaming)"
    except ImportError:
        seqs = data_mod.synthesize_sequences(cfg.model, n_sequences=512)
        source = "synthetic (HF datasets unavailable)"
    out(f"data: {source}, {seqs.shape}")

    trainer = Trainer(cfg, seed=0, device=dev)
    ckpt = CheckpointManager(args.checkpoint_dir)
    start = ckpt.restore(trainer)

    state = {"step": start, "loss": float("nan"), "t0": time.time(),
             "stop": threading.Event()}

    def monitor():
        while not state["stop"].wait(args.monitor_interval):
            done = state["step"] - start
            rate = done / max(time.time() - state["t0"], 1e-9)
            eta = (args.steps - state["step"]) / max(rate, 1e-9)
            mem = get_memory_stats(dev)
            out(f"[monitor] step={state['step']} loss={state['loss']:.4f} "
                f"ppl={math.exp(min(state['loss'], 20)):.1f} "
                f"bank={trainer.hippocampus.memory_count} "
                f"hbm={mem['bytes_in_use']/1e9:.2f}GB "
                f"eta={eta/60:.1f}min")

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()

    it = data_mod.batch_iterator(seqs, cfg.training.batch_size)
    best = float("inf")
    losses, diags, retries = [], [], 0
    try:
        for step in range(start, args.steps):
            ids = next(it)
            try:
                m = trainer.train_step(ids, ids)
            except torch.cuda.OutOfMemoryError:
                out("OOM caught — clearing caches and retrying")
                torch.cuda.empty_cache()
                retries += 1
                m = trainer.train_step(ids, ids)
            state["step"], state["loss"] = step, m["loss"]
            losses.append(m["loss"])

            if step > 0 and step % cfg.training.save_steps == 0 \
                    and m["loss"] < best:
                best = m["loss"]
                ckpt.save(step, trainer, m["loss"])
            if step > 0 and step % max(1, args.steps // 4) == 0:
                diag = generation_diagnostics(trainer.model, ids[:1, :8])
                diags.append(diag)
                out(f"[diagnostics] {json.dumps(diag)}")
    finally:
        state["stop"].set()
        mon.join()
    ckpt.save(args.steps, trainer, state["loss"])
    out(f"final: loss={state['loss']:.4f} "
        f"bank={trainer.hippocampus.memory_count}")
    return ProductionResult(out, losses, diags, retries, trainer)


def main(argv: Optional[Sequence[str]] = None) -> ProductionResult:
    """Train with the monitor and print the script's lines."""
    return run(argv)


if __name__ == "__main__":
    main()
