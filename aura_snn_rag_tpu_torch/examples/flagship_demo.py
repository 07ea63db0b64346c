"""RAG-conditioned generation on a trained flagship checkpoint
(counterpart of `examples/flagship_demo.py`).

    python -m aura_snn_rag_tpu_torch.examples.flagship_demo
        [--checkpoint-dir DIR] [--corpus DIR] [--preset full]
        [--max-new-tokens 48] [--device cuda]

Restores the newest checkpoint of `train_flagship` into the preset at
the corpus's vocabulary (dropout 0, the thalamus gate off, as the
training run), memorises a support passage in one shot (its pooled
summary written to the bank), then generates `--max-new-tokens` tokens
at temperature 0.7 after the prompt with episodic memory, and again
without. With memory, every RAG layer retrieves at every model call:
through kernel B (`ivf_retrieve_fused`) once the bank's index is built.

`demo` is the device half (token ids in, token ids out); `main` reads
the corpus's `tokenizer.json` with the `tokenizers` package, encodes the
passage and the prompt, decodes and prints. The sampler draws from a
`torch.Generator` seeded 0 (the script's `PRNGKey(0)` draws other bits).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch import config as cfg_mod
from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.generation import generate
from aura_snn_rag_tpu_torch.services.one_shot import (
    one_shot_memorize_and_generate)
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
from aura_snn_rag_tpu_torch.training.trainer import Trainer

SUPPORT = ("def fibonacci(n):\n"
           "    \"\"\"Return the n-th Fibonacci number iteratively.\"\"\"\n"
           "    a, b = 0, 1\n"
           "    for _ in range(n):\n"
           "        a, b = b, a + b\n"
           "    return a\n")
PROMPT = "def fibonacci(n):\n"
TEMPERATURE = 0.7


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.flagship_demo",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", default="/root/data/ckpt_flagship")
    ap.add_argument("--corpus", default="/root/data/corpus")
    ap.add_argument("--preset", default="full")
    ap.add_argument("--max-new-tokens", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    return ap


def restore(checkpoint_dir: str, corpus: str, preset: str = "full",
            device="cuda"):
    """(the trainer, the checkpoint's step): the preset at the corpus's
    vocabulary, dropout 0 and the thalamus gate off, restored from the
    newest checkpoint in `checkpoint_dir`."""
    with open(os.path.join(corpus, "meta.json")) as f:
        meta = json.load(f)
    cfg = getattr(cfg_mod, f"get_{preset}_config")()
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, vocab_size=meta["vocab_size"], dropout=0.0),
        # must match the training run's modulator flags (train_flagship
        # sets the thalamus off)
        training=dataclasses.replace(cfg.training, enable_thalamus=False))
    trainer = Trainer(cfg, seed=0, device=resolve_device(device))
    step = CheckpointManager(checkpoint_dir).restore(trainer)
    return trainer, step


class DemoResult(NamedTuple):
    memory_id: str
    with_memory: np.ndarray       # prompt + new tokens, memory on
    without_memory: np.ndarray    # prompt + new tokens, memory off


def demo(trainer: Trainer, support_ids, prompt_ids, max_new_tokens: int,
         generator: torch.Generator) -> DemoResult:
    """The device half: memorise `support_ids` in the trainer's bank, then
    generate `max_new_tokens` after `prompt_ids` at temperature 0.7 with
    memory and without (one `generator` for both, in that order)."""
    model = trainer.model
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int64))
    mid, out_mem = one_shot_memorize_and_generate(
        model, trainer.hippocampus, np.asarray(support_ids, np.int64),
        prompt, max_new_tokens=max_new_tokens, generator=generator,
        temperature=TEMPERATURE)
    out_plain = generate(model, prompt[None, :], max_new_tokens, generator,
                         use_memory=False, temperature=TEMPERATURE)
    return DemoResult(mid, out_mem[0].cpu().numpy(),
                      out_plain[0].cpu().numpy())


class DemoRun(NamedTuple):
    lines: List[str]
    line: dict                    # the JSON line
    result: DemoResult


def run(argv: Optional[Sequence[str]] = None) -> DemoRun:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    from tokenizers import Tokenizer

    out = Lines()
    tok = Tokenizer.from_file(os.path.join(args.corpus, "tokenizer.json"))
    trainer, step = restore(args.checkpoint_dir, args.corpus, args.preset,
                            dev)
    out(f"restored step {step}, "
        f"{trainer.hippocampus.memory_count} memories")

    res = demo(trainer, tok.encode(SUPPORT).ids, tok.encode(PROMPT).ids,
               args.max_new_tokens, torch.Generator(device=dev).manual_seed(0))
    txt_mem = tok.decode([int(t) for t in res.with_memory])
    txt_plain = tok.decode([int(t) for t in res.without_memory])

    out(f"\nmemory id: {res.memory_id}")
    out(f"\n--- with episodic memory ---\n{txt_mem}")
    out(f"\n--- without memory ---\n{txt_plain}")
    line = {"demo": "one_shot_memorize_and_generate",
            "checkpoint_step": step,
            "with_memory_chars": len(txt_mem),
            "without_memory_chars": len(txt_plain)}
    out(json.dumps(line))
    return DemoRun(out, line, res)


def main(argv: Optional[Sequence[str]] = None) -> DemoRun:
    """Restore, demo and print the script's lines."""
    return run(argv)


if __name__ == "__main__":
    main()
