"""KV-cached decode against the full-prefix recompute on the port
(counterpart of `benchmarks/bench_generation.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_generation
        [--preset test] [--prompt-len 64] [--new-tokens 64] [--batch 8]
        [--device cuda]

The preset's `HippocampalTransformer` at dropout 0 with no bank, its
weights from a generator seeded 0, on `RandomState(0)` prompts:

- cached: one `generate` (top-k 50, top-p 0.9, repetition penalty 1.2)
  to warm up, then one timed to the card's finish;
- recompute, as a model without a KV cache decodes: each token runs the
  model over the last `--prompt-len` tokens and samples (top-k 50) from
  the last position, the window sliding by one; min(new tokens, 16)
  steps are timed after one warm-up step and scaled to the new tokens.

The sampler draws from `torch.Generator`s seeded as the JAX script's
`PRNGKey`s; torch draws other tokens.
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.benchmarks import _lm
from aura_snn_rag_tpu_torch.generation import generate, sample_token

RECOMPUTE_STEPS = 16          # timed recompute steps, at most


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_generation",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="test")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


class GenerationResult(NamedTuple):
    line: dict                    # the JSON line
    cached: torch.Tensor          # [B, prompt + new] the timed call's ids
    context: torch.Tensor         # [B, prompt] the recompute's last window
    vocab_size: int


def run(argv: Optional[Sequence[str]] = None) -> GenerationResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = _lm.model_config(args.preset)
    model = _lm.make_model(cfg, dev)
    ids = torch.from_numpy(_lm.prompts(
        args.batch, args.prompt_len, cfg.vocab_size,
        np.random.RandomState(0))).to(dev)

    def gen(seed):
        return generate(model, ids, args.new_tokens, _lm.generator(dev, seed),
                        top_k=50)

    _lm.fenced(dev, lambda: gen(1))                     # warm-up
    cached, cached_s = _lm.fenced(dev, lambda: gen(2))
    cached_tps = args.batch * args.new_tokens / cached_s

    @torch.no_grad()
    def recompute_step(ctx, seed):
        o, _ = model(ctx, use_memory=True)
        return sample_token(_lm.generator(dev, seed), o.logits[:, -1],
                            top_k=50)

    ctx = ids
    _lm.fenced(dev, lambda: recompute_step(ctx, 3))     # warm-up
    window = args.prompt_len
    steps = min(args.new_tokens, RECOMPUTE_STEPS)

    def loop(ctx):
        for s in range(steps):
            tok = recompute_step(ctx[:, -window:], 4 + s)
            ctx = torch.cat([ctx[:, 1:], tok[:, None]], dim=1)
        return ctx

    ctx, elapsed = _lm.fenced(dev, lambda: loop(ctx))
    recompute_s = elapsed / steps * args.new_tokens
    recompute_tps = args.batch * args.new_tokens / recompute_s

    line = {
        "cached_tokens_per_s": round(cached_tps, 1),
        "recompute_tokens_per_s": round(recompute_tps, 1),
        "speedup": round(cached_tps / recompute_tps, 2),
        "batch": args.batch,
        "new_tokens": args.new_tokens,
    }
    return GenerationResult(line, cached, ctx, cfg.vocab_size)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
