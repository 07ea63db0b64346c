"""KV-cached decode throughput on the port at B = 1 / 8 / 32
(counterpart of `benchmarks/bench_decode.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_decode
        [--preset test] [--new-tokens 64] [--prompt-len 32]
        [--batches 1,8,32] [--reps 3] [--device cuda]

The preset's `HippocampalTransformer` at dropout 0 with no bank, its
weights from a generator seeded 0. For each batch, prompts of
`RandomState(0)` ids go through `generate` (temperature 0.8, top-k 50,
top-p 0.9, repetition penalty 1.2) once to warm up and `--reps` times
timed to the card's finish; the line keeps the fastest. The sampler
draws from a `torch.Generator` seeded with the rep, where the JAX script
passes `PRNGKey(rep)`: torch draws other tokens from the same filtered
distribution.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.benchmarks import _lm
from aura_snn_rag_tpu_torch.generation import generate


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_decode",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="test")
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap


class DecodeResult(NamedTuple):
    line: dict                          # the JSON line
    tokens: Dict[int, torch.Tensor]     # B -> the last call's output ids
    vocab_size: int


def run(argv: Optional[Sequence[str]] = None) -> DecodeResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = _lm.model_config(args.preset)
    model = _lm.make_model(cfg, dev)
    results, tokens = {}, {}
    for B in [int(b) for b in args.batches.split(",")]:
        ids = torch.from_numpy(_lm.prompts(B, args.prompt_len,
                                           cfg.vocab_size)).to(dev)

        def fn(seed):
            return generate(model, ids, args.new_tokens,
                            _lm.generator(dev, seed), temperature=0.8)

        _lm.fenced(dev, lambda: fn(1))                  # warm-up
        times = []
        for rep in range(args.reps):
            out, dt = _lm.fenced(dev, lambda: fn(rep))
            times.append(dt)
        dt = min(times)
        tok_s = B * args.new_tokens / dt
        results[f"B{B}"] = {"tokens_per_s": round(tok_s, 1),
                            "latency_s": round(dt, 4),
                            "per_token_ms": round(1000 * dt
                                                  / args.new_tokens, 3)}
        tokens[B] = out
    line = {"metric": "KV-cached decode throughput", "preset": args.preset,
            "new_tokens": args.new_tokens, **results}
    return DecodeResult(line, tokens, cfg.vocab_size)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
