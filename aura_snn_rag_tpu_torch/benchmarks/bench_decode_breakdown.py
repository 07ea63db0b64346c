"""The decode's cost per token on the port, by part (counterpart of
`benchmarks/bench_decode_breakdown.py`). Variants:

  full            `generate` as `bench_decode` runs it (temperature 0.8,
                  top-k 50, top-p 0.9, repetition penalty 1.2)
  greedy          top-k 1, top-p 1, no penalty: argmax sampling
  forward_only    the decode loop with a constant-like next token
                  (`logits[:, 0, 0]` as an int, mod 100, plus 1) and no
                  sampler: the model's own cost per token
  bf16_full       full, with a bf16 copy of the weights
  blockwise_topk  full, with the block-max top-k (`topk_impl="blockwise"`)
  bf16_blockwise  both

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_decode_breakdown
        [--preset test] [--new-tokens 64] [--prompt-len 32] [--batch 1]
        [--reps 5] [--device cuda]

The preset's `HippocampalTransformer` at dropout 0 with no bank, its
weights from a generator seeded 0, on a `RandomState(0)` prompt. Each
variant runs once to warm up and `--reps` times back to back, timed to
the card's finish. The samplers draw from a `torch.Generator` seeded 1
(the JAX script's `PRNGKey(1)`; torch draws other tokens).
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.benchmarks import _lm
from aura_snn_rag_tpu_torch.generation import generate

FULL = dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.2)
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0)


@torch.no_grad()
def forward_only(model, ids: torch.Tensor, new_tokens: int) -> torch.Tensor:
    """The prefill, then new_tokens - 1 single-token steps whose next
    token is `logits[:, 0, 0]` truncated to an int, mod 100, plus 1 (no
    sampler); returns the last token [B]."""
    B, L0 = ids.shape
    dev = ids.device
    caches = model.init_kv_caches(B, model.config.max_seq_len)
    _, caches = model(ids, positions=torch.arange(L0, device=dev).expand(
        B, L0), kv_caches=caches, cache_index=0)
    tok = ids[:, -1]
    for pos in range(L0, L0 + new_tokens - 1):
        out, caches = model(tok[:, None],
                            positions=torch.full((B, 1), pos, device=dev),
                            kv_caches=caches, cache_index=pos)
        tok = out.logits[:, 0, 0].to(torch.int32).long() % 100 + 1
    return tok


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_decode_breakdown",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="test")
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap


class BreakdownResult(NamedTuple):
    line: dict                          # the JSON line
    outputs: Dict[str, torch.Tensor]    # variant -> its last output
    vocab_size: int


def run(argv: Optional[Sequence[str]] = None) -> BreakdownResult:
    """The breakdown at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = _lm.model_config(args.preset)
    model = _lm.make_model(cfg, dev)
    B, T = args.batch, args.new_tokens
    ids = torch.from_numpy(_lm.prompts(B, args.prompt_len,
                                       cfg.vocab_size)).to(dev)
    outputs = {}

    def timed(name, fn):
        fn()                                              # warm-up
        out, dt = _lm.fenced(
            dev, lambda: [fn() for _ in range(args.reps)][-1])
        dt /= args.reps
        outputs[name] = out
        return dt * 1e3 / T

    def sampled(m, impl="sort", **kw):
        return lambda: generate(m, ids, T, _lm.generator(dev, 1),
                                topk_impl=impl, **kw)

    bf16_model = copy.deepcopy(model).to(torch.bfloat16)
    r_full = timed("full", sampled(model, **FULL))
    r_greedy = timed("greedy", sampled(model, **GREEDY))
    r_fwd = timed("forward_only", lambda: forward_only(model, ids, T))
    r_bf16 = timed("bf16_full", sampled(bf16_model, **FULL))
    r_blk = timed("blockwise_topk", sampled(model, "blockwise", **FULL))
    r_best = timed("bf16_blockwise", sampled(bf16_model, "blockwise", **FULL))
    line = {
        "preset": args.preset, "batch": B, "new_tokens": T,
        "ms_per_token": {"full": r_full, "greedy": r_greedy,
                         "forward_only": r_fwd, "bf16_full": r_bf16,
                         "blockwise_topk": r_blk,
                         "bf16_blockwise": r_best},
        "sampler_share_ms": round(r_full - r_fwd, 4),
        "f32_weight_read_share_ms": round(r_full - r_bf16, 4),
    }
    return BreakdownResult(line, outputs, cfg.vocab_size)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the breakdown and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
