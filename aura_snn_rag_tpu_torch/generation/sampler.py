"""Sampling transforms and the autoregressive decode loop (counterpart of
`aura_snn_rag_tpu/generation/sampler.py`).

Temperature, top-k, top-p (nucleus) and the sign-aware repetition penalty
(positive logits divided, negative multiplied) as in the JAX package.
Randomness comes from an explicit `torch.Generator` (the JAX package's
rng key); `torch` and `jax.random` do not share bits, so the same seed
samples other tokens, from the same filtered distribution.

The decode is a Python loop over steps with per-layer KV caches
allocated once (`model.init_kv_caches`), where the JAX package runs
`lax.scan`: O(L) per token, not O(L^2). The loop never waits for the
device; the position is a host integer.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30

Scalar = Union[float, torch.Tensor]


def apply_repetition_penalty(logits: torch.Tensor, token_counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Sign-aware repetition penalty over the vocab: token_counts [V] or
    [B, V]; a token is penalised iff its count > 0."""
    seen = token_counts > 0
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def exact_topk_blockwise(logits: torch.Tensor, k: int, block: int = 128):
    """Exact (values, indices) top-k through a block-max funnel: the top-k
    blocks by their maxima contain every top-k element. Values equal
    `torch.topk`'s; indices may differ only between equal values."""
    V = logits.shape[-1]
    nb = -(-V // block)
    pad = nb * block - V
    x = F.pad(logits, (0, pad), value=NEG_INF) if pad else logits
    lead = logits.shape[:-1]
    bmax = x.reshape(*lead, nb, block).amax(dim=-1)              # [..., nb]
    kb = min(k, nb)
    top_blocks = torch.topk(bmax, kb, dim=-1).indices            # [..., kb]
    lane = torch.arange(block, device=logits.device)
    cand_idx = (top_blocks[..., None] * block + lane).reshape(*lead,
                                                              kb * block)
    cand = x.gather(-1, cand_idx)
    vals, pick = torch.topk(cand, k, dim=-1)
    return vals, cand_idx.gather(-1, pick)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _per_row(x: Scalar, like: torch.Tensor) -> Scalar:
    """A [B] tensor as f32 on `like`'s device, broadcastable over the
    vocab axis; a float stays a float (copying it to the card would wait
    for the stream)."""
    if isinstance(x, (int, float)):
        return float(x)
    t = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return t[..., None] if t.ndim else t


def top_p_filter(logits: torch.Tensor, p: Scalar) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix with cumulative prob >
    p (always the top-1). `p` is a float (p >= 1 keeps everything) or a
    [B] tensor, one value per request."""
    if isinstance(p, (int, float)) and p >= 1.0:
        return logits
    p = _per_row(p, logits)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) <= p
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, NEG_INF, logits)


def _categorical(generator: Optional[torch.Generator],
                 logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick, as
    `jax.random.categorical` does."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: Scalar = 1.0, top_k: int = 0,
                 top_p: Scalar = 1.0,
                 token_counts: Optional[torch.Tensor] = None,
                 repetition_penalty: float = 1.0,
                 topk_impl: str = "sort") -> torch.Tensor:
    """logits [..., V] -> sampled token ids [...].

    `temperature` and `top_p` are floats or [B] tensors (per-request values
    in serving). With top_k > 0 the filter chain runs in the top-k
    subspace (one `topk`, already sorted), which induces the same
    distribution as filtering the whole vocab."""
    logits = logits.float()
    if token_counts is not None and repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, token_counts,
                                          repetition_penalty)
    if isinstance(temperature, (int, float)):
        if temperature != 1.0:
            logits = logits / max(temperature, 1e-6)
    else:
        logits = logits / _per_row(temperature, logits).clamp_min(1e-6)

    if top_k > 0:
        if topk_impl == "blockwise":
            vals, idx = exact_topk_blockwise(logits, top_k)
        else:
            vals, idx = torch.topk(logits, top_k, dim=-1)       # descending
        if not (isinstance(top_p, (int, float)) and top_p >= 1.0):
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = (cum - probs) <= _per_row(top_p, vals)      # keeps top-1
            vals = torch.where(keep, vals, NEG_INF)
        choice = _categorical(generator, vals)
        return idx.gather(-1, choice[..., None])[..., 0]

    return _categorical(generator, top_p_filter(logits, top_p))


@torch.no_grad()
def generate(model, input_ids: torch.Tensor, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: Scalar = 1.0, top_k: int = 50,
             top_p: Scalar = 0.9, repetition_penalty: float = 1.2,
             memory_state=None, use_memory: bool = False,
             eos_token_id: Optional[int] = None,
             prosody: Optional[torch.Tensor] = None,
             topk_impl: str = "sort") -> torch.Tensor:
    """KV-cached autoregressive generation on the model's device.

    input_ids: [B, L_prompt] -> [B, L_prompt + max_new_tokens] int64
    (positions after EOS hold EOS when eos_token_id is set). The prefill
    makes token 1, then max_new_tokens - 1 steps of one token each: the
    model runs max_new_tokens times. Every row's cache index is the same
    (positions count left padding)."""
    B, L0 = input_ids.shape
    cfg = model.config
    if max_new_tokens < 1 or L0 + max_new_tokens > cfg.max_seq_len:
        raise ValueError(f"prompt {L0} + {max_new_tokens} new tokens: "
                         f"need 1 <= new and total <= max_seq_len "
                         f"{cfg.max_seq_len}")
    dev = model.device
    ids = input_ids.to(dev, torch.long)
    caches = model.init_kv_caches(B, cfg.max_seq_len)
    counts = torch.zeros((B, cfg.vocab_size), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    one = torch.ones((B, 1), dtype=torch.int32, device=dev)

    def sample(logits):
        return sample_token(generator, logits, temperature, top_k, top_p,
                            counts, repetition_penalty, topk_impl=topk_impl)

    out, caches = model(ids, prosody=prosody, use_memory=use_memory,
                        memory_state=memory_state,
                        positions=torch.arange(L0, device=dev).expand(B, L0),
                        kv_caches=caches, cache_index=0)
    tok = sample(out.logits[:, -1])
    done = tok == eos_token_id if eos_token_id is not None else None
    tokens = [tok]
    for pos in range(L0, L0 + max_new_tokens - 1):
        counts.scatter_add_(1, tok[:, None], one)
        out, caches = model(tok[:, None], use_memory=use_memory,
                            memory_state=memory_state,
                            positions=torch.full((B, 1), pos, device=dev),
                            kv_caches=caches, cache_index=pos)
        tok = sample(out.logits[:, 0])
        if eos_token_id is not None:
            tok = torch.where(done, eos_token_id, tok)
            done = done | (tok == eos_token_id)
        tokens.append(tok)
    return torch.cat([ids, torch.stack(tokens, dim=1)], dim=1)
