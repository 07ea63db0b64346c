"""Dataset loading: pre-tokenized files, HF streaming (gated), synthetic
(a copy of `aura_snn_rag_tpu/training/data.py`, which imports no JAX; the
port keeps its own, on the port's `ModelConfig`).

Batches are numpy int32 arrays; `Trainer.train_step` moves them to its
device. `load_hf_streaming` needs `datasets` and `transformers` and a
network, so no test runs it.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from aura_snn_rag_tpu_torch.config import ModelConfig


def synthesize_sequences(model_cfg: ModelConfig, n_sequences: int = 512,
                         seed: int = 0) -> np.ndarray:
    """Markov-ish synthetic token sequences (learnable structure)."""
    rng = np.random.RandomState(seed)
    V = model_cfg.vocab_size
    L = model_cfg.max_seq_len
    # sparse bigram transition structure so a model can reduce loss
    n_states = min(64, V)
    trans = rng.randint(0, V, (n_states, 8))
    seqs = np.zeros((n_sequences, L), np.int32)
    for i in range(n_sequences):
        tok = rng.randint(0, V)
        for t in range(L):
            seqs[i, t] = tok
            tok = int(trans[tok % n_states, rng.randint(0, 8)])
    return seqs


def load_token_file(path: str) -> np.ndarray:
    """Load [n_seq, seq_len] int tokens from .npy/.npz."""
    if path.endswith(".npz"):
        data = np.load(path)
        key = "sequences" if "sequences" in data else list(data.keys())[0]
        return np.asarray(data[key], np.int32)
    return np.asarray(np.load(path), np.int32)


def load_or_synthesize(path: Optional[str], model_cfg: ModelConfig,
                       seed: int = 0) -> np.ndarray:
    if path and os.path.exists(path):
        seqs = load_token_file(path)
        assert seqs.ndim == 2, f"expected [n, L] tokens, got {seqs.shape}"
        return np.clip(seqs, 0, model_cfg.vocab_size - 1)
    return synthesize_sequences(model_cfg, seed=seed)


def load_hf_streaming(dataset: str = "wikitext",
                      config: str = "wikitext-2-raw-v1",
                      tokenizer_name: str = "gpt2",
                      seq_len: int = 256, max_sequences: int = 2048):
    """Stream a HF dataset through a tokenizer → [n, L] tokens.

    Gated: requires `datasets` + `transformers`; raises ImportError with a
    clear message otherwise (neither is guaranteed in this image).
    """
    try:
        from datasets import load_dataset
        from transformers import AutoTokenizer
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "HF streaming needs `datasets` and `transformers`; use a "
            "pre-tokenized .npy file instead") from e
    tok = AutoTokenizer.from_pretrained(tokenizer_name)
    ds = load_dataset(dataset, config, split="train", streaming=True)
    buf, out = [], []
    for row in ds:
        text = row.get("text", "")
        if not text.strip():
            continue
        buf.extend(tok.encode(text))
        while len(buf) >= seq_len:
            out.append(buf[:seq_len])
            buf = buf[seq_len:]
            if len(out) >= max_sequences:
                return np.asarray(out, np.int32)
    return np.asarray(out, np.int32)


def batch_iterator(sequences: np.ndarray, batch_size: int,
                   seed: int = 0) -> Iterator[np.ndarray]:
    """Infinite shuffled batch iterator."""
    rng = np.random.RandomState(seed)
    n = len(sequences)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield sequences[order[i:i + batch_size]]


class TokenStream:
    """Memmapped uint16/uint32 token stream → [B, L] batches.

    The offline-corpus script (`tools/build_offline_corpus.py`) writes one
    flat token stream per split; batches are independent random windows
    (train) or a deterministic sequential tiling (eval). Mirrors the
    reference's pre-tokenized `.pt` consumption (colab_l4_training.py:
    446-485) with a memmap so a 100M+-token stream costs no RSS.
    """

    def __init__(self, path: str, seq_len: int, seed: int = 0):
        self.tokens = np.load(path, mmap_mode="r")
        self.seq_len = seq_len
        self.n_tokens = int(self.tokens.size)
        assert self.n_tokens > seq_len + 1, "stream too short"
        self._rng = np.random.RandomState(seed)

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """[B, seq_len] random windows (labels = next-token shift of ids)."""
        starts = self._rng.randint(
            0, self.n_tokens - self.seq_len - 1, batch_size)
        out = np.empty((batch_size, self.seq_len), np.int32)
        for i, s in enumerate(starts):
            out[i] = self.tokens[s:s + self.seq_len]
        return out

    def sample_chunk(self, n_steps: int, batch_size: int) -> np.ndarray:
        """[N, B, seq_len] chunk for Trainer.train_chunk."""
        flat = self.sample_batch(n_steps * batch_size)
        return flat.reshape(n_steps, batch_size, self.seq_len)

    def eval_batches(self, batch_size: int, max_batches: int = 16):
        """Deterministic sequential [B, seq_len] tiling from the start."""
        per = batch_size * self.seq_len
        n = min(max_batches, (self.n_tokens - 1) // per)
        for i in range(n):
            window = np.asarray(
                self.tokens[i * per:(i + 1) * per], np.int32)
            yield window.reshape(batch_size, self.seq_len)
