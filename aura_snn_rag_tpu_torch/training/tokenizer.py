"""Tokenizer utilities (a copy of `aura_snn_rag_tpu/training/tokenizer.py`,
which imports no JAX; the port keeps its own so it imports nothing of the
JAX package).

`load_tokenizer` loads a HuggingFace tokenizer when `transformers` can
(a cached model); without it, or offline, it falls back to the
vocabulary-free `ByteTokenizer` with the same API, so every pipeline
still runs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ByteTokenizer:
    """Vocabulary-free byte tokenizer (offline fallback). ids = byte + 3;
    0=pad, 1=bos, 2=eos."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    vocab_size = 259

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8", "ignore")]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        data = bytes(int(i) - 3 for i in ids
                     if int(i) >= 3 and int(i) < 259)
        return data.decode("utf-8", "ignore")

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}


def load_tokenizer(name: str = "google/flan-t5-base"):
    """HF tokenizer if loadable (cached/downloadable), else ByteTokenizer."""
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(name)
    except Exception:  # noqa: BLE001 — offline/missing: degrade gracefully
        return ByteTokenizer()


def tokenize_file(path: str, tokenizer=None, seq_len: int = 256,
                  max_sequences: Optional[int] = None) -> np.ndarray:
    """Plain-text file → [n, seq_len] int32 token matrix (packed)."""
    tok = tokenizer or ByteTokenizer()
    with open(path, encoding="utf-8", errors="ignore") as f:
        text = f.read()
    ids = tok.encode(text)
    n = len(ids) // seq_len
    if max_sequences is not None:
        n = min(n, max_sequences)
    return np.asarray(ids[:n * seq_len], np.int32).reshape(n, seq_len)
