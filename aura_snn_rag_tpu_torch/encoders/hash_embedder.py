"""Deterministic n-gram hash embedder (a copy of
`aura_snn_rag_tpu/encoders/hash_embedder.py`, host numpy code; the port
keeps its own).

Byte n-grams (sizes 2..5) hashed with FNV-1a into a fixed-dim embedding,
each adding +-1 at slot h % dim (the sign from bit 32 of h), then
L2-normalised; `token_indices` hashes whitespace tokens for the STDP
learner. Text never touches the device. Two implementations with the
same outputs:
- native C++ (`native/hash_embedder.cpp` through ctypes, built by the
  port's `_native.py`), the ingestion hot path;
- vectorised numpy, when the library is missing or `use_native=False`.
`FastHashEmbedder.native` says which one an embedder runs. The library
is built and loaded at the first construction, not at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np

_FNV_OFFSET = np.uint64(1469598103934665603)
_FNV_PRIME = np.uint64(1099511628211)

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)
_i64p = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def _load_native() -> Optional[ctypes.CDLL]:
    from aura_snn_rag_tpu_torch._native import load
    lib = load()
    if lib is None:
        return None
    try:
        fns = (
            (lib.aura_hash_embed, [_u8p, ctypes.c_int, _f32p, ctypes.c_int,
                                   _i32p, ctypes.c_int], None),
            (lib.aura_hash_embed_batch, [_u8p, _i64p, ctypes.c_int, _f32p,
                                         ctypes.c_int, _i32p, ctypes.c_int],
             None),
            (lib.aura_token_indices, [_u8p, ctypes.c_int, _i64p,
                                      ctypes.c_int, ctypes.c_int64],
             ctypes.c_int),
        )
    except AttributeError:                  # a library without the symbols
        return None
    for fn, argtypes, restype in fns:
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _fnv1a_rows(mat: np.ndarray) -> np.ndarray:
    """Vectorised FNV-1a over the rows of a [N, L] uint8 matrix -> [N] uint64."""
    h = np.full(mat.shape[0], _FNV_OFFSET, np.uint64)
    with np.errstate(over="ignore"):
        for j in range(mat.shape[1]):
            h = (h ^ mat[:, j].astype(np.uint64)) * _FNV_PRIME
    return h


def _bytes_ptr(data: np.ndarray):
    """A pointer to `data` (uint8, contiguous), or to a 1-byte buffer
    when it is empty (the C side reads nothing then)."""
    return (data.ctypes.data_as(_u8p) if len(data)
            else (ctypes.c_uint8 * 1)())


class FastHashEmbedder:
    """n-gram hash embeddings: deterministic, vocabulary-free."""

    def __init__(self, dim: int = 768, ngram_sizes: Sequence[int] = (2, 3, 4, 5),
                 token_vocab: int = 32000, use_native: bool = True):
        self.dim = dim
        self.ngram_sizes = tuple(ngram_sizes)
        self.token_vocab = token_vocab
        self._native = _load_native() if use_native else None
        if self._native is not None:
            self._ng = (ctypes.c_int * len(self.ngram_sizes))(
                *self.ngram_sizes)

    @property
    def native(self) -> bool:
        """True when this embedder runs the native C++ path."""
        return self._native is not None

    def _ngrams(self, data: np.ndarray, n: int) -> np.ndarray:
        if len(data) < n:
            return np.zeros((0, n), np.uint8)
        idx = np.arange(len(data) - n + 1)[:, None] + np.arange(n)[None, :]
        return data[idx]

    def embed(self, text: str) -> np.ndarray:
        """text -> L2-normalised [dim] float32 embedding."""
        data = np.frombuffer(text.encode("utf-8", "ignore"), np.uint8)
        if self._native is not None:
            out = np.zeros(self.dim, np.float32)
            self._native.aura_hash_embed(
                _bytes_ptr(data), len(data), out.ctypes.data_as(_f32p),
                self.dim, self._ng, len(self.ngram_sizes))
            return out
        vec = np.zeros(self.dim, np.float32)
        for n in self.ngram_sizes:
            grams = self._ngrams(data, n)
            if len(grams) == 0:
                continue
            h = _fnv1a_rows(grams)
            slots = (h % np.uint64(self.dim)).astype(np.int64)
            signs = np.where((h >> np.uint64(32)) & np.uint64(1), 1.0, -1.0)
            np.add.at(vec, slots, signs.astype(np.float32))
        norm = float(np.linalg.norm(vec))
        return vec / norm if norm > 0 else vec

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """[N] texts -> [N, dim] float32 embeddings."""
        if self._native is not None and texts:
            blobs = [t.encode("utf-8", "ignore") for t in texts]
            concat = np.frombuffer(b"".join(blobs), np.uint8).copy()
            offsets = np.zeros(len(blobs) + 1, np.int64)
            np.cumsum([len(b) for b in blobs], out=offsets[1:])
            out = np.zeros((len(blobs), self.dim), np.float32)
            self._native.aura_hash_embed_batch(
                _bytes_ptr(concat), offsets.ctypes.data_as(_i64p),
                len(blobs), out.ctypes.data_as(_f32p), self.dim, self._ng,
                len(self.ngram_sizes))
            return out
        return np.stack([self.embed(t) for t in texts])

    def token_indices(self, text: str, max_tokens: int = 4096) -> np.ndarray:
        """Hashed token ids (whitespace tokens -> FNV-1a % vocab) for STDP."""
        if self._native is not None:
            data = np.frombuffer(text.encode("utf-8", "ignore"), np.uint8)
            out = np.zeros(max_tokens, np.int64)
            n = self._native.aura_token_indices(
                _bytes_ptr(data), len(data), out.ctypes.data_as(_i64p),
                max_tokens, self.token_vocab)
            return out[:n]
        toks = text.split()
        if not toks:
            return np.zeros((0,), np.int64)
        ids = []
        for t in toks:
            b = np.frombuffer(t.encode("utf-8", "ignore"), np.uint8)
            h = _fnv1a_rows(b[None, :]) if len(b) else np.zeros(1, np.uint64)
            ids.append(int(h[0] % np.uint64(self.token_vocab)))
        return np.asarray(ids, np.int64)
