"""What the LM benchmarks share: the preset's model at dropout 0, its
weights, the prompts and a fenced timer."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from aura_snn_rag_tpu_torch import config as cfg_mod
from aura_snn_rag_tpu_torch.bench import _sync
from aura_snn_rag_tpu_torch.models import HippocampalTransformer


def model_config(preset: str):
    """The preset's ModelConfig (`get_<preset>_config().model`) at dropout
    0, as the JAX scripts build it."""
    cfg = getattr(cfg_mod, f"get_{preset}_config")().model
    return dataclasses.replace(cfg, dropout=0.0)


def make_model(cfg, dev: torch.device) -> HippocampalTransformer:
    """The LM without a bank (the JAX scripts' `HippocampalTransformer(
    cfg)`), its weights drawn from a generator seeded 0, in eval mode."""
    model = HippocampalTransformer(
        cfg, None, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    return model.eval()


def prompts(batch: int, length: int, vocab: int,
            rng: np.random.RandomState = None) -> np.ndarray:
    """[batch, length] token ids in [1, vocab) from `rng` (default
    `RandomState(0)`), as the JAX scripts draw their prompts."""
    rng = np.random.RandomState(0) if rng is None else rng
    return rng.randint(1, vocab, (batch, length))


def generator(dev: torch.device, seed: int) -> torch.Generator:
    """The sampler's random stream for one call (the JAX scripts'
    `PRNGKey(seed)`; torch draws other bits)."""
    return torch.Generator(device=dev).manual_seed(seed)


def fenced(dev: torch.device, fn):
    """(fn(), seconds to the card's finish)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0
