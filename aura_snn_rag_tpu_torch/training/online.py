"""Online / local learning: Oja Hebbian layer with neurogenesis, STDP token
salience, running whitener, NLMS experts (counterpart of
`aura_snn_rag_tpu/training/online.py`).

- `OjaState` / `oja_step`: y = x W (inactive components masked);
  residual r = x - y W^T; dW = eta r^T y / B; active columns renormalised;
  when the residual's EMA passes `threshold`, the normalised mean
  residual becomes a new component (a static `max_components` buffer and
  an active count K).
- `STDPState` / `stdp_process_sequence`: dense [V] token weights;
  eligibility traces trace_t = exp(-1/tau) trace_{t-1} + spike_t
  (`ops.neurons.leaky_integrate`), lr+ * trace * spike added per token
  id, then a global decay and clamp; `stdp_modulations` = 1 + alpha w.
- `WhitenerState`: running mean / variance with momentum,
  (x - mu) / sqrt(var + 1e-8).
- `NLMSExpert`: w += mu err x / (|x|^2 + eps), mu decays (host numpy).

The states are named tuples of tensors on one device; each step returns
a new state, as the JAX package's jitted functions do, and none syncs
with the host. The `init_*` functions run on CUDA unless given
device="cpu"; `init_oja` draws its weights from a `torch.Generator`, so
they differ from the JAX package's for the same seed (tests hand both
the same state).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.ops.neurons import leaky_integrate

Device = Union[str, torch.device, None]


# ---------------------------------------------------------------------------
# Oja Hebbian layer with neurogenesis
# ---------------------------------------------------------------------------

class OjaState(NamedTuple):
    W: torch.Tensor             # [input_dim, max_components]
    K: torch.Tensor             # i32 active components
    residual_ema: torch.Tensor  # f32
    update_count: torch.Tensor  # i32


def init_oja(generator: Optional[torch.Generator], input_dim: int,
             n_components: int, max_components: int = 2048,
             device: Device = "cuda") -> OjaState:
    """N(0, 0.02^2) weights on `device`, drawn from `generator` (on the
    same device), the first `n_components` columns unit-norm."""
    dev = resolve_device(device)
    W = torch.randn(input_dim, max_components, generator=generator,
                    device=dev) * 0.02
    norm = torch.linalg.vector_norm(W, dim=0, keepdim=True) + 1e-12
    active = torch.arange(max_components, device=dev) < n_components
    W = torch.where(active, W / norm, W)
    return OjaState(W=W,
                    K=torch.tensor(n_components, dtype=torch.int32,
                                   device=dev),
                    residual_ema=torch.zeros((), device=dev),
                    update_count=torch.zeros((), dtype=torch.int32,
                                             device=dev))


def _active(state: OjaState, dtype: torch.dtype) -> torch.Tensor:
    return (torch.arange(state.W.shape[1], device=state.W.device)
            < state.K).to(dtype)


def oja_forward(state: OjaState, x: torch.Tensor) -> torch.Tensor:
    """Projection y = x @ W (inactive components masked to 0)."""
    return (x @ state.W) * _active(state, x.dtype)


def oja_step(state: OjaState, x: torch.Tensor, eta: float = 0.01,
             alpha: float = 0.99, threshold: float = 2.0
             ) -> Tuple[OjaState, torch.Tensor]:
    """One Hebbian step on [B, input_dim] (or [input_dim]) whitened input;
    returns (new state, y [B, max_components])."""
    if x.ndim == 1:
        x = x[None, :]
    B = x.shape[0]
    Mc = state.W.shape[1]
    mask = _active(state, x.dtype)

    y = (x @ state.W) * mask                           # [B, Mc]
    residual = x - y @ state.W.T                       # [B, D]
    norm_res = torch.linalg.vector_norm(residual, dim=1).mean()
    ema = torch.where(state.update_count == 0, norm_res,
                      alpha * state.residual_ema + (1 - alpha) * norm_res)

    W = state.W + eta * (residual.T @ y) / B * mask[None, :]
    col_norm = torch.linalg.vector_norm(W, dim=0, keepdim=True) + 1e-12
    W = torch.where(mask[None, :] > 0, W / col_norm, W)

    # neurogenesis: the normalised mean residual becomes column K
    grow = (ema > threshold) & (state.K < Mc)
    new_w = residual.mean(dim=0)
    new_w = new_w / (torch.linalg.vector_norm(new_w) + 1e-12)
    col = torch.clamp(state.K, max=Mc - 1).long().view(1)
    W = torch.where(grow, W.index_copy(1, col, new_w[:, None]), W)
    K = torch.where(grow, state.K + 1, state.K)
    ema = torch.where(grow, ema * 0.5, ema)
    return OjaState(W, K, ema, state.update_count + 1), y


# ---------------------------------------------------------------------------
# STDP token-salience learner (dense vocab buffer)
# ---------------------------------------------------------------------------

class STDPState(NamedTuple):
    token_weights: torch.Tensor  # [V] f32


def init_stdp(vocab_size: int, init: float = 0.5,
              device: Device = "cuda") -> STDPState:
    return STDPState(torch.full((vocab_size,), init,
                                device=resolve_device(device)))


def stdp_process_sequence(state: STDPState, token_ids: torch.Tensor,
                          lr_plus: float = 0.01, time_window: int = 5,
                          decay: float = 0.99, w_min: float = 0.0,
                          w_max: float = 1.0,
                          spikes: Optional[torch.Tensor] = None
                          ) -> Tuple[STDPState, dict]:
    """token_ids [B, T] (or [T]) -> updated state + stats (0-dim tensors).

    Eligibility traces by `leaky_integrate` along T; lr+ * trace * spike
    added to each token id's weight (repeats accumulate); global decay,
    then the clamp to [w_min, w_max]."""
    w = state.token_weights
    token_ids = torch.as_tensor(token_ids, device=w.device)
    if token_ids.ndim == 1:
        token_ids = token_ids[None, :]
    if spikes is None:
        spikes = torch.ones(token_ids.shape, device=w.device)
    traces = leaky_integrate(math.exp(-1.0 / time_window), spikes, axis=-1)
    updates = lr_plus * traces * spikes
    w = w.index_add(0, token_ids.reshape(-1).long(),
                    updates.reshape(-1).to(w.dtype))
    w = torch.clamp(w * decay, w_min, w_max)
    stats = {
        "mean_weight": w.mean(),
        "max_weight": w.max(),
        "active_count": (w > 0.01).sum(),
    }
    return STDPState(w), stats


def stdp_modulations(state: STDPState, token_ids: torch.Tensor,
                     alpha: float = 0.2) -> torch.Tensor:
    """Per-token modulation factors 1 + alpha * w (lookup)."""
    return 1.0 + alpha * state.token_weights[token_ids]


# ---------------------------------------------------------------------------
# Running whitener
# ---------------------------------------------------------------------------

class WhitenerState(NamedTuple):
    mean: torch.Tensor   # [D]
    var: torch.Tensor    # [D]
    count: torch.Tensor  # i32 updates taken


def init_whitener(dim: int, device: Device = "cuda") -> WhitenerState:
    dev = resolve_device(device)
    return WhitenerState(torch.zeros(dim, device=dev),
                         torch.ones(dim, device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev))


def whiten_update(state: WhitenerState, x: torch.Tensor,
                  momentum: float = 0.01
                  ) -> Tuple[WhitenerState, torch.Tensor]:
    """Update the running stats with a [B, D] batch; return the new state
    and the batch whitened by it. The first batch sets the stats (its
    variance only when B > 1: one sample keeps the unit prior)."""
    if x.ndim == 1:
        x = x[None, :]
    bm = x.mean(dim=0)
    bv = x.var(dim=0, correction=0)
    first = state.count == 0
    mean = torch.where(first, bm,
                       (1 - momentum) * state.mean + momentum * bm)
    running = (1 - momentum) * state.var + momentum * bv
    if x.shape[0] > 1:
        var = torch.where(first, bv, running)
    else:
        var = torch.where(first, state.var, running)
    out = (x - mean) / torch.sqrt(var + 1e-8)
    return WhitenerState(mean, var, state.count + 1), out


def whiten(state: WhitenerState, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean) / torch.sqrt(state.var + 1e-8)


# ---------------------------------------------------------------------------
# NLMS expert (normalised least mean squares; host numpy)
# ---------------------------------------------------------------------------

class NLMSExpert:
    """Online NLMS regressor: w += mu * err * x / (|x|^2 + eps)."""

    def __init__(self, in_dim: int, lr: float = 0.5,
                 lr_decay: float = 0.9999, eps: float = 1e-6):
        self.w = np.zeros(in_dim, np.float32)
        self.mu = lr
        self.lr_decay = lr_decay
        self.eps = eps
        self._sq_err = 0.0
        self._n = 0

    def predict(self, x: np.ndarray) -> float:
        return float(np.dot(self.w, x))

    def update(self, x: np.ndarray, target: float) -> float:
        pred = self.predict(x)
        err = target - pred
        self.w += self.mu * err * x / (np.dot(x, x) + self.eps)
        self.mu *= self.lr_decay
        self._sq_err += err * err
        self._n += 1
        return err

    @property
    def rmse(self) -> float:
        return math.sqrt(self._sq_err / max(1, self._n))
