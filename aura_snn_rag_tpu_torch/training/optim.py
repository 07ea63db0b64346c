"""The trainer's optimizer: optax's
`chain(clip_by_global_norm(clip), adamw(schedule, weight_decay, mu_dtype))`
as the JAX package's `Trainer` builds it, over one flat f32 buffer.

`ClippedAdamW` moves the model's parameters into one flat buffer and
makes each `Parameter` a view of it, and its gradients views of one flat
gradient buffer, so autograd accumulates micro-batches in place and the
whole update is a few elementwise ops over the buffer. The model must not
be moved or cast afterwards (`.to()`, `.half()`): that would replace the
views.

An update follows optax's order of operations in f32:
- clip: g <- g if |g| < clip else g / |g| * clip (|g| the global norm);
- Adam: mu <- 0.1 g + 0.9 mu, nu <- 0.001 g^2 + 0.999 nu, each
  bias-corrected by 1 - b^(count + 1); u = mu_hat / (sqrt(nu_hat) + eps);
  `mu_dtype` bf16 stores the first moment in bf16 after the update;
- decoupled weight decay: u <- u + weight_decay * p;
- u <- -lr(count) * u * lr_scale (lr_scale multiplies the whole update,
  weight decay included), p <- p + u.
A non-finite loss leaves the parameters, both moments and the count as
they were, selected on the device with `torch.where`, so the step needs
no host sync.

Under tensor parallelism (`sharded`, `group`) a rank holds its part of
the sharded parameters and the whole of the replicated ones; the clip
takes the global norm, as optax does on JAX's global arrays: the sharded
parameters' sum of squares all-reduced over the 'model' axis, plus the
replicated ones' counted once.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn as nn

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adamw's defaults, as the JAX
                                    # package's trainer uses them


class AdamWState(NamedTuple):
    count: torch.Tensor   # [] int32 updates applied (optax's count)
    mu: torch.Tensor      # [N] first moment, mu_dtype
    nu: torch.Tensor      # [N] f32 second moment


class ClippedAdamW:
    """Global-norm clipping + AdamW over parameters held in one flat
    buffer (see the module doc). `params` are f32 `Parameter`s on one
    device; `schedule(count)` gives the learning rate; `mu_dtype`
    "bfloat16" keeps the first moment in bf16, anything else in f32 (as
    the JAX package's trainer reads `optimizer_mu_dtype`). `sharded`
    flags the parameters that hold a part of a tensor-parallel one, and
    `group` is the 'model' axis's process group their norm is summed
    over."""

    def __init__(self, params: Iterable[nn.Parameter],
                 schedule: Callable[[torch.Tensor], torch.Tensor],
                 weight_decay: float = 0.01, gradient_clip: float = 1.0,
                 mu_dtype: str = "float32",
                 sharded: Optional[Sequence[bool]] = None, group=None):
        self.params = list(params)
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("ClippedAdamW holds f32 parameters only")
        dev = self.params[0].device
        n = sum(p.numel() for p in self.params)
        self.flat = torch.empty(n, device=dev)
        self.grad = torch.zeros(n, device=dev)
        off = 0
        with torch.no_grad():
            for p in self.params:
                k = p.numel()
                self.flat[off:off + k].copy_(p.reshape(-1))
                p.data = self.flat[off:off + k].view_as(p)
                p.grad = self.grad[off:off + k].view_as(p)
                off += k
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.gradient_clip = gradient_clip
        self.group = group
        self.sharded = None
        if sharded is not None and any(sharded):
            self.sharded = torch.cat([
                torch.full((p.numel(),), bool(f), device=dev)
                for p, f in zip(self.params, sharded)])
        self.state = AdamWState(
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.bfloat16 if mu_dtype == "bfloat16"
                        else torch.float32, device=dev),
            torch.zeros(n, device=dev))

    def zero_grad(self) -> None:
        self.grad.zero_()

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a tensor laid out as `flat` over the whole model:
        the sharded parameters' parts summed over the 'model' axis (every
        rank of it calls this), the replicated ones counted once."""
        if self.sharded is None:
            return x.sum()
        part = torch.where(self.sharded, x, 0.0).sum()
        dist.all_reduce(part, group=self.group)
        return torch.where(self.sharded, 0.0, x).sum() + part

    @torch.no_grad()
    def step(self, loss: torch.Tensor,
             lr_scale: Union[float, torch.Tensor] = 1.0) -> None:
        """One update from the accumulated gradient; skipped on the device
        when `loss` is not finite."""
        p, g = self.flat, self.grad
        count, mu, nu = self.state
        # a sum of squares: PyTorch's f32 vector_norm on the CPU drifts
        # by ~5e-5 over 10^5-10^6 entries
        norm = torch.sqrt(self.global_sum(g * g))
        g = torch.where(norm < self.gradient_clip, g,
                        g / norm * self.gradient_clip)
        count_inc = count + 1
        c = count_inc.float()
        # b1 * mu in mu's dtype, the constant rounded to it first (JAX's
        # weak type: bf16(0.9) for a bf16 mu), then the sum in f32
        new_mu = (1 - B1) * g + torch.tensor(B1, dtype=mu.dtype) * mu
        new_nu = (1 - B2) * (g * g) + B2 * nu
        mu_hat = new_mu / (1 - torch.pow(B1, c))
        nu_hat = new_nu / (1 - torch.pow(B2, c))
        u = mu_hat / (torch.sqrt(nu_hat) + EPS)
        u = u + self.weight_decay * p
        u = -self.schedule(count).to(p.device) * u
        u = u * lr_scale
        finite = torch.isfinite(loss.detach())
        p.copy_(torch.where(finite, p + u, p))
        mu.copy_(torch.where(finite, new_mu.to(mu.dtype), mu))
        nu.copy_(torch.where(finite, new_nu, nu))
        count.copy_(torch.where(finite, count_inc, count))
