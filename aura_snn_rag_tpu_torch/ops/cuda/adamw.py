"""AdamW's update over the trainer's flat buffers, in two passes.

`training/optim.py` `ClippedAdamW.step` runs optax's
`chain(clip_by_global_norm(clip), adamw(...))` over one flat f32 buffer
of parameters `p`, its gradient `g` and the moments `mu`, `nu`. The JAX
package leaves that chain to XLA, which fuses it; no Pallas kernel is
replaced here.

- `adamw_sumsq`: the gradient's sum of squares, for the clip's global
  norm; with a `sharded` mask the two sums (the sharded entries', the
  replicated ones'), which the optimizer combines over the 'model' axis.
- `adamw_scalars`: the step's scalars on the device, from the 0-dim ops
  the plain step runs (no host sync).
- `adamw_update`: the clip, the moments, the bias corrections, the
  weight decay and the learning rate, into `p`, `mu` and `nu` in place,
  or nothing when the loss was not finite.

CUDA tensors launch `csrc/adamw.cu` (`adamw_sumsq`: a deterministic f64
sum in two launches; `adamw_update`: one read-once pass; bound and design
in its note); CPU tensors run `adamw_sumsq_plain` and
`adamw_update_plain`, the PyTorch chain the optimizer ran before, which
stays the oracle. The update matches its plain version bit for bit fed
the same scalars; the sum is f64 where the plain one is PyTorch's f32.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from aura_snn_rag_tpu_torch.ops.cuda import _build
from aura_snn_rag_tpu_torch.utils.trace import count

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adamw's defaults, as the JAX
                                    # package's trainer uses them
# the blocks' partial sums `adamw_sumsq` allocates room for (the library
# launches at most this many blocks)
SUMSQ_BLOCKS = 1024
FINITE = 5          # adamw_scalars()[FINITE]: 1.0 when the loss is finite

_F32 = torch.float32

_sumsq_launch = _build.Entry("adamw", "adamw_sumsq_launch", "pppp l i")
_update_launch = _build.Entry("adamw", "adamw_update_launch",
                              "ppppp l i fffffff")


def _f32(x: float) -> float:
    return float(np.float32(x))


def _check(name, *pairs):
    _build.check_inputs(name, *pairs)
    n = pairs[0][0].shape
    if any(t.shape != n for t, _ in pairs) or len(n) != 1:
        raise ValueError(f"{name}: expected flat buffers of one length, got "
                         f"{[tuple(t.shape) for t, _ in pairs]}")


def adamw_sumsq_plain(grad: torch.Tensor,
                      sharded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of grad * grad in PyTorch's f32: [1], or with `sharded`
    [2] (the entries where it is set, the others)."""
    x = grad * grad
    if sharded is None:
        return x.sum().reshape(1)
    return torch.stack([torch.where(sharded, x, 0.0).sum(),
                        torch.where(sharded, 0.0, x).sum()])


def adamw_sumsq(grad: torch.Tensor,
                sharded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of grad * grad, [1] f32 on grad's device; with `sharded`
    (bool, grad's length) [2]: the entries where it is set, the others.
    On the card accumulated in f64 in a fixed order (the same bits on
    every run)."""
    _check("adamw_sumsq", (grad, _F32),
           *(() if sharded is None else ((sharded, torch.bool),)))
    if not grad.is_cuda:
        return adamw_sumsq_plain(grad, sharded)
    dev = grad.device
    partial = torch.empty(2 * SUMSQ_BLOCKS, dtype=torch.float64, device=dev)
    out = torch.empty(1 if sharded is None else 2, dtype=_F32, device=dev)
    _sumsq_launch(grad, sharded, partial, out, grad.numel(), SUMSQ_BLOCKS)
    return out


def adamw_scalars(norm: torch.Tensor, step_count: torch.Tensor,
                  lr: torch.Tensor, loss: torch.Tensor,
                  lr_scale: Union[float, torch.Tensor]) -> torch.Tensor:
    """[norm, 1 - b1^c, 1 - b2^c, -lr, lr_scale, finite] f32 on norm's
    device (c = count + 1, finite 1.0 when `loss` is finite, else 0.0),
    each as the plain step computed it."""
    dev = norm.device
    c = (step_count + 1).float()
    if isinstance(lr_scale, torch.Tensor) and lr_scale.device == dev:
        scale = lr_scale.to(_F32).reshape(())
    else:           # a number, or a CPU tensor read on the host: no sync
        scale = torch.full((), float(lr_scale), dtype=_F32, device=dev)
    finite = torch.isfinite(loss.detach()).to(dev, _F32)
    return torch.stack([norm, 1 - torch.pow(B1, c), 1 - torch.pow(B2, c),
                        -lr, scale, finite])


def adamw_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, scalars: torch.Tensor, clip: float,
                       weight_decay: float) -> None:
    """The update in PyTorch, in optax's order of operations in f32 (see
    `training/optim.py`); selected on the device, so a non-finite loss
    leaves p, mu and nu as they were."""
    norm, d1, d2, neg_lr, scale, finite = scalars.unbind()
    g = torch.where(norm < clip, g, g / norm * clip)
    # b1 * mu in mu's dtype, the constant rounded to it first (JAX's
    # weak type: bf16(0.9) for a bf16 mu), then the sum in f32
    new_mu = (1 - B1) * g + torch.tensor(B1, dtype=mu.dtype) * mu
    new_nu = (1 - B2) * (g * g) + B2 * nu
    mu_hat = new_mu / d1
    nu_hat = new_nu / d2
    u = mu_hat / (torch.sqrt(nu_hat) + EPS)
    u = u + weight_decay * p
    u = neg_lr * u
    u = u * scale
    finite = finite > 0
    p.copy_(torch.where(finite, p + u, p))
    mu.copy_(torch.where(finite, new_mu.to(mu.dtype), mu))
    nu.copy_(torch.where(finite, new_nu, nu))


def adamw_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, scalars: torch.Tensor, clip: float,
                 weight_decay: float) -> None:
    """One AdamW update of the f32 `p` from the f32 gradient `g`, in
    place, with the first moment `mu` (f32 or bf16) and the second `nu`
    (f32), all one length; `scalars` from `adamw_scalars`. On the card one
    pass that reads each buffer once and writes p, mu and nu once, and
    counts `path.adamw_fused`."""
    bf16 = mu.dtype == torch.bfloat16
    _check("adamw_update", (p, _F32), (g, _F32),
           (mu, torch.bfloat16 if bf16 else _F32), (nu, _F32))
    _build.check_inputs("adamw_update", (scalars, _F32))
    if scalars.shape != (6,) or scalars.device != p.device:
        raise ValueError(f"adamw_update: scalars {tuple(scalars.shape)} on "
                         f"{scalars.device}, expected (6,) on {p.device}")
    if not p.is_cuda:
        adamw_update_plain(p, g, mu, nu, scalars, clip, weight_decay)
        return
    # each constant rounded as PyTorch rounds a Python number that
    # multiplies an f32 tensor (b1 to mu's dtype)
    b1 = float(torch.tensor(B1, dtype=mu.dtype))
    _update_launch(p, g, mu, nu, scalars, p.numel(), int(bf16),
                   _f32(clip), _f32(weight_decay), _f32(1 - B1), b1,
                   _f32(1 - B2), _f32(B2), _f32(EPS))
    count("path.adamw_fused")
