"""The benchmark's inputs, made on the run's device from the seed.

Rows follow `bench.py`'s recipe (`make_data`): `n_centers` centres of
scale `center_scale`, each row a centre plus unit noise. Queries are
stored rows plus `query_noise` noise. Both sides of a comparison get
these tensors (or draw them again from the same seed); neither gets
anything the program derived from them.
"""

from __future__ import annotations

import math

import torch


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def rows(device, seed: int, n: int, d: int, n_centers: int,
         center_scale: float) -> torch.Tensor:
    """[n, d] f32 clustered rows; the same seed gives the same rows."""
    gen = generator(device, seed)
    centers = torch.randn(n_centers, d, device=device, generator=gen) \
        * center_scale
    assign = torch.randint(0, n_centers, (n,), device=device, generator=gen)
    out = centers[assign]
    out += torch.randn(n, d, device=device, generator=gen)
    return out


def queries_near(feats: torch.Tensor, gen: torch.Generator, n: int,
                 noise: float) -> torch.Tensor:
    """[n, d] queries: random stored rows plus `noise` normal noise."""
    pick = torch.randint(0, feats.shape[0], (n,), device=feats.device,
                         generator=gen)
    return feats[pick] + noise * torch.randn(
        n, feats.shape[1], device=feats.device, generator=gen)


def balanced_sizes(lo: int, hi: int, n: int, gen: torch.Generator
                   ) -> list:
    """`n` request sizes in [lo, hi], each size equally often (n rounded
    up to a multiple of the range), in an order drawn from `gen`: every
    seed gets the same work in another order."""
    span = hi - lo + 1
    reps = -(-n // span)
    sizes = torch.arange(lo, hi + 1).repeat(reps)
    order = torch.randperm(sizes.numel(), generator=gen,
                           device=gen.device).cpu()
    return sizes[order].tolist()


def params(spec, device, seed: int) -> dict:
    """Weights by name from `spec` [(name, shape, init, scale)]: every
    "normal" tensor a slice of one f32 normal draw on the device, scaled;
    every "const" tensor filled. The same seed gives the same weights."""
    gen = generator(device, seed)
    n = sum(math.prod(shape) for _, shape, init, _ in spec
            if init == "normal")
    flat = torch.randn(n, device=device, generator=gen)
    out, at = {}, 0
    for name, shape, init, scale in spec:
        if init == "normal":
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape).mul_(scale)
            at += k
        else:
            out[name] = torch.full(shape, float(scale), device=device)
    return out

