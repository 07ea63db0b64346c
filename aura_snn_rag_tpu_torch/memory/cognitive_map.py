"""Place, grid and time cell populations (the cognitive map).

Counterpart of `aura_snn_rag_tpu/memory/cognitive_map.py`:
- place cells: random centres and radii, Gaussian rate
  max_rate * exp(-d^2 / (2 sigma^2)) with sigma = radius / 3, masked to
  the receptive radius;
- grid cells: log-spaced spacings, random orientation and phase, three
  plane waves (cos u1 + cos u2 + cos u3) / 3 + 0.5, ReLU, 2-D space;
- time cells: log-spaced preferred intervals with Gaussian fields over
  logical elapsed time.

Functions of an explicit parameter tuple; they broadcast over batches of
locations. The random parameters come from a `torch.Generator`, so they
differ from the JAX package's for the same seed; tests hand both packages
the same parameters.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import MemoryConfig


class CognitiveMapParams(NamedTuple):
    place_centers: torch.Tensor      # [Np, S]
    place_radii: torch.Tensor        # [Np, 1]
    grid_spacings: torch.Tensor      # [Ng, 1]
    grid_orientations: torch.Tensor  # [Ng, 1]
    grid_phases: torch.Tensor        # [Ng, S]
    time_intervals: torch.Tensor     # [Nt, 1]
    time_widths: torch.Tensor        # [Nt, 1]


def init_cognitive_map(generator: Optional[torch.Generator],
                       config: MemoryConfig,
                       device: Union[str, torch.device, None] = "cuda"
                       ) -> CognitiveMapParams:
    """Random cell parameters, drawn on the CPU from `generator` and moved
    to `device`."""
    dev = resolve_device(device)
    S = config.spatial_dims

    def uniform(*shape):
        return torch.rand(shape, generator=generator)

    spacings = torch.logspace(0, 2, config.n_grid_cells, base=2.0)[:, None]
    intervals = torch.logspace(0, 3, config.n_time_cells, base=10.0)[:, None]
    params = CognitiveMapParams(
        place_centers=uniform(config.n_place_cells, S) * 20.0 - 10.0,
        place_radii=uniform(config.n_place_cells, 1) * 1.5 + 0.5,
        grid_spacings=spacings,
        grid_orientations=uniform(config.n_grid_cells, 1) * (math.pi / 3.0),
        grid_phases=uniform(config.n_grid_cells, S) * spacings,
        time_intervals=intervals,
        time_widths=intervals * 0.3,
    )
    return CognitiveMapParams(*[t.to(dev) for t in params])


def place_cell_rates(params: CognitiveMapParams, location: torch.Tensor,
                     max_rate: float = 20.0) -> torch.Tensor:
    """Gaussian place fields for `location` [..., S] -> rates [..., Np]."""
    d = torch.sqrt(((location[..., None, :] - params.place_centers) ** 2)
                   .sum(-1) + 1e-12)
    sigma = params.place_radii[..., 0] / 3.0
    rates = max_rate * torch.exp(-(d ** 2) / (2.0 * sigma ** 2))
    return rates * (d <= params.place_radii[..., 0]).to(rates.dtype)


def grid_cell_rates(params: CognitiveMapParams, location: torch.Tensor,
                    max_rate: float = 25.0) -> torch.Tensor:
    """Hexagonal grid-cell interference for 2-D `location` [..., 2]."""
    k_const = 4.0 * math.pi / math.sqrt(3.0)
    x = location[..., None, 0:1]
    y = location[..., None, 1:2]
    cos_o = torch.cos(params.grid_orientations)
    sin_o = torch.sin(params.grid_orientations)
    rx = cos_o * x - sin_o * y
    ry = sin_o * x + cos_o * y
    sx = rx - params.grid_phases[..., 0:1]
    sy = ry - params.grid_phases[..., 1:2]
    k = k_const / params.grid_spacings
    u1 = k * sx
    u2 = k * (-0.5 * sx + 0.866 * sy)
    u3 = k * (-0.5 * sx - 0.866 * sy)
    val = (torch.cos(u1) + torch.cos(u2) + torch.cos(u3)) / 3.0 + 0.5
    return max_rate * torch.relu(val[..., 0])


def time_cell_rates(params: CognitiveMapParams, elapsed: torch.Tensor,
                    max_rate: float = 15.0) -> torch.Tensor:
    """Gaussian temporal fields for elapsed time [...] -> [..., Nt]."""
    diff = elapsed[..., None] - params.time_intervals[..., 0]
    w = params.time_widths[..., 0] / 3.0
    return max_rate * torch.exp(-(diff ** 2) / (2.0 * w ** 2))
