"""Neuromorphic brain zones: mixed-neuron populations behind one interface
(counterpart of `aura_snn_rag_tpu/zones/brain_zone.py`).

- `SpikingNeuronConfig` / `BrainZoneConfig`: a zone's population as
  groups of LIF, Izhikevich or AdEx neurons with percentage shares;
- `spiking_group_forward`: one group over [B, T, D] currents plus its
  homeostatic bias. Izhikevich and AdEx integrate millisecond dynamics:
  each input step is held for `substeps` integration steps
  (`repeat_interleave`, as `jnp.repeat` repeats each step) at 15 mV (or
  40 for AdEx) per unit of current, and the spikes are pooled back to
  counts per input step. LIF runs one step per input step;
- `NeuromorphicBrainZone`: addition-only input projection, the currents
  standardised per sample (population std, `correction=0`, as `jnp.std`)
  and squashed by tanh, held for `timesteps` steps, split across the
  groups (`population` returns their spikes and membranes), rates
  projected out by an addition-only projection and divided by the
  population size; returns (output, stats) with
  `avg_firing_rate`, `spike_count`, `membrane_mean` and `membrane_std`
  as 0-dim tensors on the zone's device;
- `zone_config_from_pattern`, `create_cerebellum`: zones of one named
  Izhikevich pattern;
- `CorticalRegion`: a zone and a LayerNorm of its output.

At the zone's drive (tanh currents x 40 for 12.8 ms, shorter than
tau_m = 20 ms) an AdEx group never fires; that is the JAX package's
behaviour, kept here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.layers import LayerNorm, draw_device
from aura_snn_rag_tpu_torch.ops.maths import AdditionLinearModule
from aura_snn_rag_tpu_torch.ops.neurons import (
    adex_params, adex_scan, izhikevich_params, izhikevich_scan,
    lif_params, lif_scan)

BIOPHYSICAL = ("izhikevich", "adex")


@dataclass(frozen=True)
class SpikingNeuronConfig:
    neuron_type: str = "lif"          # 'lif' | 'izhikevich' | 'adex'
    percentage: float = 1.0
    beta: float = 0.5
    threshold: float = 0.6
    izh_a: float = 0.02
    izh_b: float = 0.2
    izh_c: float = -65.0
    izh_d: float = 6.0


@dataclass(frozen=True)
class BrainZoneConfig:
    name: str = "zone"
    n_neurons: int = 128
    input_dim: int = 64
    output_dim: int = 64
    neuron_configs: Tuple[SpikingNeuronConfig, ...] = (
        SpikingNeuronConfig(),)
    timesteps: int = 4


def spiking_group_forward(cfg: SpikingNeuronConfig, currents: torch.Tensor,
                          homeo_i: torch.Tensor, substeps: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One neuron group over [B, T, D] currents (+ homeostatic bias).
    Returns (spikes [B, T, D], final membrane potential [B, D])."""
    currents = currents + homeo_i
    if cfg.neuron_type in BIOPHYSICAL:
        T = currents.shape[-2]
        held = torch.repeat_interleave(currents, substeps, dim=-2)
        if cfg.neuron_type == "izhikevich":
            p = izhikevich_params(cfg.izh_a, cfg.izh_b, cfg.izh_c,
                                  cfg.izh_d)
            spikes, (v, _) = izhikevich_scan(p, held * 15.0)   # mV drive
        else:
            spikes, (v, _) = adex_scan(adex_params(), held * 40.0)
        # pool the substeps back to counts per input step
        shape = spikes.shape[:-2] + (T, substeps, spikes.shape[-1])
        return spikes.reshape(shape).sum(dim=-2), v
    p = lif_params(currents.shape[-1], cfg.beta, cfg.threshold,
                   dtype=currents.dtype, device=currents.device)
    return lif_scan(p, currents)


def group_sizes(config: BrainZoneConfig):
    """Neurons per group: each group's percentage of the population,
    rounded down, the last group the rest."""
    sizes, total = [], 0
    for i, ncfg in enumerate(config.neuron_configs):
        if i == len(config.neuron_configs) - 1:
            sizes.append(config.n_neurons - total)
        else:
            s = int(config.n_neurons * ncfg.percentage)
            sizes.append(s)
            total += s
    return sizes


class NeuromorphicBrainZone(nn.Module):
    """x [B, D_in] -> (output [B, D_out], activity stats). The weights are
    drawn from `generator` on its device, then moved to `device`."""

    def __init__(self, config: BrainZoneConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.config = config
        self.input_proj = AdditionLinearModule(
            config.input_dim, config.n_neurons, device=draw)
        self.output_proj = AdditionLinearModule(
            config.n_neurons, config.output_dim, device=draw)
        self.input_proj.init_parameters(generator)
        self.output_proj.init_parameters(generator)
        self.to(dev)

    def population(self, x: torch.Tensor,
                   homeo_i: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The population's response to x [B, D_in]: (spikes [B, T, N],
        final membranes [B, N], Izhikevich and AdEx in units of 30 mV)."""
        zc = self.config
        if homeo_i is None:
            homeo_i = x.new_zeros(zc.n_neurons)
        currents = self.input_proj(x)
        # L1-distance outputs are uniformly negative, which would leave
        # every neuron silent; standardise per sample so the best-matching
        # half of the population receives positive drive
        mu = currents.mean(dim=-1, keepdim=True)
        sd = currents.std(dim=-1, keepdim=True, correction=0) + 1e-6
        currents = torch.tanh((currents - mu) / sd)
        currents = currents[..., None, :].expand(
            currents.shape[:-1] + (zc.timesteps, zc.n_neurons))

        spikes_parts, mem_parts = [], []
        offset = 0
        for ncfg, size in zip(zc.neuron_configs, group_sizes(zc)):
            if size <= 0:
                continue
            sp, mem = spiking_group_forward(
                ncfg, currents[..., offset:offset + size],
                homeo_i[offset:offset + size])
            spikes_parts.append(sp)
            # membranes on one scale across models (Izhikevich and AdEx
            # in mV, LIF in units)
            mem_parts.append(mem / (30.0 if ncfg.neuron_type in BIOPHYSICAL
                                    else 1.0))
            offset += size
        return torch.cat(spikes_parts, dim=-1), torch.cat(mem_parts, dim=-1)

    def forward(self, x: torch.Tensor,
                homeo_i: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        spikes, mems = self.population(x, homeo_i)
        rates = spikes.mean(dim=-2)                            # [B, N]
        out = self.output_proj(rates) / max(1.0, self.config.n_neurons)
        stats = {"avg_firing_rate": rates.mean(),
                 "spike_count": spikes.sum(),
                 "membrane_mean": mems.mean(),
                 "membrane_std": mems.std(correction=0)}
        return out, stats


def zone_config_from_pattern(name: str, pattern: str, n_neurons: int = 128,
                             input_dim: int = 64, output_dim: int = 64,
                             timesteps: int = 4) -> BrainZoneConfig:
    """A zone whose population fires in a named Izhikevich pattern."""
    from aura_snn_rag_tpu_torch.ops.izhikevich_presets import (
        IZHIKEVICH_PRESETS)
    p = IZHIKEVICH_PRESETS[pattern]
    return BrainZoneConfig(
        name=name, n_neurons=n_neurons, input_dim=input_dim,
        output_dim=output_dim, timesteps=timesteps,
        neuron_configs=(SpikingNeuronConfig(
            "izhikevich", izh_a=p["a"], izh_b=p["b"], izh_c=p["c"],
            izh_d=p["d"]),))


def create_cerebellum(n_neurons: int = 128, input_dim: int = 64,
                      output_dim: int = 64) -> BrainZoneConfig:
    """The cerebellum: a fast-spiking granule-like population."""
    return zone_config_from_pattern(
        "cerebellum", "fast_spiking", n_neurons, input_dim, output_dim)


class CorticalRegion(nn.Module):
    """A zone and a LayerNorm (flax's epsilon 1e-6) of its output."""

    def __init__(self, config: BrainZoneConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.zone = NeuromorphicBrainZone(config, dev, generator)
        self.output_norm = LayerNorm(config.output_dim, torch.float32, dev)
        self.output_norm.init_parameters(generator)      # ones and zeros

    def forward(self, x: torch.Tensor, homeo_i=None):
        out, stats = self.zone(x, homeo_i)
        return self.output_norm(out), stats
