"""Weights carried across from the JAX package.

`params_from_numpy(tree, config, memory_config)` takes the flax parameter
tree of a `HippocampalTransformer` as nested dicts of numpy arrays (the
caller does `jax.tree.map(np.asarray, params)`, with or without the outer
"params" key) and returns the port's `state_dict` (f32 CPU tensors) for a
model built from the same configs:

    model.load_state_dict(params_from_numpy(tree, config, memory_config))

Names map one to one (`layer_<i>` -> `layers.<i>`); flax's `Dense` kernel
[in, out] becomes `weight` [out, in]; `Embed.embedding` and
`LayerNorm.scale` become `weight`; `MultiHeadDotProductAttention`'s
kernels [D, H, Hd] / [H, Hd, D] flatten to [H*Hd, D] / [D, H*Hd];
`Synapsis` keeps its [in, out] `kernel`, and an `ExpertBank`'s stacked
leaves under `bank/experts/{syn1,syn2,readout}` keep their [E, in, out]
`kernel` and [E, out] `bias` (the port's `StackedLinear` layout); the
basal ganglia's 0-d `gate_<region>` leaves load as they are. A key
missing from the tree or left over, or a shape that differs, raises.
The flax tree holds `prosody_gate` only if `init` saw `prosody`, and the
RAG parameters only if it saw a `memory_state`, while the port's model
always has them: give `init` both.

`module_from_numpy(module, tree)` loads any port module whose names
mirror a flax module's (the trainer's `Amygdala` and `Thalamus`, the
brain zones and spiking layers, the language zones, `NaturalBrain` and
the emotion head among them); the tree may be flax's variables with a
"constants" collection beside "params", whose leaves
(`SpikingLayer`'s beta and threshold, `AdaptiveSpikingLayer`'s
`lateral_inhibition`, `ReservoirLayer`'s `W_rec`) load into the module's
buffers of the same names. `trainer_from_numpy` builds a port `Trainer`
from the numpy trees of a JAX `Trainer` (model, amygdala, thalamus, bank,
optimizer state and step), so both packages train, or resume, from the
same state. `load_brain_system` and `load_liquid_brain` carry a JAX
`NeuromorphicBrainSystem`'s zones and biases, and a JAX `LiquidBrain`'s
whitener, Oja layer and experts, into their port counterparts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch.config import MemoryConfig, ModelConfig

_LAYER = re.compile(r"^layer_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for name, value in tree.items():
        path = prefix + (name,)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray
                  ) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    in_mha = len(mods) >= 2 and mods[-2] == "memory_attention"
    x = np.asarray(value, np.float32)
    if leaf == "kernel":
        if parent in ("syn1", "syn2") or "experts" in mods:
            pass            # Synapsis [in, out]; an expert bank's [E, in, out]
        elif in_mha:
            # query/key/value [D, H, Hd] -> [D, H*Hd]; out [H, Hd, D] ->
            # [H*Hd, D]; then [out, in]
            x = (x.reshape(x.shape[0], -1) if parent != "out"
                 else x.reshape(-1, x.shape[-1])).T
            leaf = "weight"
        else:                                            # Dense: [in, out]
            x = x.T
            leaf = "weight"
    elif leaf == "bias" and in_mha and parent != "out":
        x = x.reshape(-1)                                # [H, Hd] -> [H*Hd]
    elif leaf in ("embedding", "scale"):
        leaf = "weight"
    mods = [("layers." + m[6:]) if _LAYER.match(m) else m for m in mods]
    return ".".join(mods + [leaf]), np.array(x, np.float32, order="C")


def _merge(a: Mapping[str, Any], b: Mapping[str, Any]) -> Dict[str, Any]:
    """Two nested trees as one (a submodule in both holds both's
    leaves)."""
    out = dict(a)
    for key, value in b.items():
        if key in out and isinstance(value, Mapping):
            out[key] = _merge(out[key], value)
        elif key in out:
            raise KeyError(f"{key} is in both collections")
        else:
            out[key] = value
    return out


def tree_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The name and layout mapping alone, for any module of
    `models/layers.py` (no check against a model). A tree of flax
    variables, {"params": ...} with or without "constants", gives both
    collections' leaves."""
    if "params" in tree and set(tree) <= {"params", "constants"}:
        tree = _merge(tree["params"], tree.get("constants", {}))
    return {key: torch.from_numpy(x) for key, x in
            (_convert_leaf(p, v) for p, v in _flatten(tree))}


def params_from_numpy(tree: Mapping[str, Any], config: ModelConfig,
                      memory_config: Optional[MemoryConfig] = None
                      ) -> Dict[str, torch.Tensor]:
    """The state_dict of `HippocampalTransformer(config, memory_config)`
    from a flax parameter tree; raises on a missing or extra key or a
    shape that differs."""
    from aura_snn_rag_tpu_torch.models.transformer import (
        HippocampalTransformer)
    sd = tree_to_state_dict(tree)
    want = HippocampalTransformer(config, memory_config,
                                  device="meta").state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing "
                       f"{missing}, extra {extra}")
    for key, t in want.items():
        if tuple(sd[key].shape) != tuple(t.shape):
            raise ValueError(f"{key}: flax shape {tuple(sd[key].shape)}, "
                             f"model shape {tuple(t.shape)}")
    return {key: sd[key] for key in want}


def module_from_numpy(module: torch.nn.Module,
                      tree: Mapping[str, Any]) -> torch.nn.Module:
    """Loads a flax tree into a port module of the same names (strict:
    a missing or extra key or a shape that differs raises); returns the
    module."""
    sd = tree_to_state_dict(tree)
    want = module.state_dict()
    if set(sd) != set(want):
        raise KeyError(f"flax tree does not match {type(module).__name__}: "
                       f"missing {sorted(set(want) - set(sd))}, extra "
                       f"{sorted(set(sd) - set(want))}")
    module.load_state_dict(sd)
    return module


def _flat_like(trainer, tree: Mapping[str, Any]) -> torch.Tensor:
    """A flax tree shaped like the parameters (an Adam moment), flattened
    in the order of the optimizer's flat buffer (the model's parameters)
    as f32."""
    cfg = trainer.config
    sd = params_from_numpy(tree, cfg.model,
                           cfg.memory if cfg.model.use_rag else None)
    return torch.cat([sd[name].reshape(-1)
                      for name, _ in trainer.model.named_parameters()])


def _load_opt_state(trainer, opt_state) -> None:
    """optax's `chain(clip_by_global_norm, adamw(schedule))` state, as the
    JAX package's trainer holds it: `opt_state[1][0]` is
    `ScaleByAdamState(count, mu, nu)` and the schedule's count sits
    further along `opt_state[1]`. The port's one `count` stands for both,
    so they must agree."""
    adam, *rest = opt_state[1]
    counts = {int(np.asarray(adam.count))} | {
        int(np.asarray(s.count)) for s in rest
        if "count" in getattr(s, "_fields", ())}
    if len(counts) != 1:
        raise ValueError(f"optimizer counts disagree: {sorted(counts)}")
    count, mu, nu = trainer.optimizer.state
    with torch.no_grad():
        count.fill_(counts.pop())
        mu.copy_(_flat_like(trainer, adam.mu).to(mu.dtype))
        nu.copy_(_flat_like(trainer, adam.nu))


def trainer_from_numpy(config, params: Mapping[str, Any],
                       amygdala: Optional[Mapping[str, Any]] = None,
                       thalamus: Optional[Mapping[str, Any]] = None,
                       memory_state=None, seed: int = 0, device="cuda",
                       opt_state=None, step: int = 0):
    """A port `Trainer` (`training/trainer.py`) holding a JAX `Trainer`'s
    state: `params` is `jax.tree.map(np.asarray, trainer.state.params)`,
    `amygdala` / `thalamus` the same of `trainer.amygdala_params` /
    `trainer.thalamus_params` (required when the config enables them),
    `memory_state` the bank as numpy (`jax.tree.map(np.asarray,
    trainer.hippocampus.state)`), or None to keep the new empty bank,
    `opt_state` the same of `trainer.state.opt_state` (its count, first
    moment in `optimizer_mu_dtype` and second moment), or None for a
    fresh optimizer, and `step` `int(trainer.state.step)`."""
    from aura_snn_rag_tpu_torch.memory.state import state_from_numpy
    from aura_snn_rag_tpu_torch.training.trainer import Trainer
    trainer = Trainer(config, seed=seed, device=device)
    sd = params_from_numpy(params, config.model,
                           config.memory if config.model.use_rag else None)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(sd[name])                    # into the optimizer's buffer
    for mod, tree in ((trainer.amygdala, amygdala),
                      (trainer.thalamus, thalamus)):
        if mod is not None:
            if tree is None:
                raise ValueError(f"{type(mod).__name__} is enabled but no "
                                 f"tree was given")
            module_from_numpy(mod, tree)
    if memory_state is not None:
        trainer.hippocampus._set_state(
            state_from_numpy(memory_state, trainer.device))
    if opt_state is not None:
        _load_opt_state(trainer, opt_state)
    trainer._step = int(step)
    return trainer


def load_brain_system(system, zone_params: Mapping[str, Any],
                      homeo_i: Optional[Mapping[str, Any]] = None):
    """Loads a JAX `NeuromorphicBrainSystem`'s zones into a port one built
    with the same widths: `zone_params` is `jax.tree.map(np.asarray,
    system._zone_params)` (one flax tree per zone, every zone), and
    `homeo_i` its plasticity engine's `homeo_i` (each zone's bias), or
    None to keep the port's. Returns the system."""
    zones = system._zone_modules
    if set(zone_params) != set(zones):
        raise KeyError(f"zones {sorted(zone_params)}, system has "
                       f"{sorted(zones)}")
    for name, tree in zone_params.items():
        module_from_numpy(zones[name], tree)
    for name, bias in (homeo_i or {}).items():
        system.plasticity.homeo_i[name] = np.array(bias, np.float32)
    return system


def load_liquid_brain(brain, whitener, hippocampus, cortex=None):
    """Loads a JAX `LiquidBrain`'s state into a port one of the same
    widths: `whitener` and `hippocampus` are its `WhitenerState` and
    `OjaState` as numpy (`jax.tree.map(np.asarray, ...)`), `cortex` its
    list of `NLMSExpert`s (weights, step size, error sums), or None to
    keep the port's. Returns the brain."""
    from aura_snn_rag_tpu_torch.training.online import OjaState, WhitenerState

    def tensors(state, cls):
        return cls(*(torch.as_tensor(np.array(x), device=brain.device)
                     for x in state))
    brain.whitener = tensors(whitener, WhitenerState)
    brain.hippocampus = tensors(hippocampus, OjaState)
    if cortex is not None:
        if len(cortex) != len(brain.cortex):
            raise ValueError(f"{len(cortex)} experts, the brain has "
                             f"{len(brain.cortex)}")
        for mine, theirs in zip(brain.cortex, cortex):
            mine.w = np.array(theirs.w, np.float32)
            mine.mu, mine.lr_decay, mine.eps = (theirs.mu, theirs.lr_decay,
                                                theirs.eps)
            mine._sq_err, mine._n = theirs._sq_err, theirs._n
    return brain
