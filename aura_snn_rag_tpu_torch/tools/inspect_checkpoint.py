"""What a checkpoint of the port's `Trainer` holds: the model's
configuration, its parameter count, the bank's occupancy and the
sidecar's ids and loss (counterpart of `tools/inspect_checkpoint.py`).

    python -m aura_snn_rag_tpu_torch.tools.inspect_checkpoint CKPT_DIR

Reads the newest `ckpt_{step}.pt` and its `meta_{step}.json`
(`training/checkpoint.py`) on the host, memory-mapped. The port stores
the parameters as one flat f32 buffer, which carries no shapes, so the
configuration is inferred by matching the buffer's length (and the
bank's rows) against each preset's `Trainer`, built on the meta device
(no memory, no weights read): the first preset that matches, in the
order test, debug, small, medium, full, xl, gives `vocab_size`,
`embedding_dim`, `n_place_cells`, `num_layers` and `intermediate_size`
from its parameters' shapes; `param_count` is the buffer's length.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

PRESETS = ("test", "debug", "small", "medium", "full", "xl")
_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def all_steps(directory: str) -> List[int]:
    """The steps that have a `ckpt_{step}.pt` under `directory`."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in
                  map(_CKPT.match, os.listdir(directory)) if m)


def load_payload(directory: str, step: int) -> dict:
    """The checkpoint's payload, its tensors memory-mapped on the host."""
    return torch.load(os.path.join(directory, f"ckpt_{step}.pt"),
                      map_location="cpu", weights_only=True, mmap=True)


def load_meta(directory: str, step: int) -> Optional[dict]:
    """The `meta_{step}.json` sidecar, or None when it is missing."""
    path = os.path.join(directory, f"meta_{step}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def preset_trainer(preset: str):
    """A fresh `Trainer` of the preset on the meta device: every tensor's
    shape and dtype, no storage."""
    from aura_snn_rag_tpu_torch import config as cfgmod
    from aura_snn_rag_tpu_torch.training.trainer import Trainer
    return Trainer(getattr(cfgmod, f"get_{preset}_config")(), device="meta")


def param_layout(trainer) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of each parameter, in the order the optimizer's flat
    buffer holds them."""
    return [(name, tuple(p.shape))
            for name, p in trainer.model.named_parameters()]


def _bank_rows(payload: dict) -> Optional[int]:
    feats = payload.get("memory_state", {}).get("features")
    return None if feats is None else int(feats.shape[-2])


def infer_preset(payload: dict) -> Optional[str]:
    """The first preset whose flat parameter buffer has the checkpoint's
    length and whose bank has its rows; None when none does."""
    n = payload["params"].numel()
    rows = _bank_rows(payload)
    for name in PRESETS:
        trainer = preset_trainer(name)
        if (trainer.optimizer.flat.numel() == n
                and (rows is None
                     or trainer.config.memory.max_memories == rows)):
            return name
    return None


def infer_config_from_params(payload: dict) -> Dict[str, int]:
    """The model's architecture, read from the matching preset's
    parameter shapes (the buffer's length alone when none matches)."""
    out = {}
    preset = infer_preset(payload)
    if preset is not None:
        shapes = dict(param_layout(preset_trainer(preset)))
        emb = shapes.get("semantic_encoder.token_embedding.weight")
        if emb is not None:
            out["vocab_size"], out["embedding_dim"] = emb
        proj = shapes.get("semantic_encoder.semantic_projection.weight")
        if proj is not None:
            out["n_place_cells"] = proj[0]
        out["num_layers"] = len({name.split(".")[1] for name in shapes
                                 if name.startswith("layers.")})
        up = (shapes.get("layers.0.ffn.up.weight")
              or shapes.get("layers.0.ffn.mlp.up.weight"))
        if up is not None:
            out["intermediate_size"] = up[0]
    out["param_count"] = payload["params"].numel()
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.tools.inspect_checkpoint",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint_dir")
    return ap


class Inspection(NamedTuple):
    steps: List[int]
    config: Optional[dict]        # infer_config_from_params
    count: Optional[int]          # the bank's count
    ids: Optional[int]            # named slots in the sidecar
    loss: Optional[float]


def run(argv: Optional[Sequence[str]] = None) -> Inspection:
    """Inspect the checkpoint named in `argv`; prints the report."""
    args = parser().parse_args(argv)
    directory = os.path.abspath(args.checkpoint_dir)
    steps = all_steps(directory)
    print(f"steps available: {steps}", flush=True)
    if not steps:
        return Inspection(steps, None, None, None, None)
    step = steps[-1]
    payload = load_payload(directory, step)
    config = infer_config_from_params(payload)
    print(json.dumps(config, indent=2, default=str), flush=True)
    count = None
    mem = payload.get("memory_state")
    if mem is not None:
        count = int(mem["count"])
        print(f"memory bank: count={count}", flush=True)
    ids = loss = None
    meta = load_meta(directory, step)
    if meta is not None:
        ids = len([s for s in meta.get("slot_ids", []) if s])
        loss = meta.get("loss")
        print(f"string ids stored: {ids} (loss={loss})", flush=True)
    return Inspection(steps, config, count, ids, loss)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Inspect the checkpoint (the report is printed)."""
    run(argv)


if __name__ == "__main__":
    main()
