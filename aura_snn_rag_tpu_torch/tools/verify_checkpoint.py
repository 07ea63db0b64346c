"""Audit of a checkpoint of the port's `Trainer` against a fresh trainer
of its preset, and its numbers (counterpart of
`tools/verify_checkpoint.py`).

    python -m aura_snn_rag_tpu_torch.tools.verify_checkpoint CKPT_DIR
        [--preset test|debug|small|medium|full|xl] [--step N] [--deep]

The checkpoint is `ckpt_{step}.pt` and `meta_{step}.json`, as
`training/checkpoint.py` writes them; it is read on the host,
memory-mapped. The template is a fresh `Trainer` of the preset on the
meta device (`torch.device("meta")`, the counterpart of
`jax.eval_shape`): it holds every tensor's shape and dtype, no storage,
and reads no weights. Without `--preset` the preset is inferred from the
checkpoint (`inspect_checkpoint.infer_preset`).

- default: the key audit, the payload's keys against the template's:
  the flat `params`, `mu` and `nu` buffers, `count`, `step`,
  `memory_state`, `cognitive_map`, `amygdala` and `thalamus`, each
  tensor's shape and dtype. A checkpoint's parameters are one flat
  buffer, which carries no shapes, so a parameter whose shape drifted
  shows as a length gap of `params` (and of `mu` and `nu`).
- `--deep`: also scans every tensor for NaN and Inf, the flat buffers
  parameter by parameter along the template's layout; reports the
  weight matrices whose RMS is an outlier or zero; audits the bank: rows
  with strength > 0 against `count`, and the sidecar's `slot_ids`
  against `count`.

Findings use the JAX tool's words (MISSING, UNEXPECTED, SHAPE MISMATCH,
DTYPE MISMATCH, NONFINITE, NORM OUTLIER, ALL-ZERO KERNEL, BANK). Exit
status 0: the checkpoint is sane; 1: findings.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from aura_snn_rag_tpu_torch.memory.cognitive_map import CognitiveMapParams
from aura_snn_rag_tpu_torch.memory.state import MemoryState
from aura_snn_rag_tpu_torch.tools.inspect_checkpoint import (
    PRESETS, all_steps, infer_config_from_params, infer_preset, load_meta,
    load_payload, param_layout, preset_trainer)

FLAT = ("params", "mu", "nu")        # buffers laid out like the parameters


def build_template(preset: str) -> Tuple[Dict[str, Any],
                                         List[Tuple[str, Tuple[int, ...]]]]:
    """(template, layout): the payload `CheckpointManager.save` writes for
    a fresh trainer of the preset, as meta tensors, and the parameters'
    (name, shape) in the flat buffer's order."""
    trainer = preset_trainer(preset)
    opt, hippo = trainer.optimizer, trainer.hippocampus
    count, mu, nu = opt.state
    template = {
        "params": opt.flat,
        "count": count,
        "mu": mu,
        "nu": nu,
        "step": 0,
        "memory_state": dict(zip(MemoryState._fields, hippo.state)),
        "cognitive_map": dict(zip(CognitiveMapParams._fields,
                                  hippo.cognitive_map)),
        "amygdala": ({} if trainer.amygdala is None
                     else trainer.amygdala.state_dict()),
        "thalamus": ({} if trainer.thalamus is None
                     else trainer.thalamus.state_dict()),
    }
    return template, param_layout(trainer)


def _keypaths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested dict flattened to {"['a']['b']": leaf}."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key, value in tree.items():
        out.update(_keypaths(value, f"{prefix}['{key}']"))
    return out


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if torch.is_tensor(x) else ()


def audit_keys(ckpt: Dict[str, Any], template: Dict[str, Any]) -> List[str]:
    """Missing, unexpected and mismatched entries of the checkpoint."""
    got, want = _keypaths(ckpt), _keypaths(template)
    findings = []
    for k in sorted(set(want) - set(got)):
        findings.append(f"MISSING in checkpoint: {k} "
                        f"(model expects {_shape(want[k])})")
    for k in sorted(set(got) - set(want)):
        findings.append(f"UNEXPECTED in checkpoint: {k} {_shape(got[k])}")
    for k in sorted(set(got) & set(want)):
        gs, ws = _shape(got[k]), _shape(want[k])
        if gs != ws:
            note = ""
            if k in {f"['{name}']" for name in FLAT} and gs and ws:
                note = (f" (a length gap of {gs[0] - ws[0]:+d}: the flat "
                        f"buffer carries no shapes)")
            findings.append(f"SHAPE MISMATCH {k}: checkpoint {gs} vs "
                            f"model {ws}{note}")
            continue
        if torch.is_tensor(got[k]) and torch.is_tensor(want[k]) \
                and got[k].dtype != want[k].dtype:
            findings.append(f"DTYPE MISMATCH {k}: checkpoint "
                            f"{got[k].dtype} vs model {want[k].dtype}")
    return findings


def _named(payload: Dict[str, Any],
           layout: Optional[List[Tuple[str, Tuple[int, ...]]]]
           ) -> Dict[str, torch.Tensor]:
    """Every tensor of the payload by key path, the flat buffers split
    into their parameters where their length fits the layout."""
    leaves = {k: v for k, v in _keypaths(payload).items()
              if torch.is_tensor(v)}
    n = sum(int(torch.Size(s).numel()) for _, s in layout or ())
    for name in FLAT:
        flat = leaves.get(f"['{name}']")
        if layout is None or flat is None or flat.numel() != n:
            continue
        del leaves[f"['{name}']"]
        off = 0
        for pname, shape in layout:
            k = int(torch.Size(shape).numel())
            leaves[f"['{name}']['{pname}']"] = flat[off:off + k].view(shape)
            off += k
    return leaves


def deep_scan(payload: Dict[str, Any], meta: Dict[str, Any],
              layout: Optional[List[Tuple[str, Tuple[int, ...]]]] = None,
              max_report: int = 20) -> List[str]:
    """Numerical sanity of every tensor, and the bank's audit."""
    findings = []
    norms = {}
    for k, t in _named(payload, layout).items():
        if not (t.is_floating_point() or t.is_complex()):
            continue
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            findings.append(f"NONFINITE {k}: {bad}/{t.numel()} values")
        if t.numel():
            norms[k] = float(t.float().square().mean().sqrt())
    # norm outliers among the weight matrices only (biases and norm
    # scales sit at 0 or 1 by design and would skew the median)
    weights = dict(layout or ())
    pnorms = {k: v for k, v in norms.items()
              if k.startswith("['params']['") and k.endswith("weight']")
              and len(weights.get(k[12:-2], ())) == 2}
    if pnorms:
        vals = torch.tensor(list(pnorms.values()))
        live = vals[vals > 0]
        med = float(live.median()) if live.numel() else 0.0
        for k, v in sorted(pnorms.items(), key=lambda kv: -kv[1]):
            if v > max(100.0, 1000 * med):
                findings.append(f"NORM OUTLIER {k}: rms {v:.3g} vs kernel "
                                f"median {med:.3g} (exploded?)")
        dead = [k for k, v in pnorms.items() if v == 0.0]
        for k in dead[:max_report]:
            findings.append(f"ALL-ZERO KERNEL {k} (never trained?)")

    # the bank: occupancy against the strength rows, the sidecar's ids
    ms = payload.get("memory_state")
    if ms is not None and "count" in ms and "strength" in ms:
        count = int(ms["count"].sum())
        strength = ms["strength"]
        live = int((strength > 0).sum())
        if live > count and count < strength.numel():
            findings.append(f"BANK: {live} rows with strength>0 but "
                            f"count={count}")
        ids = meta.get("slot_ids")
        if ids is not None:
            named = sum(1 for s in ids if s)
            # no named slot is normal for a trainer's bank (its writes
            # take dense slots); a partial table means the sidecar and
            # the bank diverged
            if 0 < named < min(count, len(ids)):
                findings.append(
                    f"BANK: id table has only {named} named slots but "
                    f"count={count} (sidecar/bank divergence)")
    return findings


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.tools.verify_checkpoint",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--preset", default=None, choices=PRESETS,
                    help="config preset to audit against (default: "
                         "inferred from the checkpoint)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--deep", action="store_true",
                    help="read every tensor and run the numerical scans")
    return ap


class Audit(NamedTuple):
    status: int                   # the exit status
    findings: List[str]
    preset: Optional[str]
    step: Optional[int]


def run(argv: Optional[Sequence[str]] = None) -> Audit:
    """Audit the checkpoint named in `argv`; prints the report."""
    args = parser().parse_args(argv)
    directory = os.path.abspath(args.checkpoint_dir)
    steps = all_steps(directory)
    if not steps:
        print(f"no checkpoints under {args.checkpoint_dir}", flush=True)
        return Audit(1, [], None, None)
    step = args.step if args.step is not None else steps[-1]
    print(f"auditing step {step} (available: {steps})", flush=True)
    payload = load_payload(directory, step)

    preset = args.preset
    if preset is None:
        preset = infer_preset(payload)
        inferred = infer_config_from_params(payload)
        if preset is None:
            print(f"cannot map inferred config {inferred} to a preset; "
                  f"pass --preset", flush=True)
            return Audit(1, [], None, step)
        print(f"inferred preset: {preset} ({inferred})", flush=True)

    template, layout = build_template(preset)
    layout_entry = payload.get("memory_layout")
    if layout_entry is not None:
        # a sharded bank: every field stacked over its shards
        S = layout_entry["shards"]
        template["memory_layout"] = layout_entry
        template["memory_state"] = {
            k: torch.empty((S, *t.shape), dtype=t.dtype, device="meta")
            for k, t in template["memory_state"].items()}
    findings = audit_keys(payload, template)

    meta = load_meta(directory, step)
    if meta is None:
        meta = {}
        findings.append(f"MISSING sidecar meta_{step}.json "
                        f"(string-id table + host scalars)")
    if args.deep:
        findings.extend(deep_scan(payload, meta, layout))

    print(f"checkpoint keys: {len(_keypaths(payload))}; template keys: "
          f"{len(_keypaths(template))}", flush=True)
    if findings:
        print(f"\n{len(findings)} finding(s):")
        for f_ in findings:
            print(f"  - {f_}")
        return Audit(1, findings, preset, step)
    print("OK: all keys/shapes/dtypes match"
          + ("; all leaves finite, bank consistent" if args.deep else ""),
          flush=True)
    return Audit(0, findings, preset, step)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Audit the checkpoint; returns the exit status."""
    return run(argv).status


if __name__ == "__main__":
    raise SystemExit(main())
