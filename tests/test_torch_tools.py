"""The port's operator tools (`aura_snn_rag_tpu_torch/tools/`) against the
JAX tools of the same names in `tools/`, loaded by their paths:

- `verify_checkpoint` and `inspect_checkpoint` on a port checkpoint of
  the debug preset (one `train_step`, then `CheckpointManager.save`),
  mirroring `tests/training/test_verify_checkpoint.py`'s five cases: a
  clean checkpoint audits clean; a shape drift is caught (as a length gap
  of the flat parameter buffer, which carries no shapes); missing and
  unexpected keys are caught; a NaN is caught by `--deep` and named by
  its parameter; the preset is inferred. The inferred configuration
  equals what the JAX tool infers from a JAX checkpoint of the same
  preset, the parameter count included;
- `neuron_firing_diag`: the report within 1e-6 of the JAX tool's, and the
  same warnings;
- `continuous_learning_runner`: exits 0 at `--duration 0.5` and prints
  the JAX tool's keys;
- the flags and the device rule.
"""

import asyncio
import contextlib
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from aura_snn_rag_tpu.training.trainer import Trainer as JaxTrainer
from aura_snn_rag_tpu_torch.config import get_debug_config
from aura_snn_rag_tpu_torch.tools import continuous_learning_runner as tcl
from aura_snn_rag_tpu_torch.tools import inspect_checkpoint as tic
from aura_snn_rag_tpu_torch.tools import neuron_firing_diag as tnd
from aura_snn_rag_tpu_torch.tools import verify_checkpoint as tvc
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
from aura_snn_rag_tpu_torch.training.trainer import Trainer

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quiet(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# --------------------------------------------------------------------------
# verify_checkpoint and inspect_checkpoint
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("audit") / "ckpt"
    tr = Trainer(get_debug_config(), seed=0, device="cpu")
    batch = np.random.RandomState(0).randint(1, 500, (2, 16))
    tr.train_step(batch, batch)
    CheckpointManager(str(d)).save(1, tr, loss=2.0)
    return str(d)


def _payload(d, step=1):
    return torch.load(os.path.join(d, f"ckpt_{step}.pt"), map_location="cpu",
                      weights_only=True)


def test_clean_checkpoint_audits_clean(saved):
    template, _ = tvc.build_template("debug")
    assert tvc.audit_keys(_payload(saved), template) == []
    for argv in ([saved], [saved, "--deep"], [saved, "--preset", "debug"]):
        audit, out = quiet(tvc.run, argv)
        assert audit.status == 0 and audit.findings == [], out
        assert out.splitlines()[-1].startswith("OK: all keys/shapes/dtypes")
    assert quiet(tvc.main, [saved])[0] == 0


def test_shape_drift_is_caught(saved):
    template, layout = tvc.build_template("debug")
    # sabotage the template: pretend the model grew its vocab by 7 rows
    name, shape = layout[0]
    assert name == "semantic_encoder.token_embedding.weight"
    grown = template["params"].numel() + 7 * shape[1]
    for key in ("params", "mu", "nu"):
        template[key] = torch.empty(grown, dtype=template[key].dtype,
                                    device="meta")
    findings = tvc.audit_keys(_payload(saved), template)
    assert len(findings) == 3
    assert all("SHAPE MISMATCH" in f and f"gap of {-7 * shape[1]}" in f
               for f in findings), findings
    assert any("['params']" in f for f in findings)


def test_missing_and_unexpected_keys(saved):
    template, _ = tvc.build_template("debug")
    template["memory_state"]["ghost_field"] = template["memory_state"][
        "strength"]
    payload = _payload(saved)
    findings = tvc.audit_keys(payload, template)
    assert any("MISSING" in f and "ghost_field" in f for f in findings)
    del template["memory_state"]["ghost_field"]
    del template["cognitive_map"]
    findings = tvc.audit_keys(payload, template)
    assert any("UNEXPECTED" in f and "cognitive_map" in f for f in findings)
    # a payload without its sidecar
    assert all(f.startswith("UNEXPECTED") for f in findings)


def test_deep_scan_flags_nonfinite_and_passes_clean(saved, tmp_path):
    payload = _payload(saved)
    with open(os.path.join(saved, "meta_1.json")) as f:
        meta = json.load(f)
    _, layout = tvc.build_template("debug")
    assert tvc.deep_scan(payload, meta, layout) == []
    # inject a NaN into final_norm.weight
    names = [n for n, _ in layout]
    i = names.index("final_norm.weight")
    offset = sum(int(np.prod(s)) for _, s in layout[:i])
    payload["params"][offset] = float("nan")
    findings = tvc.deep_scan(payload, meta, layout)
    assert findings == ["NONFINITE ['params']['final_norm.weight']: 1/64 "
                        "values"], findings
    # and through the tool, on a sabotaged copy of the checkpoint
    bad = tmp_path / "bad"
    bad.mkdir()
    torch.save(payload, bad / "ckpt_1.pt")
    shutil.copy(os.path.join(saved, "meta_1.json"), bad)
    audit, out = quiet(tvc.run, [str(bad)])
    assert audit.status == 0, out                 # keys and shapes only
    audit, out = quiet(tvc.run, [str(bad), "--deep"])
    assert audit.status == 1 and audit.findings == findings, out
    assert "1 finding(s):" in out
    os.remove(bad / "meta_1.json")
    audit, _ = quiet(tvc.run, [str(bad)])
    assert audit.status == 1 and audit.findings[0].startswith(
        "MISSING sidecar meta_1.json")


def test_sharded_bank_layout_audits_clean(saved, tmp_path):
    """A data-parallel trainer's checkpoint holds its bank stacked over
    the shards, with a `memory_layout` entry: the template stacks too."""
    payload = _payload(saved)
    payload["memory_state"] = {k: torch.stack([t, t]) for k, t in
                               payload["memory_state"].items()}
    payload["memory_layout"] = {"axes": ["data"], "shards": 2}
    torch.save(payload, tmp_path / "ckpt_1.pt")
    shutil.copy(os.path.join(saved, "meta_1.json"), tmp_path)
    audit, out = quiet(tvc.run, [str(tmp_path), "--deep"])
    assert audit.status == 0 and audit.preset == "debug", out
    del payload["memory_layout"]
    template, _ = tvc.build_template("debug")
    assert any(f.startswith("SHAPE MISMATCH ['memory_state']")
               for f in tvc.audit_keys(payload, template))


@pytest.fixture(scope="module")
def jax_inferred(tmp_path_factory):
    """The JAX tool's inference from a JAX checkpoint of the debug
    preset."""
    import orbax.checkpoint as ocp
    d = str(tmp_path_factory.mktemp("jax_audit") / "ckpt")
    JaxCheckpointManager(d).save(1, JaxTrainer(jconfig.get_debug_config(),
                                               seed=0), loss=2.0)
    md = ocp.StandardCheckpointer().metadata(os.path.join(d, "1",
                                                          "default"))
    md = getattr(md, "item_metadata", md)
    return load("inspect_checkpoint").infer_config_from_params(
        md.get("params", md))


def test_preset_inference_from_shapes(saved, jax_inferred):
    payload = _payload(saved)
    assert tic.infer_preset(payload) == "debug"
    inferred = tic.infer_config_from_params(payload)
    c = get_debug_config().model
    assert inferred["embedding_dim"] == c.embedding_dim
    assert inferred["num_layers"] == c.num_layers
    assert inferred["vocab_size"] == c.vocab_size
    # the JAX tool's inference from a JAX checkpoint of the preset: the
    # same keys in the same order, the same values, the parameter count
    # included (flax's init is given prosody, so it makes the prosody
    # gate the port's model always has)
    assert inferred == jax_inferred
    audit, out = quiet(tvc.run, [saved])
    assert audit.preset == "debug" and "inferred preset: debug" in out


def test_inspect_reports_bank_and_sidecar(saved, tmp_path):
    res, out = quiet(tic.run, [saved])
    assert res.steps == [1] and res.count == 0 and res.ids == 0
    assert res.loss == 2.0
    lines = out.splitlines()
    assert lines[0] == "steps available: [1]"
    assert lines[-2:] == ["memory bank: count=0",
                          "string ids stored: 0 (loss=2.0)"]
    res, out = quiet(tic.run, [str(tmp_path)])
    assert res.steps == [] and out.strip() == "steps available: []"
    audit, out = quiet(tvc.run, [str(tmp_path)])
    assert audit.status == 1 and out.startswith("no checkpoints under")


# --------------------------------------------------------------------------
# neuron_firing_diag
# --------------------------------------------------------------------------

def test_neuron_firing_diag_matches_jax():
    _, out = quiet(load("neuron_firing_diag").main)
    end = out.index("\n}\n") + 2
    want, jax_warnings = json.loads(out[:end]), out[end:].split()
    res, port_out = quiet(tnd.run, ["--device", "cpu"])
    assert json.loads(port_out[:port_out.index("\n}\n") + 2]) == res.report
    assert list(res.report) == list(want)
    for model, curve in want.items():
        assert list(res.report[model]) == list(curve), model
        for key, value in curve.items():
            assert abs(res.report[model][key] - value) <= TOL, (model, key)
    assert " ".join(res.warnings).split() == jax_warnings


# --------------------------------------------------------------------------
# continuous_learning_runner
# --------------------------------------------------------------------------

def test_continuous_learning_runner_prints_the_jax_keys():
    class Args:
        vocab_dir, rss, duration, d_model = None, False, 0.5, 64

    _, out = quiet(asyncio.run, load("continuous_learning_runner").run(Args))
    want = json.loads(out.strip().splitlines()[-1])
    line, port_out = quiet(tcl.main, ["--device", "cpu", "--duration",
                                      "0.5"])
    assert json.loads(port_out.strip().splitlines()[-1]) == line
    assert port_out.startswith("orchestrator running for 0.5s")
    assert list(line) == list(want) == ["stats", "health"]
    for key in want:
        assert list(line[key]) == list(want[key]), key


# --------------------------------------------------------------------------
# flags and the device rule
# --------------------------------------------------------------------------

def _flags(name):
    import ast
    flags = {}
    src = open(os.path.join(ROOT, "tools", f"{name}.py")).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            flags[node.args[0].value] = kw.get(
                "default", False if kw.get("action") == "store_true"
                else None)
    return flags


TOOLS = {"verify_checkpoint": tvc, "inspect_checkpoint": tic,
         "neuron_firing_diag": tnd, "continuous_learning_runner": tcl}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_flags_and_device_rule(name):
    module = TOOLS[name]
    ours = {a.option_strings[0] if a.option_strings else a.dest: a.default
            for a in module.parser()._actions if a.dest != "help"}
    theirs = _flags(name)
    if name in ("verify_checkpoint", "inspect_checkpoint"):
        # they compute nothing: the host and the meta device, no --device
        assert ours == theirs
        return
    assert ours.pop("--device") == "cuda"
    assert ours == theirs
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run([])


def test_trainer_template_on_the_meta_device_holds_no_storage():
    template, layout = tvc.build_template("full")
    assert template["params"].device.type == "meta"
    assert template["params"].numel() == sum(int(np.prod(s))
                                             for _, s in layout) > 200e6
    assert all(t.device.type == "meta"
               for t in template["memory_state"].values())
