"""The port's examples (`aura_snn_rag_tpu_torch/examples/`) against the JAX
scripts of the same names in `examples/`, loaded by their paths and run
through their `main` under the same argv, on the same seeded numpy data:

- the training scripts (`train_tiny`, `train_wikitext2`,
  `pretrain_production`, `train_flagship`) at the debug preset with
  dropout 0 and f32 compute (the presets patched in both packages), the
  port's `Trainer` built from the JAX `Trainer`'s initial weights
  (`models/convert.trainer_from_numpy`, patched in as the module's
  `Trainer`): the printed lines' keys in order, step 0's loss within
  `tests/test_torch_trainer.py`'s LOSS_RTOL, and `train_tiny`'s greedy
  tokens (both generators patched to top_k = 1: the JAX sampler draws
  threefry bits); HuggingFace data is patched to raise ImportError in
  both, as `tests/training/test_pretrain_production.py` does;
- `flagship_demo.demo` on a debug-preset checkpoint, greedy, against the
  JAX script's `one_shot_memorize_and_generate` and plain `generate`:
  the memory id and both token rows equal; and `main` beside the JAX
  `main` with a small BPE `tokenizer.json`: the same printed lines;
- `train_emotion_head` from flax's initial weights: the loss of every
  fifth epoch (the printed ones) within 1e-5 of the JAX step's (read by
  `jax.debug.callback`);
- `train_llm_hybrid` from the JAX brain's initial state
  (`models/convert.load_liquid_brain`): every error, the salience and the
  predictions within 1e-5, the lines' words equal;
- `dryrun_pp_xl` at a narrow width (the xl preset's 16 layers, 32 wide):
  the JAX script's loss and gradient norm on 8 virtual devices against
  `rank_work` on 8 gloo ranks holding the same layers; `run` end to end
  on 8 gloo ranks prints the script's keys;
- `run_multihost_cpu.sh`: two gloo processes, the global sum 28.0;
- resuming, the out-of-memory retry and the device rule.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu import generation as jgeneration
from aura_snn_rag_tpu.training import data as jdata
from aura_snn_rag_tpu.training import trainer as jtrainer_mod
from aura_snn_rag_tpu_torch import config as tconfig
from aura_snn_rag_tpu_torch.examples import dryrun_pp_xl as tpp
from aura_snn_rag_tpu_torch.examples import flagship_demo as tfd
from aura_snn_rag_tpu_torch.examples import pretrain_production as tpr
from aura_snn_rag_tpu_torch.examples import train_emotion_head as tem
from aura_snn_rag_tpu_torch.examples import train_flagship as tfl
from aura_snn_rag_tpu_torch.examples import train_llm_hybrid as thy
from aura_snn_rag_tpu_torch.examples import train_tiny as tti
from aura_snn_rag_tpu_torch.examples import train_wikitext2 as twt
from aura_snn_rag_tpu_torch.generation import sampler as tsampler
from aura_snn_rag_tpu_torch.models.brain.brain import (
    LiquidBrain as TLiquidBrain)
from aura_snn_rag_tpu_torch.models.convert import (
    load_liquid_brain, module_from_numpy, trainer_from_numpy)
from aura_snn_rag_tpu_torch.training import data as tdata
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_torch_common import highest
from tests.test_torch_ranks import spawn

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 2e-6        # tests/test_torch_trainer.py's f32 loss bound
ONLINE_TOL = 1e-5       # the emotion head's losses, the hybrid's numbers
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(name, argv, patches=()):
    """The JAX script's `main` under `argv` with `patches` ((object,
    attribute, value) triples) in place: its stdout's lines."""
    mp = pytest.MonkeyPatch()
    buf = io.StringIO()
    module = load(name)
    try:
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        for obj, attr, value in patches:
            mp.setattr(obj, attr, value)
        with highest(), contextlib.redirect_stdout(buf):
            module.main()
    finally:
        mp.undo()
    return buf.getvalue().splitlines()


def run_port(module, argv, patches=()):
    """The port module's `run(argv)` with `patches` in place (stdout
    swallowed): its result."""
    mp = pytest.MonkeyPatch()
    try:
        for obj, attr, value in patches:
            mp.setattr(obj, attr, value)
        with contextlib.redirect_stdout(io.StringIO()):
            return module.run(list(argv) + ["--device", "cpu"])
    finally:
        mp.undo()


def shape(line):
    """A line with its numbers blanked: what both packages print alike."""
    return NUMBER.sub("#", line)


def numbers(line):
    return [float(m.group()) for m in NUMBER.finditer(line)]


def f32_debug(get):
    """A preset getter at dropout 0 and f32 compute."""
    def patched():
        cfg = get()
        return cfg.replace(model=dataclasses.replace(
            cfg.model, dropout=0.0, dtype="float32"))
    return patched


def tree_np(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


class Spy:
    """The JAX `Trainer` under a spy: each trainer's initial weights and
    every `train_step`'s and `train_chunk`'s metrics."""

    def __init__(self):
        self.trainers = []
        spy = self

        class SpyTrainer(jtrainer_mod.Trainer):
            def __init__(self, config, seed=0):
                super().__init__(config, seed=seed)
                self.init = (tree_np(self.state.params),
                             tree_np(self.amygdala_params),
                             tree_np(self.thalamus_params))
                self.metrics = []
                spy.trainers.append(self)

            def train_step(self, input_ids, labels):
                m = super().train_step(input_ids, labels)
                self.metrics.append(m)
                return m

        self.cls = SpyTrainer

    def port_factory(self):
        """A port `Trainer` from the first JAX trainer's initial weights."""
        def make(config, seed=0, device="cuda"):
            params, amygdala, thalamus = self.trainers[0].init
            return trainer_from_numpy(config, params, amygdala, thalamus,
                                      seed=seed, device=device)
        return make


def no_hf(*args, **kwargs):
    raise ImportError("HuggingFace data patched out (hermetic)")


def greedy(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return fn(*args, **dict(kwargs, top_k=1))
    return wrapped


def jax_patches(spy):
    return [(jconfig, "get_debug_config",
             f32_debug(jconfig.get_debug_config)),
            (jtrainer_mod, "Trainer", spy.cls),
            (jdata, "load_hf_streaming", no_hf),
            (jgeneration, "generate", greedy(jgeneration.generate))]


def port_patches(module, spy):
    out = [(tconfig, "get_debug_config",
            f32_debug(tconfig.get_debug_config)),
           (module, "Trainer", spy.port_factory()),
           (tdata, "load_hf_streaming", no_hf)]
    if hasattr(module, "generate"):
        out.append((module, "generate", greedy(module.generate)))
    return out


def assert_same_lines(got, want, skip=()):
    """The lines' shapes equal in order (timing lines' numbers aside)."""
    got = [l for l in got if not l.startswith(skip)] if skip else got
    want = [l for l in want if not l.startswith(skip)] if skip else want
    assert [shape(l) for l in got] == [shape(l) for l in want], (got, want)


# --------------------------------------------------------------------------
# train_tiny
# --------------------------------------------------------------------------

TINY_ARGV = ["--steps", "3"]


@pytest.fixture(scope="module")
def tiny():
    spy = Spy()
    lines = run_jax("train_tiny", TINY_ARGV, jax_patches(spy))
    res = run_port(tti, TINY_ARGV, port_patches(tti, spy))
    return spy, lines, res


def test_train_tiny_lines_and_step_0_loss(tiny):
    spy, lines, res = tiny
    assert_same_lines(res.lines, lines)
    jm = spy.trainers[0].metrics
    assert len(jm) == len(res.metrics) == 3
    np.testing.assert_allclose(res.metrics[0]["loss"], jm[0]["loss"],
                               rtol=LOSS_RTOL)
    assert [m["use_memory"] for m in res.metrics] == \
        [m["use_memory"] for m in jm]


def test_train_tiny_greedy_tokens_match(tiny):
    _, lines, res = tiny
    want = json.loads(lines[-1].split(":", 1)[1])
    assert res.generated == want and len(want) == 16


# --------------------------------------------------------------------------
# train_wikitext2
# --------------------------------------------------------------------------

def test_train_wikitext2_lines_loss_and_resume(tmp_path):
    spy = Spy()
    argv = ["--steps", "3", "--preset", "debug", "--eval-every", "2"]
    lines = run_jax("train_wikitext2", argv + [
        "--checkpoint-dir", str(tmp_path / "jax")], jax_patches(spy))
    res = run_port(twt, argv + ["--checkpoint-dir", str(tmp_path / "port")],
                   port_patches(twt, spy))
    assert_same_lines(res.lines, lines)
    assert lines[0].startswith("synthetic fallback: (1024, 32)")
    # step 0's loss, printed to 4 places by both, and its perplexity
    np.testing.assert_allclose(res.trainer.history["loss"][0],
                               spy.trainers[0].metrics[0]["loss"],
                               rtol=LOSS_RTOL)
    assert numbers(res.lines[1]) == numbers(lines[1])
    # the best checkpoint is step 0's; a rerun resumes there
    assert CheckpointManager(str(tmp_path / "port")).latest_step() == 2
    again = run_port(twt, argv + ["--checkpoint-dir",
                                  str(tmp_path / "port")],
                     port_patches(twt, spy))
    assert again.start == 2


# --------------------------------------------------------------------------
# pretrain_production
# --------------------------------------------------------------------------

def _production_checks(res, out, ckpt_dir, steps):
    """`tests/training/test_pretrain_production.py`'s assertions on the
    port's run."""
    assert "synthetic" in out, out.splitlines()[:3]
    assert "final:" in out
    final = [ln for ln in out.splitlines() if ln.startswith("final:")][-1]
    loss = float(final.split("loss=")[1].split()[0])
    assert np.isfinite(loss) and loss < 20.0
    diags = [ln for ln in out.splitlines() if ln.startswith("[diagnostics]")]
    assert diags, out
    d = json.loads(diags[-1].split("[diagnostics] ", 1)[1])
    assert np.isfinite(d["entropy"])
    cfg = tconfig.get_debug_config()
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, max_steps=steps, memory_warmup_steps=10,
        sleep_interval=50, enable_thalamus=False))
    t2 = port.Trainer(cfg, seed=0, device="cpu")
    assert CheckpointManager(ckpt_dir).restore(t2) == steps
    assert bool(torch.isfinite(t2.optimizer.flat).all())


@pytest.mark.slow
def test_pretrain_production_50_steps(tmp_path, monkeypatch, capsys):
    """The JAX suite's slow smoke test, on the port."""
    monkeypatch.setattr(tdata, "load_hf_streaming", no_hf)
    ckpt_dir = str(tmp_path / "ckpt")
    res = tpr.main(["--steps", "50", "--preset", "debug", "--checkpoint-dir",
                    ckpt_dir, "--monitor-interval", "5", "--device", "cpu"])
    _production_checks(res, capsys.readouterr().out, ckpt_dir, 50)


def test_pretrain_production_few_steps_match_jax(tmp_path, capsys):
    spy = Spy()
    argv = ["--steps", "8", "--preset", "debug", "--monitor-interval",
            "600"]
    lines = run_jax("pretrain_production", argv + [
        "--checkpoint-dir", str(tmp_path / "jax")], jax_patches(spy))
    ckpt_dir = str(tmp_path / "port")
    mp = pytest.MonkeyPatch()
    try:
        for obj, attr, value in port_patches(tpr, spy):
            mp.setattr(obj, attr, value)
        res = tpr.main(argv + ["--checkpoint-dir", ckpt_dir, "--device",
                               "cpu"])
    finally:
        mp.undo()
    out = capsys.readouterr().out
    assert_same_lines(res.lines, lines)
    assert len(res.diagnostics) == 3          # steps 2, 4 and 6
    np.testing.assert_allclose(res.losses[0],
                               spy.trainers[0].metrics[0]["loss"],
                               rtol=LOSS_RTOL)
    for got, want in zip(res.lines[1:4], lines[1:4]):
        g, w = (json.loads(x.split(" ", 1)[1]) for x in (got, want))
        assert list(g) == list(w)
    _production_checks(res, out, ckpt_dir, 8)


def test_generation_diagnostics_match_jax():
    module = load("pretrain_production")
    cfg = f32_debug(jconfig.get_debug_config)()
    with highest():
        jt = jtrainer_mod.Trainer(cfg, seed=0)
    tt = trainer_from_numpy(f32_debug(tconfig.get_debug_config)(),
                            tree_np(jt.state.params),
                            tree_np(jt.amygdala_params),
                            tree_np(jt.thalamus_params), device="cpu")
    ids = np.random.RandomState(3).randint(1, 500, (1, 8))
    with highest():
        want = module.generation_diagnostics(jt.eval_model, jt.state.params,
                                             ids, jax.random.PRNGKey(0))
    got = tpr.generation_diagnostics(tt.model, ids)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=2e-3), key


def test_pretrain_production_retries_a_step_out_of_memory(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(tdata, "load_hf_streaming", no_hf)
    inner = port.Trainer.train_step
    calls = []

    def oom_once(self, ids, labels):
        calls.append(1)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return inner(self, ids, labels)
    monkeypatch.setattr(port.Trainer, "train_step", oom_once)
    res = run_port(tpr, ["--steps", "3", "--checkpoint-dir",
                         str(tmp_path / "a")])
    assert res.retries == 1 and len(calls) == 4
    assert "OOM caught — clearing caches and retrying" in res.lines

    def fails(self, ids, labels):
        raise RuntimeError("some other failure")
    monkeypatch.setattr(port.Trainer, "train_step", fails)
    with pytest.raises(RuntimeError, match="some other failure"):
        run_port(tpr, ["--steps", "3", "--checkpoint-dir",
                       str(tmp_path / "b")])


# --------------------------------------------------------------------------
# train_flagship and flagship_demo
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus folder in the offline builder's layout: uint16 streams
    drawn from a seed, vocabulary 512 (the debug preset's)."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(5)
    np.save(d / "train.npy", rng.randint(3, 512, 20_000).astype(np.uint16))
    np.save(d / "val.npy", rng.randint(3, 512, 3_000).astype(np.uint16))
    with open(d / "meta.json", "w") as f:
        json.dump({"vocab_size": 512}, f)
    return str(d)


FLAGSHIP_ARGV = ["--preset", "debug", "--chunk", "2", "--eval-every", "2",
                 "--save-every", "2", "--memory-warmup", "0"]


def test_train_flagship_records_match_jax_and_resume(corpus, tmp_path):
    spy = Spy()
    argv = FLAGSHIP_ARGV + ["--steps", "4", "--corpus", corpus]
    lines = run_jax("train_flagship", argv + [
        "--cpu", "--log", str(tmp_path / "jax.jsonl"), "--checkpoint-dir",
        str(tmp_path / "jax")], jax_patches(spy))
    log = str(tmp_path / "port.jsonl")
    res = run_port(tfl, argv + ["--log", log, "--checkpoint-dir",
                                str(tmp_path / "port")],
                   port_patches(tfl, spy))
    # the lines: corpus, model, then a record and a checkpoint per chunk,
    # then the final record; the records' keys in order
    assert_same_lines(res.lines, lines, skip=("{",))
    jrecs = [eval(l) for l in lines if l.startswith("{")]
    assert [list(r) for r in res.records] == [list(r) for r in jrecs]
    assert res.records[-1]["n_params"] == jrecs[-1]["n_params"]
    with open(log) as f:
        assert [json.loads(l) for l in f] == json.loads(json.dumps(
            res.records))
    # step 0's loss: the same windows of the same stream
    jt = spy.trainers[0]
    np.testing.assert_allclose(res.trainer.history["loss"][0],
                               jt.history["loss"][0], rtol=LOSS_RTOL)
    # a resumed run continues from the saved step (no warm-up chunk)
    again = run_port(tfl, FLAGSHIP_ARGV + [
        "--steps", "6", "--corpus", corpus, "--log", log,
        "--checkpoint-dir", str(tmp_path / "port")], port_patches(tfl, spy))
    assert again.start == 4 and again.records[0]["step"] == 6
    assert not any("warmup" in l for l in again.lines)
    assert again.trainer.history["step"] == [4, 5]


def test_train_flagship_cpu_flag_and_peak():
    from aura_snn_rag_tpu_torch import _device
    from aura_snn_rag_tpu_torch.benchmarks import bench_rag_overhead
    assert tfl.parser().parse_args(["--cpu"]).cpu
    assert tfl.H100_SXM_BF16_PEAK_FLOPS == _device.H100_SXM_BF16_PEAK_FLOPS
    assert bench_rag_overhead.H100_SXM_BF16_PEAK_FLOPS is \
        _device.H100_SXM_BF16_PEAK_FLOPS
    assert "V5E_PEAK_FLOPS" not in vars(tfl)


@pytest.fixture(scope="module")
def demo_trainers(tmp_path_factory):
    """A JAX trainer at the debug preset (f32, dropout 0, the thalamus
    off, as flagship_demo builds it), built once for the module, and a
    directory holding `meta.json`, a checkpoint of its weights in the
    port's format (`ckpt`, which `flagship_demo.restore` reads) and one in
    JAX's (`jckpt`), both saved before any test memorises."""
    from aura_snn_rag_tpu.training.checkpoint import (
        CheckpointManager as JaxCheckpointManager)
    tmp_path = tmp_path_factory.mktemp("demo")
    cfg = f32_debug(jconfig.get_debug_config)()
    cfg = cfg.replace(training=dataclasses.replace(cfg.training,
                                                   enable_thalamus=False))
    with highest():
        jt = jtrainer_mod.Trainer(cfg, seed=0)
    tcfg = f32_debug(tconfig.get_debug_config)()
    tcfg = tcfg.replace(training=dataclasses.replace(tcfg.training,
                                                     enable_thalamus=False))
    saved = trainer_from_numpy(tcfg, tree_np(jt.state.params),
                               tree_np(jt.amygdala_params), None,
                               device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(7, saved, 1.0)
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"vocab_size": 512}, f)
    JaxCheckpointManager(str(tmp_path / "jckpt")).save(7, jt, 1.0)
    return jt, tmp_path


def test_flagship_demo_greedy_tokens_match_jax(demo_trainers, monkeypatch):
    from aura_snn_rag_tpu.services.one_shot import (
        one_shot_memorize_and_generate)
    jt, tmp_path = demo_trainers
    monkeypatch.setattr(tconfig, "get_debug_config",
                        f32_debug(tconfig.get_debug_config))
    tt, step = tfd.restore(str(tmp_path / "ckpt"), str(tmp_path), "debug",
                           "cpu")
    assert step == 7
    rng = np.random.RandomState(9)
    support, prompt = rng.randint(3, 500, 24), rng.randint(3, 500, 6)
    monkeypatch.setattr(tfd, "generate", greedy(tfd.generate))
    monkeypatch.setattr(tsampler, "generate", greedy(tsampler.generate))
    memory_calls = []
    hook = tt.model.register_forward_pre_hook(
        lambda mod, args, kwargs: memory_calls.append(
            kwargs.get("use_memory")), with_kwargs=True)
    try:
        res = tfd.demo(tt, support, prompt, 8,
                       torch.Generator().manual_seed(0))
    finally:
        hook.remove()
    with highest():
        mid, out_mem = one_shot_memorize_and_generate(
            jt.eval_model, jt.state.params, jt.hippocampus,
            support.astype(np.int32), prompt.astype(np.int32),
            max_new_tokens=8, temperature=0.7, top_k=1)
        out_plain = jgeneration.generate(
            jt.eval_model, jt.state.params, prompt.astype(np.int32)[None],
            8, jax.random.PRNGKey(0), temperature=0.7, top_k=1,
            use_memory=False)
    assert res.memory_id == mid
    np.testing.assert_array_equal(res.with_memory, np.asarray(out_mem[0]))
    np.testing.assert_array_equal(res.without_memory,
                                  np.asarray(out_plain[0]))
    # the memorising pass, then the prefill and 7 steps with memory and
    # as many without
    assert memory_calls == [False] + [True] * 8 + [False] * 8
    assert tt.hippocampus.memory_count == 1


def test_flagship_demo_main_prints_the_script_s_lines(demo_trainers,
                                                     capsys):
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers as tok_trainers
    _, tmp_path = demo_trainers
    texts = tmp_path / "texts.txt"
    texts.write_text((tfd.SUPPORT + "\n") * 20)
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel()
    tok.decoder = decoders.ByteLevel()
    tok.train([str(texts)], tok_trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<unk>", "<eos>"]))
    tok.save(str(tmp_path / "tokenizer.json"))
    argv = ["--corpus", str(tmp_path), "--preset", "debug",
            "--max-new-tokens", "6"]
    lines = run_jax("flagship_demo", argv + [
        "--checkpoint-dir", str(tmp_path / "jckpt")],
        [(jconfig, "get_debug_config", f32_debug(jconfig.get_debug_config)),
         (jgeneration, "generate", greedy(jgeneration.generate))])
    capsys.readouterr()
    out = run_port(tfd, argv + ["--checkpoint-dir", str(tmp_path / "ckpt")],
                   [(tconfig, "get_debug_config",
                     f32_debug(tconfig.get_debug_config)),
                    (tfd, "generate", greedy(tfd.generate)),
                    (tsampler, "generate", greedy(tsampler.generate))])
    got = "\n".join(out.lines).splitlines()
    assert got == lines


# --------------------------------------------------------------------------
# train_emotion_head
# --------------------------------------------------------------------------

def test_train_emotion_head_losses_follow_optax():
    from aura_snn_rag_tpu.models import emotion_head as jeh
    recorded = []
    inner = jeh.emotion_multitask_loss

    def recording(logits, labels):
        loss, per_task = inner(logits, labels)
        jax.debug.callback(lambda v: recorded.append(float(v)), loss)
        return loss, per_task
    lines = run_jax("train_emotion_head", ["--epochs", "20"],
                    [(jeh, "emotion_multitask_loss", recording)])
    X = jnp.zeros((1, tem.DIM))
    params = jeh.EmotionPersonalityHead(
        jeh.EmotionHeadConfig(d_model=tem.DIM), deterministic=True).init(
        jax.random.PRNGKey(0), X)
    head = module_from_numpy(tem.make_head("cpu"), tree_np(params))
    res = run_port(tem, ["--epochs", "20"], [(tem, "make_head",
                                              lambda device: head)])
    assert len(recorded) == len(res.losses) == 20
    # the printed epochs' (every fifth); Adam moves the two apart by
    # ~6e-5 by epoch 19 once a ReLU gate flips
    np.testing.assert_allclose(res.losses[::5], recorded[::5], rtol=0,
                               atol=ONLINE_TOL)
    assert_same_lines(res.lines, lines)
    assert res.lines[-1] == lines[-1]


# --------------------------------------------------------------------------
# train_llm_hybrid
# --------------------------------------------------------------------------

def test_train_llm_hybrid_matches_jax_from_converted_state():
    from aura_snn_rag_tpu.models.brain import brain as jbrain
    from aura_snn_rag_tpu.training import online as jonline
    made, mods = [], []

    class SpyBrain(jbrain.LiquidBrain):
        def __init__(self, **kw):
            super().__init__(**kw)
            # the NLMS experts start at zero weights in both packages
            self.start = (tree_np(self.whitener), tree_np(self.hippocampus))
            self.errors, self.predictions = [], []
            made.append(self)

        def learn_text(self, text, target):
            r = super().learn_text(text, target)
            self.errors.append(abs(r["error"]))
            return r

        def predict_text(self, text):
            p = super().predict_text(text)
            self.predictions.append(p)
            return p

    inner = jonline.stdp_modulations

    def modulations(state, ids, *a, **k):
        out = inner(state, ids, *a, **k)
        mods.append(np.asarray(out))
        return out
    lines = run_jax("train_llm_hybrid", [],
                    [(jbrain, "LiquidBrain", SpyBrain),
                     (jonline, "stdp_modulations", modulations)])
    jb = made[0]

    def from_jax(**kw):
        return load_liquid_brain(TLiquidBrain(**kw), *jb.start)
    res = run_port(thy, [], [(thy, "LiquidBrain", from_jax)])
    np.testing.assert_allclose(res.errors, jb.errors, rtol=0,
                               atol=ONLINE_TOL)
    np.testing.assert_allclose(res.salience, mods[0], rtol=0,
                               atol=ONLINE_TOL)
    np.testing.assert_allclose(
        [res.predictions["finance"], res.predictions["neuro"]],
        jb.predictions, rtol=0, atol=ONLINE_TOL)
    assert_same_lines(res.lines[:-1], lines[:-1])
    assert [l.split("consciousness=")[1] for l in res.lines[:-1]] == \
        [l.split("consciousness=")[1] for l in lines[:-1]]
    assert list(res.line) == list(json.loads(lines[-1]))


# --------------------------------------------------------------------------
# dryrun_pp_xl
# --------------------------------------------------------------------------

def narrow_xl(get):
    """The xl preset at 32 wide (2 heads, FFN 64), f32: its 16 layers."""
    def patched():
        cfg = get()
        return cfg.replace(model=dataclasses.replace(
            cfg.model, embedding_dim=32, num_heads=2, intermediate_size=64,
            dtype="float32"))
    return patched


def test_dryrun_pp_xl_matches_jax_on_8_ranks(tmp_path, monkeypatch):
    from aura_snn_rag_tpu import config as jcfg_mod
    module = load("dryrun_pp_xl")
    stages = []
    inner = module.stack_stage_params

    def spy(per_stage, mesh):
        stages.extend(tree_np(per_stage))
        return inner(per_stage, mesh)
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(module, "get_xl_config",
                  narrow_xl(jcfg_mod.get_xl_config))
        m.setattr(module, "stack_stage_params", spy)
        with highest(), contextlib.redirect_stdout(buf):
            module.main()
    lines = buf.getvalue().splitlines()
    want = json.loads(lines[0])
    assert lines[-1] == "PP xl dryrun OK"
    cfg = narrow_xl(tconfig.get_xl_config)().model
    cfg = dataclasses.replace(cfg, dropout=0.0)
    inputs = {}
    for s, stage in enumerate(stages):
        for i in range(cfg.num_layers // len(stages)):
            layer = jax.tree.map(lambda x: x[i], stage)
            for k, v in _flat(layer).items():
                inputs[f"s{s}/l{i}/{k}"] = v
    outs = spawn("tests.test_torch_mp_ranks:pp_xl", 8, tmp_path / "ranks",
                 inputs, model=dataclasses.asdict(cfg))
    for out in outs:
        assert float(out["loss"]) == pytest.approx(want["loss"], rel=1e-5)
        assert float(out["loss_repeat"]) == float(out["loss"])
        assert float(out["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                        rel=1e-4)
        assert int(out["trunk_params"]) == want["trunk_params"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def test_dryrun_pp_xl_run_prints_the_script_s_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tpp, "model_config", lambda: dataclasses.replace(
        narrow_xl(tconfig.get_xl_config)().model, dropout=0.0))
    res = tpp.run(["--device", "cpu"])
    assert res.lines[-1] == "PP xl dryrun OK"
    rec = json.loads(res.lines[0])
    src = open(os.path.join(ROOT, "examples", "dryrun_pp_xl.py")).read()
    keys = re.findall(r'"(\w+)":', src.split("record = {")[1].split("}")[0])
    assert list(rec) == keys and len(keys) == 15
    assert rec["mesh"] == {"stage": 4, "data": 2}
    assert rec["stages"] == 4 and rec["microbatches"] == 4
    assert rec["loss"] == rec["loss_repeat"] and rec["grad_norm"] > 0
    assert rec["bubble_fraction"] == 3 / 7
    with open(tmp_path / "runs" / "pp_xl_dryrun.json") as f:
        assert json.load(f) == rec


def test_dryrun_pp_xl_needs_8_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"needs 8 CUDA cards; this "
                       r"machine has 1\. Pass --device cpu"):
        tpp.run([])


# --------------------------------------------------------------------------
# run_multihost_cpu.sh
# --------------------------------------------------------------------------

def test_multihost_demo_sums_across_two_processes():
    script = os.path.join(ROOT, "aura_snn_rag_tpu_torch", "examples",
                          "run_multihost_cpu.sh")
    out = subprocess.run(["sh", script], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ,
                                               PYTHON=sys.executable))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "multihost demo OK"
    sums = sorted(l for l in lines if "global_sum" in l)
    # the JAX script's asserted sum, 0 + 1 + ... + 7
    assert "assert total == 28.0" in open(os.path.join(
        ROOT, "examples", "run_multihost_cpu.sh")).read()
    assert sums == [f"process {p}: mesh={{'data': 2, 'model': 1}} "
                    f"global_sum=28.0" for p in (0, 1)]


# --------------------------------------------------------------------------
# flags and the device rule
# --------------------------------------------------------------------------

MODULES = {"train_tiny": tti, "train_wikitext2": twt,
           "pretrain_production": tpr, "train_flagship": tfl,
           "flagship_demo": tfd, "train_emotion_head": tem,
           "train_llm_hybrid": thy, "dryrun_pp_xl": tpp}


def script_flags(path):
    """{flag: default} of a script's `add_argument` calls."""
    import ast
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            flag = node.args[0].value
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            default = kw.get("default", False if kw.get("action")
                             == "store_true" else None)
            out[flag] = default
    return out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_flags_defaults_and_device_rule(name, tmp_path):
    module = MODULES[name]
    want = script_flags(os.path.join(ROOT, "examples", f"{name}.py"))
    args = module.parser().parse_args([])
    got = {o: a.default for a in module.parser()._actions
           for o in a.option_strings if o not in ("-h", "--help")}
    assert got.pop("--device") == "cuda"
    assert got == want
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run(["--corpus", str(tmp_path), "--checkpoint-dir",
                    str(tmp_path)] if name in ("train_flagship",
                                               "flagship_demo") else
                   ["--checkpoint-dir", str(tmp_path)]
                   if "--checkpoint-dir" in want else [])
