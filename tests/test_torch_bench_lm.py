"""The port's LM benchmarks (`aura_snn_rag_tpu_torch/benchmarks/bench_decode.py`,
`bench_generation.py`, `bench_decode_breakdown.py` and
`bench_rag_overhead.py`) against the JAX scripts of the same names in
`benchmarks/`, loaded by their paths and run through the argv they parse:

- greedy decoding: the JAX script's greedy `generate` (top-k 1, no
  penalty) and the port's `bench_decode_breakdown` greedy variant on the
  same weights (the JAX test preset's, initialised once per module and
  carried into the port) give the same tokens. The scripts' other
  variants sample: the JAX package draws threefry bits that torch cannot
  draw, so their tokens are only held to the vocabulary;
- the lines: the decode scripts' `main`s at `--preset test`, 2 new
  tokens and 1 rep (flax's init returning the module's weights, drawn
  once under `jax.jit` with the scripts' key and shapes) print lines
  whose keys the port's lines carry in the same order, with equal values
  where they do not depend on time. `bench_rag_overhead.py` trains the
  full preset, which the CPU cannot run in a test: both scripts run one
  step of batch 4 at the full preset's settings on a small model
  (`get_full_config` patched in the JAX package, `full_config` in the
  port), and their lines carry the same keys, parameter count, batch,
  sequence length and retrieval bytes;
- every flag's default, from each script's source, and the device rule.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu_torch import config as tconfig
from aura_snn_rag_tpu.generation import sampler as jsampler
from aura_snn_rag_tpu.models import transformer as jtransformer
from aura_snn_rag_tpu_torch.benchmarks import _lm
from aura_snn_rag_tpu_torch.benchmarks import bench_decode as tdecode
from aura_snn_rag_tpu_torch.benchmarks import bench_decode_breakdown as tdb
from aura_snn_rag_tpu_torch.benchmarks import bench_generation as tgen
from aura_snn_rag_tpu_torch.benchmarks import bench_rag_overhead as trag
from aura_snn_rag_tpu_torch.models.convert import tree_to_state_dict
from tests.test_torch_common import highest

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script(name):
    return os.path.join(ROOT, "benchmarks", f"{name}.py")


def load(name, argv=()):
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                      script(name))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.argv = saved
    return module


def script_flags(name):
    """{flag: default} of the `ap.add_argument` calls in the script."""
    flags = {}
    for node in ast.walk(ast.parse(open(script(name)).read())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            flag = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            flags[flag] = (ast.literal_eval(kw["default"]) if "default" in kw
                           else False)
    return flags


@pytest.fixture(scope="module")
def lm():
    """(JAX model, its params, the port's model on the same weights): the
    test preset at dropout 0 without a bank, initialised as the scripts
    do (`PRNGKey(0)`, ids of shape [1, 8]) under `jax.jit`."""
    jm = dataclasses.replace(jconfig.get_test_config().model, dropout=0.0)
    tm = _lm.model_config("test")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jmodel = jtransformer.HippocampalTransformer(jm)
    with highest():
        params = jax.jit(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))()
    # flax makes no prosody gate where no prosody is passed; the port's
    # model keeps its own, which these runs never use
    sd = tree_to_state_dict(jax.tree.map(np.asarray, params))
    tmodel = port.HippocampalTransformer(tm, None, device="cpu")
    own = tmodel.state_dict()
    assert all(".prosody_gate." in key for key in set(own) - set(sd))
    assert set(sd) <= set(own)
    tmodel.load_state_dict({**own, **sd})
    return jmodel, params, tmodel.eval()


@pytest.fixture()
def same_weights(lm, monkeypatch):
    """The port's benchmarks build the JAX weights' model, and flax's init in
    the JAX scripts returns the module's cached weights."""
    jmodel, params, tmodel = lm
    monkeypatch.setattr(_lm, "make_model", lambda cfg, dev: tmodel)
    monkeypatch.setattr(jtransformer.HippocampalTransformer, "init",
                        lambda self, *a, **kw: params)
    return lm


def jax_main(name, argv):
    module = load(name)
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        with contextlib.redirect_stdout(out), highest():
            module.main()
    finally:
        sys.argv = saved
    return json.loads(out.getvalue().strip().splitlines()[-1])


def port_main(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = module.main([*argv, "--device", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == line
    return line


def same_keys(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert list(got[key]) == list(value), key


# --------------------------------------------------------------------------
# greedy tokens
# --------------------------------------------------------------------------

def test_greedy_tokens_equal_the_jax_script_s(same_weights):
    jmodel, params, _ = same_weights
    B, L, T = 2, 32, 4
    ids = _lm.prompts(B, L, jmodel.config.vocab_size)
    with highest():
        want = np.asarray(jax.jit(lambda p, i, r: jsampler.generate(
            jmodel, p, i, T, r, temperature=1.0, top_k=1, top_p=1.0,
            repetition_penalty=1.0))(params, jnp.asarray(ids, jnp.int32),
                                     jax.random.PRNGKey(1)))
    res = tdb.run(["--batch", str(B), "--new-tokens", str(T), "--reps", "1",
                   "--device", "cpu"])
    got = res.outputs["greedy"].numpy()
    np.testing.assert_array_equal(got[:, :L], ids)
    np.testing.assert_array_equal(got, want)
    for variant, out in res.outputs.items():
        assert bool(((out >= 0) & (out < res.vocab_size)).all()), variant
    assert res.outputs["full"].shape == (B, L + T)
    assert res.outputs["forward_only"].shape == (B,)
    assert bool(((res.outputs["forward_only"] >= 1)
                 & (res.outputs["forward_only"] <= 100)).all())


# --------------------------------------------------------------------------
# lines
# --------------------------------------------------------------------------

def test_decode_line_matches_the_jax_script_s(same_weights):
    argv = ["--preset", "test", "--new-tokens", "2", "--batches", "1,2",
            "--reps", "1"]
    want = jax_main("bench_decode", argv)
    res = tdecode.run([*argv, "--device", "cpu"])
    same_keys(res.line, want)
    for key in ("metric", "preset", "new_tokens"):
        assert res.line[key] == want[key], key
    for B, ids in res.tokens.items():
        assert ids.shape == (B, 32 + 2)
        assert bool(((ids >= 0) & (ids < res.vocab_size)).all())
        np.testing.assert_array_equal(ids[:, :32].numpy(), _lm.prompts(
            B, 32, res.vocab_size))


def test_generation_line_matches_the_jax_script_s(same_weights):
    argv = ["--preset", "test", "--new-tokens", "2", "--batch", "2",
            "--prompt-len", "16"]
    want = jax_main("bench_generation", argv)
    got = port_main(tgen, argv)
    same_keys(got, want)
    for key in ("batch", "new_tokens"):
        assert got[key] == want[key], key
    assert got["speedup"] == round(got["cached_tokens_per_s"]
                                   / got["recompute_tokens_per_s"], 2)


def test_decode_breakdown_line_matches_the_jax_script_s(same_weights):
    argv = ["--preset", "test", "--new-tokens", "2", "--reps", "1"]
    want = jax_main("bench_decode_breakdown", argv)
    got = port_main(tdb, argv)
    same_keys(got, want)
    for key in ("preset", "batch", "new_tokens"):
        assert got[key] == want[key], key
    ms = got["ms_per_token"]
    assert got["sampler_share_ms"] == round(ms["full"] - ms["forward_only"],
                                            4)
    assert got["f32_weight_read_share_ms"] == round(
        ms["full"] - ms["bf16_full"], 4)


def small_full_config(cfg):
    """`cfg` (the JAX package's or the port's `get_full_config()`) on a
    1-layer, 128-wide model over a 128-wide bank of 100,000 rows, which
    holds the scripts' 80,000 seeded rows."""
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, vocab_size=512, embedding_dim=128, num_layers=1,
            num_heads=4, intermediate_size=256, max_seq_len=32,
            n_place_cells=128, snn_layers=(0,)),
        memory=dataclasses.replace(cfg.memory, feature_dim=128,
                                   k_centroids=32))


def test_rag_overhead_line_carries_the_jax_keys(monkeypatch):
    """Both scripts at the same small config, 1 step of batch 4: the JAX
    keys in order, and the values that do not depend on time equal."""
    argv = ["--steps=1", "--batch=4"]
    jmod = load("bench_rag_overhead", argv)
    jfull = small_full_config(jconfig.get_full_config())
    monkeypatch.setattr(jconfig, "get_full_config", lambda: jfull)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), highest():
        jmod.main()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    tfull = small_full_config(tconfig.get_full_config())
    monkeypatch.setattr(trag, "full_config", lambda: tfull)
    res = trag.run([*argv, "--device", "cpu"])
    line = res.line
    assert list(line) == list(want)
    for key in ("n_params", "batch", "seq_len", "retrieval_hbm_gb_per_step"):
        assert line[key] == want[key], key
    assert (line["batch"], line["seq_len"]) == (4, 32)
    assert line["retrieval_hbm_gb_per_step"] == round(
        1 * 80_000 * 128 * 2 / 1e9, 3)
    assert want["metric"] == "RAG overhead attribution (full preset, one chip)"
    assert line["metric"] == "RAG overhead attribution (full preset, one CPU)"
    tcfg = res.config.training
    assert (tcfg.batch_size, tcfg.memory_warmup_steps, tcfg.enable_thalamus,
            tcfg.optimizer_mu_dtype, tcfg.metrics_fetch_interval) == (
        4, 0, False, "bfloat16", 10)
    assert (res.config.model.use_gradient_checkpointing,
            res.config.model.gradient_checkpoint_policy) == (True, "dots")
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    # MFU against the H100's dense bf16 peak, not the TPU's
    assert trag.H100_SXM_BF16_PEAK_FLOPS == 989e12
    assert "V5E_PEAK_FLOPS" not in vars(trag)


# --------------------------------------------------------------------------
# flags and the device rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("module, name", [
    (tdecode, "bench_decode"), (tgen, "bench_generation"),
    (tdb, "bench_decode_breakdown")])
def test_flags_and_defaults_are_the_jax_script_s(module, name):
    want = script_flags(name)
    args = vars(module.parser().parse_args([]))
    assert args.pop("device") == "cuda"
    assert {f"--{k.replace('_', '-')}": v for k, v in args.items()} == want


@pytest.mark.parametrize("argv", [[], ["--steps=7", "--batch=4"]])
def test_rag_overhead_flags_are_the_jax_script_s(argv):
    jmod = load("bench_rag_overhead", argv)
    args = trag.parser().parse_args(argv)
    assert (args.steps, args.batch) == (jmod.STEPS, jmod.BATCH)


@pytest.mark.parametrize("module", [tdecode, tgen, tdb, trag])
def test_refuses_cuda_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.run([])
