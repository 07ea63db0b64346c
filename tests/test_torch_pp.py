"""The port's GPipe pipeline (`parallel/pipeline.py`) and pipelined LM
(`models/pipelined.py`) against the JAX package's, the cases of
`tests/parallel/test_pipeline.py`, `tests/models/test_pipelined.py` and
`tests/parallel/test_pp_rag.py`: the same numpy inputs and weights (flax
initialises them, `models/convert.py` carries them across) through the
JAX functions on the virtual CPU devices (jitted) and through the port's
on gloo ranks (`test_torch_ranks.spawn`), each rank one stage.

- The two-matmul block over 4 stages (4 microbatches) and over
  ('stage', 'model') of (2, 2): outputs within the JAX tests' 2e-5, and
  every stage's gradients within rtol 1e-4, atol 1e-5 of JAX's.
- The LM (the debug preset's widths, 4 layers, bf16 as there) over 4
  stages, and over 2 with the SNN pattern (True, False) and with prosody:
  logits within the JAX tests' own bounds of JAX's pipelined logits. A
  non-uniform SNN pattern raises.
- The RAG stack over 2 stages with a live bank of 64 memories: f32
  logits within 2e-4 of JAX's (the f32 model parity bound of
  `test_torch_model.py`; JAX's own pipelined-vs-full bound, 1e-5, holds
  for the port's pipelined forward against its plain one), bf16 logits
  within `test_pp_rag.py`'s distribution bounds, the logits move when
  the bank is emptied, and the one-step loss (rtol 1e-5) and every
  parameter's gradient (each tensor's largest difference within 2e-4 of
  its largest entry, or 1e-3 of the model's largest, as
  `test_torch_trainer.py` holds first-step gradients) in f32 equal JAX's.
The models take max_seq_len 512, as the LM parity tests do (flax's
one-pass LayerNorm variance near the theta carrier's quarter period).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.config import get_debug_config
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.memory.state import init_memory_state
from aura_snn_rag_tpu.models import HippocampalTransformer
from aura_snn_rag_tpu.models.pipelined import (
    pipelined_lm_apply, pipelined_rag_apply)
from aura_snn_rag_tpu.parallel.pipeline import (
    pipeline_apply, split_microbatches, stack_stage_params)
from aura_snn_rag_tpu.training.losses import hippocampal_loss
from aura_snn_rag_tpu_torch.models.convert import params_from_numpy
from aura_snn_rag_tpu_torch.models.pipelined import stage_pattern
from tests.test_torch_common import highest, np_state
from tests.test_torch_ranks import spawn

torch.set_num_threads(1)

TOY_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
F32_TOL = 2e-4
TENSOR_GRAD_TOL, GRAD_FLOOR = 2e-4, 1e-3
# toy cases: (name, mesh shape, axis names, microbatches, batch)
TOY = [("s4", (4,), ("stage",), 4, 8),
       ("s2m2", (2, 2), ("stage", "model"), 2, 4)]
# model cases: (name, layers, snn_layers, rag, dtype, prosody, M, batch,
# grad)
MODELS = {
    4: [("lm4", 4, (), False, "bfloat16", False, 4, 8, False)],
    2: [("snn", 4, (0, 2), False, "bfloat16", True, 2, 4, False),
        ("pros", 4, (), False, "bfloat16", True, 2, 4, False),
        ("rag32", 4, (), True, "float32", False, 4, 8, True),
        ("rag16", 4, (), True, "bfloat16", False, 4, 8, False)],
}
L = 32


def block_fn(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


@functools.lru_cache(maxsize=None)
def toy(name, shape, names, M, batch, d=16):
    """Inputs, JAX's output and JAX's per-stage gradients."""
    rng = np.random.RandomState(len(name))
    S = shape[names.index("stage")]
    per = [{"w1": rng.randn(d, 2 * d).astype(np.float32) * 0.1,
            "b1": rng.randn(2 * d).astype(np.float32) * 0.1,
            "w2": rng.randn(2 * d, d).astype(np.float32) * 0.1}
           for _ in range(S)]
    x = rng.randn(batch, d).astype(np.float32)
    tgt = rng.randn(M, batch // M, d).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))])
                .reshape(shape), names)
    stacked = stack_stage_params(
        [jax.tree.map(jnp.asarray, p) for p in per], mesh)
    mbs = split_microbatches(jnp.asarray(x), M)

    def loss(params):
        return jnp.mean((pipeline_apply(block_fn, params, mbs, mesh)
                         - tgt) ** 2)
    out = jax.jit(lambda p: pipeline_apply(block_fn, p, mbs, mesh))(stacked)
    grads = jax.jit(jax.grad(loss))(stacked)
    inputs = {f"{name}/x": x, f"{name}/tgt": tgt}
    for s, p in enumerate(per):
        inputs.update({f"{name}/p{s}/{k}": v for k, v in p.items()})
    return inputs, np.asarray(out), jax.tree.map(np.asarray, grads)


def model_config(layers, snn, rag, dtype):
    cfg = get_debug_config()
    return cfg.memory, dataclasses.replace(
        cfg.model, num_layers=layers, snn_layers=tuple(snn), use_rag=rag,
        dropout=0.0, dtype=dtype, max_seq_len=512)


@functools.lru_cache(maxsize=None)
def model_case(name, layers, snn, rag, dtype, with_prosody, M, batch,
               grad):
    """The port's inputs (weights, ids, prosody, bank), and JAX's
    pipelined logits (and loss and gradients) on a 'stage' mesh."""
    mcfg, cfg = model_config(layers, snn, rag, dtype)
    S = 4 if name == "lm4" else 2
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("stage",))
    model = HippocampalTransformer(cfg, memory_config=mcfg if rag else None)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 512, (batch, L)).astype(np.int32)
    prosody = rng.rand(batch, L, 4).astype(np.float32)
    pr = jnp.asarray(prosody) if with_prosody else None
    ms = None
    if rag:
        feats = rng.randn(64, mcfg.feature_dim).astype(np.float32)
        with highest():
            ms = jengine.write_memories(
                mcfg, init_memory_state(mcfg), jnp.asarray(feats),
                jnp.zeros((64, 2), jnp.float32))
    with highest():
        params = jax.jit(lambda i, p, s: model.init(
            jax.random.PRNGKey(0), i, prosody=p, use_memory=True,
            memory_state=s))(jnp.asarray(ids), jnp.asarray(prosody), ms)

    def fwd(p):
        if rag:
            return pipelined_rag_apply(model, p, jnp.asarray(ids), ms, mesh,
                                       M, prosody=pr)
        return pipelined_lm_apply(model, p, jnp.asarray(ids), mesh, M,
                                  prosody=pr)
    with highest():
        logits = np.asarray(jax.jit(fwd)(params))
    want = {"logits": logits}
    if grad:
        def loss(p):
            return hippocampal_loss(fwd(p)[:, :-1], jnp.asarray(ids)[:, 1:],
                                    None, label_smoothing=0.0,
                                    entropy_lambda=0.0, sparsity_lambda=0.0)
        with highest():
            value, grads = jax.jit(jax.value_and_grad(loss))(params)
        want["loss"] = float(value)
        want["grads"] = params_from_numpy(
            jax.tree.map(np.asarray, jax.device_get(grads)),
            port.ModelConfig(**dataclasses.asdict(cfg)),
            port.MemoryConfig(**dataclasses.asdict(mcfg)) if rag else None)
    sd = params_from_numpy(
        jax.tree.map(np.asarray, params),
        port.ModelConfig(**dataclasses.asdict(cfg)),
        port.MemoryConfig(**dataclasses.asdict(mcfg)) if rag else None)
    inputs = {f"{name}/sd/{k}": v.numpy() for k, v in sd.items()}
    inputs[f"{name}/ids"] = ids
    if with_prosody:
        inputs[f"{name}/prosody"] = prosody
    if rag:
        for f, a in zip(ms._fields, np_state(ms)):
            inputs[f"{name}/bank/{f}"] = a
    port_case = (name, dataclasses.asdict(cfg),
                 dataclasses.asdict(mcfg), rag, with_prosody, M, grad)
    return inputs, port_case, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's ranks' outputs: 4 ranks (the 4-stage cases and the
    ('stage', 'model') toy) and 2 (the 2-stage model cases)."""
    out = {}
    for world in sorted(MODELS):
        inputs, cases = {}, []
        toys = [t for t in TOY if np.prod(t[1]) == world]
        for t in toys:
            inputs.update(toy(*t)[0])
        for m in MODELS[world]:
            i, c, _ = model_case(*m)
            inputs.update(i)
            cases.append(c)
        out[world] = spawn("tests.test_torch_mp_ranks:pipeline_suite",
                           world, tmp_path_factory.mktemp("pp"), inputs,
                           toy=[t[:4] for t in toys], models=cases)
    return out


@pytest.mark.parametrize("case", TOY, ids=[t[0] for t in TOY])
def test_toy_pipeline_matches_jax(runs, case):
    """JAX's pipeline and the sequential run of the stages, and JAX's
    gradients to every stage."""
    name = case[0]
    inputs, want, grads = toy(*case)
    S = case[1][case[2].index("stage")]
    seq = inputs[f"{name}/x"]
    for s in range(S):
        p = {k: inputs[f"{name}/p{s}/{k}"] for k in ("w1", "b1", "w2")}
        seq = seq + np.tanh(seq @ p["w1"] + p["b1"]) @ p["w2"]
    for o in runs[int(np.prod(case[1]))]:
        np.testing.assert_allclose(o[f"{name}/out"], want, **TOY_TOL)
        np.testing.assert_allclose(o[f"{name}/out"].reshape(seq.shape),
                                   seq, **TOY_TOL)
        s = int(o[f"{name}/stage"])
        for k in ("w1", "b1", "w2"):
            np.testing.assert_allclose(o[f"{name}/grad/{k}"], grads[k][s],
                                       **GRAD_TOL,
                                       err_msg=f"{name} {k} stage {s}")
            assert np.abs(o[f"{name}/grad/{k}"]).max() > 0


LM_CASES = [(w, m) for w, ms in sorted(MODELS.items()) for m in ms
            if not m[3]]


@pytest.mark.parametrize("world,case", LM_CASES,
                         ids=[m[0] for _, m in LM_CASES])
def test_pipelined_lm_matches_jax(runs, world, case):
    """The JAX tests' bounds: rtol 0.05 / atol 0.02 without the SNN; with
    it, the 0.999 quantile of |diff| under 0.05, the largest under 0.1
    and argmax agreement of at least 0.9."""
    name = case[0]
    want = model_case(*case)[2]["logits"]
    for o in runs[world]:
        got = o[f"{name}/logits"]
        if case[2]:
            diff = np.abs(got - want)
            assert np.quantile(diff, 0.999) < 0.05
            assert diff.max() < 0.1
            assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.9
        else:
            np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)


def test_pipelined_rag_forward_f32_matches_jax(runs):
    want = model_case(*MODELS[2][2])[2]["logits"]
    for o in runs[2]:
        np.testing.assert_allclose(o["rag32/logits"], want, rtol=0,
                                   atol=F32_TOL)


def test_pipelined_rag_forward_bf16_matches_jax(runs):
    want = model_case(*MODELS[2][3])[2]["logits"]
    for o in runs[2]:
        diff = np.abs(o["rag16/logits"] - want)
        assert np.quantile(diff, 0.99) < 0.06
        assert diff.max() < 0.3
        assert np.mean(o["rag16/logits"].argmax(-1)
                       == want.argmax(-1)) >= 0.9


def test_rag_retrieval_is_live_in_pipeline(runs):
    """An empty bank moves the pipelined logits: the stages retrieve."""
    for o in runs[2]:
        for name in ("rag32", "rag16"):
            assert np.abs(o[f"{name}/logits"]
                          - o[f"{name}/empty_logits"]).max() > 1e-4


def test_pipelined_rag_step_matches_jax(runs):
    outs = runs[2]
    want = model_case(*MODELS[2][2])[2]
    k = MODELS[2][2][1] // len(outs)     # layers per stage
    for o in outs:
        np.testing.assert_allclose(o["rag32/loss"], want["loss"], rtol=1e-5)
    top = max(np.abs(g.numpy()).max() for g in want["grads"].values())
    for pname, g in want["grads"].items():
        g = g.numpy()
        if pname.startswith("layers."):  # on its stage's rank alone
            got = outs[int(pname.split(".")[1]) // k][f"rag32/grad/{pname}"]
        else:                            # the same on every rank
            got = outs[0][f"rag32/grad/{pname}"]
            for o in outs[1:]:
                np.testing.assert_allclose(o[f"rag32/grad/{pname}"], got,
                                           rtol=0, atol=1e-7, err_msg=pname)
        tol = max(TENSOR_GRAD_TOL * np.abs(g).max(), GRAD_FLOOR * top)
        assert np.abs(got - g).max() <= tol, (pname, np.abs(got - g).max())


def test_nonuniform_pattern_rejected():
    _, cfg = model_config(4, (0, 1), False, "float32")
    with pytest.raises(ValueError, match="not uniform"):
        stage_pattern(port.ModelConfig(**dataclasses.asdict(cfg)), 2)
    assert stage_pattern(port.ModelConfig(**dataclasses.asdict(
        model_config(4, (0, 2), False, "float32")[1])), 2) == (True, False)
