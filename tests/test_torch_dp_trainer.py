"""The port's data-parallel trainer (`Trainer.shard_to_mesh`) against the
JAX package's `Trainer.shard_to_mesh` on the same mesh, from the same
weights: the JAX side on the virtual CPU devices of this process, the
port's on gloo ranks (`test_torch_ranks.spawn`), one spawned group per
mesh.

A small LM (2 layers, width 64, SNN FFN on layer 0, RAG in both, f32,
dropout 0) takes 3 `train_step`s on a global batch of 8 x 16 over a
fresh bank sharded over the batch axes (256 rows per shard). Cases:
- ('data', 'model') of (2, 1), the config's gates (thalamus, amygdala,
  endocrine): memory and a store at step 0, then the thalamus gate (0.5,
  a global-batch mean) turns memory off on every rank;
- (4, 1) and the multislice (2, 2, 1), memory and a store at every step
  (thalamus off): step 1 retrieves the rows step 0 wrote, across shards.
Each is held to JAX with `test_torch_trainer.py`'s bounds: the reported
losses within LOSS_RTOL, the first step's gradient (AdamW's first
moment), the parameters per element, and the sharded bank after the
writes (row s of JAX's stacked state = shard s). Every rank holds the
same parameters bit for bit. Then the checkpoint round trip: the bank
saved in the stacked [S, ...] layout, restored into a fresh trainer on
the same mesh bit for bit, and refused by an unsharded trainer.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.parallel.distributed import multislice_mesh
from aura_snn_rag_tpu.training.trainer import Trainer as JTrainer
from aura_snn_rag_tpu_torch.memory import state as tstate
from aura_snn_rag_tpu_torch.models.convert import trainer_from_numpy
from tests.test_torch_common import highest, np_state
from tests.test_torch_ranks import spawn
from tests.test_torch_trainer import (
    LOSS_RTOL, PARAM_ATOL, BANK_ATOL, assert_first_step_grads, jax_named,
    named)

torch.set_num_threads(1)

LM = dict(vocab_size=256, embedding_dim=64, num_layers=2, num_heads=4,
          intermediate_size=128, max_seq_len=512, n_place_cells=64,
          snn_layers=(0,), dtype="float32", dropout=0.0, use_rag=True)
MEM = dict(max_memories=256, feature_dim=64, k_centroids=8,
           probe_centroids=2, n_place_cells=16, n_grid_cells=8,
           n_time_cells=4)
TRAIN = dict(batch_size=8, max_steps=100, warmup_steps=2, lr=1e-3,
             memory_warmup_steps=0)
B, L, N_STEPS = 8, 16, 3
LR = TRAIN["lr"]
CASES = {(2,): {},
         (4,): dict(enable_thalamus=False, memory_store_interval=1),
         (2, 2): dict(enable_thalamus=False, memory_store_interval=1)}


def configs(**train):
    t = dict(TRAIN, **train)
    return (jconfig.AuraConfig(model=jconfig.ModelConfig(**LM),
                               memory=jconfig.MemoryConfig(**MEM),
                               training=jconfig.TrainingConfig(**t)),
            port.AuraConfig(model=port.ModelConfig(**LM),
                            memory=port.MemoryConfig(**MEM),
                            training=port.TrainingConfig(**t)))


def jax_mesh(shape):
    n = int(np.prod(shape))
    devs = jax.devices()[:n]
    if len(shape) == 1:
        return Mesh(np.asarray(devs).reshape(n, 1), ("data", "model"))
    return multislice_mesh(shape[0], 1, devices=devs)


@functools.lru_cache(maxsize=None)
def jax_run(shape):
    """The JAX trainer's steps on the mesh, and the port's inputs: the
    same weights and batches."""
    jcfg, tcfg = configs(**CASES[shape])
    with highest():
        jt = JTrainer(jcfg, seed=0)
    tree = lambda t: None if t is None else jax.tree.map(np.asarray, t)
    ref = trainer_from_numpy(tcfg, tree(jt.state.params),
                             tree(jt.amygdala_params),
                             tree(jt.thalamus_params), None, device="cpu")
    rng = np.random.RandomState(sum(shape))
    ids = rng.randint(0, LM["vocab_size"], (N_STEPS, B, L)).astype(np.int32)
    inputs = {"flat": ref.optimizer.flat.detach().numpy().copy(), "ids": ids}
    for name in ("amygdala", "thalamus"):
        module = getattr(ref, name)
        if module is not None:
            inputs.update({f"{name}/{k}": v.numpy() for k, v in
                           module.state_dict().items()})
    jt.shard_to_mesh(jax_mesh(shape), shard_memory=True)
    want = {"metrics": []}
    with highest():
        want["eval_loss"] = jt.eval_loss(ids[0], ids[0])
    for i in range(N_STEPS):
        with highest():
            m = jt.train_step(ids[i], ids[i])
        want["metrics"].append(m)
        if i == 0:
            want["mu"] = jax_named(tcfg, jt.state.opt_state[1][0].mu)
    want["params"] = jax_named(tcfg, jt.state.params)
    want["bank"] = np_state(jt.hippocampus.state)
    return tcfg, ref, inputs, want


@pytest.fixture(scope="module", params=list(CASES),
                ids=lambda s: "x".join(map(str, s)))
def run(request, tmp_path_factory):
    shape = request.param
    tcfg, ref, inputs, want = jax_run(shape)
    outs = spawn("dp_trainer", int(np.prod(shape)),
                 tmp_path_factory.mktemp("ranks"), inputs, shape=shape,
                 config=tcfg)
    return shape, ref, want, outs


def test_losses_and_memory_gate_match(run):
    shape, _, want, outs = run
    for o in outs:
        for (loss, ce, on), jm in zip(o["metrics"], want["metrics"]):
            assert bool(on) == jm["use_memory"]
            np.testing.assert_allclose(loss, jm["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(ce, jm["ce"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(o["eval_loss"], want["eval_loss"],
                                   rtol=LOSS_RTOL)
    on = [jm["use_memory"] for jm in want["metrics"]]
    assert on == ([True, False, False] if shape == (2,) else [True] * 3)


def test_first_step_gradient_matches(run):
    _, ref, want, outs = run
    for o in outs:
        tmu = {k: v.numpy() for k, v in named(
            ref, torch.from_numpy(o["mu_first_step"])).items()}
        assert_first_step_grads(want["mu"], tmu)


def test_parameters_match_and_stay_replicated(run):
    """Per element within `test_torch_trainer.assert_params`'s bound; and
    every rank's parameters are the same bits."""
    _, ref, want, outs = run
    got = {k: v.numpy() for k, v in named(
        ref, torch.from_numpy(outs[0]["flat"])).items()}
    tmu = {k: v.numpy() for k, v in named(
        ref, torch.from_numpy(outs[0]["mu_first_step"])).items()}
    for name, w in want["params"].items():
        g1 = np.abs(want["mu"][name])
        noise = max(10 * np.abs(want["mu"][name] - tmu[name]).max(), 1e-12)
        tol = PARAM_ATOL + N_STEPS * 2 * LR * np.minimum(
            1.0, noise / np.maximum(g1, 1e-30))
        diff = np.abs(got[name] - w)
        assert (diff <= tol).all(), (name, diff.max())
    for o in outs[1:]:
        np.testing.assert_array_equal(o["flat"], outs[0]["flat"])


def stacked(outs, prefix):
    return tstate.MemoryState(*[np.stack([o[f"{prefix}/{name}"]
                                          for o in outs])
                                for name in tstate.MemoryState._fields])


def test_sharded_bank_matches(run):
    shape, _, want, outs = run
    got = stacked(outs, "bank")
    for name, a, b in zip(tstate.MemoryState._fields, got, want["bank"]):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=BANK_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    S = int(np.prod(shape))
    stores = 1 if shape == (2,) else N_STEPS
    assert (got.count == stores * B // S).all()


def test_checkpoint_round_trip(run):
    """Saved in JAX's stacked layout, restored bit for bit on every rank,
    refused by a trainer without the sharded bank."""
    shape, _, _, outs = run
    S = int(np.prod(shape))
    axes = ["data"] if len(shape) == 1 else ["replica", "data"]
    bank = stacked(outs, "bank")
    for o in outs:
        assert o["restored_step"] == N_STEPS
        assert o["restored_equal"].all()
        assert str(o["saved_layout"]) == str({"axes": axes, "shards": S})
        assert bool(o["cross_layout_raises"])
        for name, a in zip(tstate.MemoryState._fields, bank):
            np.testing.assert_array_equal(o[f"saved/{name}"], a,
                                          err_msg=name)
