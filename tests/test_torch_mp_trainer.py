"""The port's `Trainer.shard_to_mesh` over 'seq' and 'model' axes against
the JAX package's trainer, from the same weights and batches: the JAX
`Trainer` on the virtual CPU devices of this process, the port's on
gloo ranks (`test_torch_ranks.spawn`), one spawned group per mesh.

The debug preset's LM with memory (RAG in both layers, the SNN FFN on
layer 0), in f32 with dropout 0 and max_seq_len 512 (the LM parity
tests' choice), memory and a store at every step, the thalamus gate off
(`tests/parallel/test_sp_model.py`'s setting), 2 `train_step`s on a
global batch of 4 x 32 against the JAX trainer's steps:
- sequence parallelism, ('data', 'seq') of (1, 2) and (2, 2): each rank
  runs its chunk of 16 positions through ring attention, the targets
  cross the chunks' edges, and the losses are the whole sequence's
  (`test_seq_sharded_rag_step_matches_unsharded`); a max_seq_len the
  'seq' axis does not divide raises (`test_seq_shards_must_divide_
  seq_len`);
- tensor parallelism, ('data', 'model') of (1, 2) and (2, 2): the TP
  trainer's steps; and ('data', 'seq', 'model') of (1, 2, 2);
each held with `test_torch_trainer.py`'s bounds: the losses and ce and
the eval loss within LOSS_RTOL, the first step's gradient (AdamW's first
moment, in the unsharded layout), and every parameter after the steps.
Meshes with one data shard keep the sharded bank (one shard: the whole
bank); the (2, ...) meshes keep a replicated bank, which takes the
unsharded trainer's writes.

Then `tests/training/test_checkpoint.py::test_multislice_bank_roundtrip`
with 'model' = 2: `multislice_mesh(2, 2)` on 4 ranks, a step and rows
written to the bank sharded over ('replica', 'data'), saved with the
whole (unsharded) parameters, and restored bit for bit into a trainer
of another seed.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.training.trainer import Trainer as JTrainer
from aura_snn_rag_tpu_torch.models.convert import trainer_from_numpy
from tests.test_torch_common import highest
from tests.test_torch_ranks import spawn
from tests.test_torch_trainer import (
    LOSS_RTOL, PARAM_ATOL, assert_first_step_grads, jax_named, named)

torch.set_num_threads(1)

B, L, N_STEPS = 4, 32, 2
LR = 1e-3
MESHES = {
    "seq1x2": ((1, 2), ("data", "seq")),
    "seq2x2": ((2, 2), ("data", "seq")),
    "tp1x2": ((1, 2), ("data", "model")),
    "tp2x2": ((2, 2), ("data", "model")),
    "sp_tp": ((1, 2, 2), ("data", "seq", "model")),
}


def configs():
    dbg = jconfig.get_debug_config()
    lm = dict(dataclasses.asdict(dbg.model), use_rag=True, dropout=0.0,
              dtype="float32", max_seq_len=512, snn_layers=(0,))
    train = dict(dataclasses.asdict(dbg.training), memory_warmup_steps=0,
                 memory_store_interval=1, metrics_fetch_interval=1,
                 enable_thalamus=False, warmup_steps=2, lr=LR)
    mem = dataclasses.asdict(dbg.memory)
    return (jconfig.AuraConfig(model=jconfig.ModelConfig(**lm),
                               memory=jconfig.MemoryConfig(**mem),
                               training=jconfig.TrainingConfig(**train)),
            port.AuraConfig(model=port.ModelConfig(**lm),
                            memory=port.MemoryConfig(**mem),
                            training=port.TrainingConfig(**train)))


@functools.lru_cache(maxsize=None)
def jax_run():
    """The JAX trainer's steps, and the port's inputs: the same weights
    and batches."""
    jcfg, tcfg = configs()
    with highest():
        jt = JTrainer(jcfg, seed=0)
    tree = lambda t: None if t is None else jax.tree.map(np.asarray, t)
    ref = trainer_from_numpy(tcfg, tree(jt.state.params),
                             tree(jt.amygdala_params), None, None,
                             device="cpu")
    rng = np.random.RandomState(11)
    ids = rng.randint(0, tcfg.model.vocab_size,
                      (N_STEPS, B, L)).astype(np.int32)
    inputs = {"flat": ref.optimizer.flat.detach().numpy().copy(),
              "ids": ids}
    inputs.update({f"amygdala/{k}": v.numpy() for k, v in
                   ref.amygdala.state_dict().items()})
    want = {"metrics": []}
    with highest():
        want["eval_loss"] = jt.eval_loss(ids[0], ids[0])
    for i in range(N_STEPS):
        with highest():
            want["metrics"].append(jt.train_step(ids[i], ids[i]))
        if i == 0:
            want["mu"] = jax_named(tcfg, jt.state.opt_state[1][0].mu)
    want["params"] = jax_named(tcfg, jt.state.params)
    return tcfg, ref, inputs, want


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    shape, names = MESHES[request.param]
    tcfg, ref, inputs, want = jax_run()
    outs = spawn("tests.test_torch_mp_ranks:trainer_steps",
                 int(np.prod(shape)), tmp_path_factory.mktemp("mp"),
                 inputs, shape=shape, names=names, config=tcfg,
                 shard_memory=shape[0] == 1)
    return names, ref, want, outs


def test_losses_match_jax(run):
    names, _, want, outs = run
    for o in outs:
        for (loss, ce, on), jm in zip(o["metrics"], want["metrics"]):
            assert bool(on) and jm["use_memory"]
            np.testing.assert_allclose(loss, jm["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(ce, jm["ce"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(o["eval_loss"], want["eval_loss"],
                                   rtol=LOSS_RTOL)
        seq = "seq" in names
        assert str(o["seq_axis"]) == ("seq" if seq else "None")
        assert bool(o["model_has_mesh"]) == seq
        if seq:
            assert bool(o["indivisible_raises"])


def test_first_step_gradient_matches(run):
    _, ref, want, outs = run
    for o in outs:
        tmu = {k: v.numpy() for k, v in named(
            ref, torch.from_numpy(o["mu_first_step"])).items()}
        assert_first_step_grads(want["mu"], tmu)


def test_parameters_match(run):
    """Per element within `test_torch_trainer.assert_params`'s bound;
    every rank holds the same whole parameters, and a tensor-parallel
    rank a part of them."""
    names, ref, want, outs = run
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
    whole = ref.optimizer.flat.numel()
    for o in outs:
        assert (int(o["local_numel"]) < whole) == ("model" in names)


def test_multislice_tp_checkpoint_roundtrip(tmp_path):
    tcfg, ref, inputs, _ = jax_run()
    rng = np.random.RandomState(0)
    ckpt_inputs = {
        **inputs, "ids": inputs["ids"][0],
        "other_flat": rng.randn(*inputs["flat"].shape).astype(np.float32),
        "feats": rng.randn(8, tcfg.memory.feature_dim).astype(np.float32)}
    outs = spawn("tests.test_torch_mp_ranks:tp_checkpoint", 4, tmp_path,
                 ckpt_inputs, config=tcfg)
    for o in outs:
        assert o["batch_axes"].tolist() == ["replica", "data"]
        assert int(o["tp_size"]) == 2
        assert int(o["restored_step"]) == 5
        assert bool(o["params_equal"]) and bool(o["mu_equal"])
        assert bool(o["local_equal"]) and o["bank_equal"].all()
        # the file holds the whole parameters, in the unsharded layout
        np.testing.assert_array_equal(o["saved_params"], o["flat"])
        assert o["saved_params"].size == ref.optimizer.flat.numel()
    # 2 shards over ('replica', 'data'); each took its rows of the batch
    # of 4 and of the 8 written rows
    assert [int(o["count"]) for o in outs] == [2 + 4] * 4
