"""The port's `Trainer` against the JAX package's, from the same weights.

A small LM (2 layers, width 128, SNN FFN on layer 0, RAG in both layers,
f32 compute, dropout 0) over a prefilled, rebuilt and decayed bank of
M = 16,384 x 128 (K = 128, probe 4, C = 256): the config's batches of 4
(micro-batches of 2 under accumulation) take IVF v3r, kernel B's plain
version in the port and the XLA path in the JAX package (kernel B's
Pallas version has no VJP). The JAX `Trainer` initialises the weights;
`models/convert.trainer_from_numpy` builds the port's from its trees.
Each case runs 3 `train_step`s on both and compares:
- the losses the steps report, within LOSS_RTOL;
- the first step's gradients, through AdamW's first moment after that
  step (0.1 x the clipped gradient in both), within GRAD_TOL of each
  tensor's largest entry, or of GRAD_FLOOR x the model's largest where
  that is larger: a gradient that is zero in exact arithmetic (the key
  projections' biases: softmax ignores a shift of every key) is f32
  cancellation noise ~1e-8 of the model's largest;
- the parameters, element by element within PARAM_ATOL plus
  3 x 2 x lr x min(1, noise / |g1|): Adam turns a gradient that is
  nothing but rounding noise into a full step of either sign, so an
  element may move by up to ~2 lr per step where its first-step gradient
  sits at the noise level (`noise` = 10x the tensor's largest gradient
  difference) and by a proportionally smaller amount elsewhere;
- the bank after the steps' writes.
The JAX trainers are built once per module (lru_cache); JAX runs under
`jax.default_matmul_precision("highest")`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.memory import state as jstate
from aura_snn_rag_tpu.training.trainer import Trainer as JTrainer
from aura_snn_rag_tpu_torch.memory import engine as tengine
from aura_snn_rag_tpu_torch.memory import state as tstate
from aura_snn_rag_tpu_torch.models.convert import (
    params_from_numpy, trainer_from_numpy)
from tests.test_torch_common import highest, make_data

torch.set_num_threads(1)

LM = dict(vocab_size=256, embedding_dim=128, num_layers=2, num_heads=4,
          intermediate_size=256, max_seq_len=512, n_place_cells=128,
          snn_layers=(0,), dtype="float32", dropout=0.0, use_rag=True)
MEM = dict(max_memories=16_384, feature_dim=128, k_centroids=128,
           probe_centroids=4, n_place_cells=16, n_grid_cells=8,
           n_time_cells=4)
TRAIN = dict(batch_size=4, max_steps=100, warmup_steps=2, lr=1e-3,
             memory_warmup_steps=0)
B, L, N_STEPS = 4, 16, 3
LR = TRAIN["lr"]
LOSS_RTOL = 2e-6        # f32 model parity: logits agree within ~3e-5
GRAD_TOL = 2e-4         # of each tensor's largest first-step gradient,
GRAD_FLOOR = 1e-3       # or of this fraction of the model's largest
PARAM_ATOL = 1e-6
BANK_ATOL = 1e-5        # written rows are f32 hidden means


def configs(lm=(), **train):
    m, t = dict(LM, **dict(lm)), dict(TRAIN, **train)
    return (jconfig.AuraConfig(model=jconfig.ModelConfig(**m),
                               memory=jconfig.MemoryConfig(**MEM),
                               training=jconfig.TrainingConfig(**t)),
            port.AuraConfig(model=port.ModelConfig(**m),
                            memory=port.MemoryConfig(**MEM),
                            training=port.TrainingConfig(**t)))


@functools.lru_cache(maxsize=None)
def bank():
    """16,000 clustered rows, rebuilt, decayed once (strength != 1)."""
    jcfg, _ = configs()
    feats = make_data(21, 16_000)
    with highest():
        st = jstate.init_memory_state(jcfg.memory)
        st = jengine.bulk_load(jcfg.memory, st, jnp.asarray(feats),
                               jnp.zeros((16_000, 2), jnp.float32))
        st = jengine.rebuild_centroids(jcfg.memory, st,
                                       jax.random.PRNGKey(3))
        st = jengine.decay_memories(st, 0.05)
    return jax.tree.map(np.asarray, st)


def batches(seed, n=N_STEPS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, LM["vocab_size"], (B, L)).astype(np.int32)
            for _ in range(n)]


def pair(lm=(), **train):
    """A JAX trainer and the port's from its trees, both on `bank()`."""
    jcfg, tcfg = configs(lm, **train)
    with highest():
        jt = JTrainer(jcfg, seed=0)
    jt.hippocampus.state = jax.tree.map(jnp.asarray, bank())
    tree = lambda t: None if t is None else jax.tree.map(np.asarray, t)
    tt = trainer_from_numpy(tcfg, tree(jt.state.params),
                            tree(jt.amygdala_params),
                            tree(jt.thalamus_params), bank(), device="cpu")
    return jt, tt


def run(jt, tt, ids_list, labels_list=None):
    labels_list = labels_list or ids_list
    out = []
    for ids, labels in zip(ids_list, labels_list):
        with highest():
            jm = jt.train_step(ids, labels)
        out.append((jm, tt.train_step(ids, labels)))
    return out


def named(tt, flat):
    """{parameter name: its slice of a flat buffer (parameters, moments)}."""
    base = tt.optimizer.flat.data_ptr()
    out = {}
    for name, p in tt.model.named_parameters():
        off = (p.data_ptr() - base) // 4
        out[name] = flat[off:off + p.numel()].view(p.shape).float()
    return out


def jax_named(tcfg, tree):
    return {k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, tree), tcfg.model, tcfg.memory).items()}


def first_moment(jt, tt):
    return (jax_named(tt.config, jt.state.opt_state[1][0].mu),
            {k: v.numpy() for k, v in named(tt, tt.optimizer.state.mu)
             .items()})


def assert_first_step_grads(jmu, tmu):
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in jmu.values())
    for name, want in jmu.items():
        scale = max(np.abs(want).max(), floor)
        np.testing.assert_allclose(tmu[name], want, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def assert_params(jt, tt, jmu, tmu, n_steps):
    want = jax_named(tt.config, jt.state.params)
    got = {k: v.detach().numpy() for k, v in named(
        tt, tt.optimizer.flat).items()}
    for name in want:
        g1 = np.abs(jmu[name])
        noise = max(10 * np.abs(jmu[name] - tmu[name]).max(), 1e-12)
        tol = PARAM_ATOL + n_steps * 2 * LR * np.minimum(
            1.0, noise / np.maximum(g1, 1e-30))
        diff = np.abs(got[name] - want[name])
        assert (diff <= tol).all(), (name, diff.max(), tol[diff > tol][:4])


def assert_bank(jt, tt):
    js = jstate.MemoryState(*[np.asarray(jnp.asarray(x).astype(jnp.float32))
                              if x.dtype == jnp.bfloat16 else np.asarray(x)
                              for x in jt.hippocampus.state])
    ts = tstate.state_to_numpy(tt.hippocampus.state)
    for name, a, b in zip(jstate.MemoryState._fields, js, ts):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=BANK_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def assert_losses(ms):
    for jm, tm in ms:
        assert jm["use_memory"] == tm["use_memory"]
        assert jm["step"] == tm["step"]
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["ce"], jm["ce"], rtol=LOSS_RTOL)


def _first_step(jt, tt, ids):
    ms = run(jt, tt, ids[:1])
    jmu, tmu = first_moment(jt, tt)
    assert_first_step_grads(jmu, tmu)
    return ms, jmu, tmu


@pytest.mark.parametrize("case", ["modulated", "memory_every_step",
                                  "accumulate_2"])
def test_train_steps_match_jax(case, monkeypatch):
    """"modulated": the config's gates (thalamus and endocrine on): memory
    and a store at step 0, then the thalamus gate (0.5 at these
    embeddings) turns memory off, in both. Otherwise memory and a store
    at every step, once on the whole batch and once over 2
    micro-batches. The accumulation case runs without the SNN FFN: on
    these inputs the JAX package's scanned micro-batches flip a GIF spike
    level against its own whole-batch step (a last-bit difference before
    `floor`; loss 5.314569 against 5.314588), which moves the small
    gradients of layer 1's attention by ~10%;
    `test_accumulation_equals_whole_batch` covers the port's accumulation
    with the SNN FFN."""
    kw = {"modulated": {},
          "memory_every_step": dict(enable_thalamus=False,
                                    memory_store_interval=1),
          "accumulate_2": dict(enable_thalamus=False,
                               memory_store_interval=1,
                               gradient_accumulation_steps=2,
                               lm=dict(snn_layers=()))}[case]
    jt, tt = pair(**kw)
    calls = []
    real = tengine.ivf_retrieve_fused

    def counted(*a):
        calls.append(a[3].shape[0])
        return real(*a)
    monkeypatch.setattr(tengine, "ivf_retrieve_fused", counted)
    ids = batches(1)
    count0 = int(tt.hippocampus.state.count)
    ms, jmu, tmu = _first_step(jt, tt, ids)
    ms += run(jt, tt, ids[1:])
    assert_losses(ms)
    assert_params(jt, tt, jmu, tmu, N_STEPS)
    assert_bank(jt, tt)
    on = [tm["use_memory"] for _, tm in ms]
    mb = B // (2 if case == "accumulate_2" else 1)
    assert on == ([True, False, False] if case == "modulated"
                  else [True] * 3)
    # kernel B (its plain version here) in both layers of every micro-batch
    assert calls == [mb] * (2 * (B // mb) * sum(on))
    assert int(tt.hippocampus.state.count) - count0 == (
        B if case == "modulated" else B * N_STEPS)
    for i in range(LM["num_layers"]):
        assert np.abs(tmu[f"layers.{i}.query_proj.weight"]).max() > 0


def test_accumulation_equals_whole_batch():
    """Two micro-batches of 2 give the whole batch's gradient (the mean of
    the micro-batch means, equal here: every micro-batch has the same
    number of labelled positions), loss and bank, with the SNN FFN."""
    _, whole = pair(enable_thalamus=False, memory_store_interval=1)
    _, accum = pair(enable_thalamus=False, memory_store_interval=1,
                    gradient_accumulation_steps=2)
    ids = batches(6, 1)[0]
    mw, ma = whole.train_step(ids, ids), accum.train_step(ids, ids)
    np.testing.assert_allclose(ma["loss"], mw["loss"], rtol=LOSS_RTOL)
    gw, ga = whole.optimizer.grad.numpy(), accum.optimizer.grad.numpy()
    np.testing.assert_allclose(ga, gw, rtol=0,
                               atol=GRAD_TOL * np.abs(gw).max())
    for a, b in zip(whole.hippocampus.state, accum.hippocampus.state):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=0, atol=BANK_ATOL)


def test_sleep_phase_matches_jax():
    """Sleep at step 2: two time-reversed replays of sampled batches (the
    same numpy RandomState picks them), memory off, EWC off."""
    jt, tt = pair(enable_thalamus=False, sleep_interval=2,
                  sleep_replay_batches=2)
    ids = batches(2)
    labels = [np.where(np.arange(L) % 5 == 0, -100, x) for x in ids]
    ms, jmu, tmu = _first_step(jt, tt, ids)
    ms += run(jt, tt, ids[1:], labels[1:])
    assert_losses(ms)
    assert tt.state.step == int(jt.state.step) == N_STEPS + 2
    assert_params(jt, tt, jmu, tmu, N_STEPS + 2)
    assert_bank(jt, tt)


def test_ewc_matches_jax():
    """Fisher from two validation batches through the live memory gate
    after the first step, then two steps with the penalty (lambda 50, so
    it matters)."""
    jt, tt = pair(enable_thalamus=False, ewc_lambda=50.0,
                  memory_store_interval=1)
    ids = batches(3, N_STEPS + 2)
    ms, jmu, tmu = _first_step(jt, tt, ids)
    val = [(x, x) for x in ids[N_STEPS:]]
    with highest():
        jt.consolidate_ewc(val)
    tt.consolidate_ewc(val)
    jf = jax_named(tt.config, jt.ewc.fisher)
    tf = named(tt, tt.ewc.fisher)
    for name, want in jf.items():
        np.testing.assert_allclose(tf[name].numpy(), want, rtol=0,
                                   atol=2 * GRAD_TOL * np.abs(want).max()
                                   + 1e-12, err_msg=name)
    ms += run(jt, tt, ids[1:N_STEPS])
    assert_losses(ms)
    assert_params(jt, tt, jmu, tmu, N_STEPS)
    assert_bank(jt, tt)


def test_train_chunk_equals_train_steps_and_matches_jax():
    """The port's train_chunk over 3 steps equals its 3 train_steps bit
    for bit (the gates stay on, the LR scale at 1, and the sleep boundary
    at 2 is crossed after the last step either way), and matches the JAX
    package's train_chunk."""
    kw = dict(enable_thalamus=False, memory_store_interval=2,
              sleep_interval=2, sleep_replay_batches=1)
    jt, tt = pair(**kw)
    _, tt_steps = pair(**kw)
    ids = np.stack(batches(4))
    with highest():
        jm = jt.train_chunk(ids, ids)
    tm = tt.train_chunk(ids, ids)
    for x in ids:
        tt_steps.train_step(x, x)
    assert torch.equal(tt.optimizer.flat, tt_steps.optimizer.flat)
    assert torch.equal(tt.optimizer.state.mu, tt_steps.optimizer.state.mu)
    for a, b in zip(tt.hippocampus.state, tt_steps.hippocampus.state):
        assert torch.equal(a, b)
    assert tt.state.step == tt_steps.state.step == N_STEPS + 1
    assert jm["use_memory"] and tm["use_memory"]
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"],
                               rtol=LOSS_RTOL)
    want = jax_named(tt.config, jt.state.params)
    got = named(tt, tt.optimizer.flat)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name],
                                   rtol=0, atol=2 * (N_STEPS + 1) * LR,
                                   err_msg=name)
    assert_bank(jt, tt)


class _ModelParallelMesh:
    """A ('data', 'seq') mesh of (1, 3) as far as `shard_to_mesh` reads
    it before it places anything: 3 sequence shards, which divide no
    power-of-two `max_seq_len`."""
    mesh_dim_names = ("data", "seq")

    def size(self, dim):
        return 3 if dim == 1 else 1


def test_eval_loss_and_state_match_jax():
    jt, tt = pair()
    ids = batches(5, 1)[0]
    with highest():
        want = jt.eval_loss(ids, ids)
    assert tt.eval_loss(ids, ids) == pytest.approx(want, rel=LOSS_RTOL)
    st = tt.state
    assert st.step == 0 and st.params is tt.optimizer.flat
    assert int(st.opt_state.count) == 0
    with pytest.raises(ValueError, match="does not divide"):
        tt.shard_to_mesh(_ModelParallelMesh())
    assert tt.mesh is None
    with pytest.raises(RuntimeError, match="no step"):
        tt.latest_metrics()
    tt.train_step(ids, ids)
    assert tt.latest_metrics()["loss"] == tt.history["loss"][0]


def test_trainer_defaults_to_cuda():
    _, tcfg = configs()
    if torch.cuda.is_available():
        assert port.Trainer(tcfg).model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.Trainer(tcfg)


# the JAX package's tests/training/test_grad_accum.py:70-100, on the
# port's trainer at the same debug configuration


def accum_trainer(accum, seed=0):
    cfg = port.get_debug_config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=0.0),
        training=dataclasses.replace(
            cfg.training, gradient_accumulation_steps=accum, batch_size=8,
            memory_warmup_steps=0, memory_store_interval=1,
            sparsity_lambda=0.0, sleep_interval=10_000, eval_steps=10_000))
    return port.Trainer(cfg, seed=seed, device="cpu")


@functools.lru_cache(maxsize=None)
def accum_data():
    rng = np.random.RandomState(7)
    return (rng.randint(1, 500, (8, 16)).astype(np.int32),
            rng.randint(1, 500, (8, 16)).astype(np.int32))


def test_accumulation_uses_labels_not_inputs():
    """Same inputs, other labels: other accumulated updates."""
    ids, labels = accum_data()
    a, b = accum_trainer(4, seed=3), accum_trainer(4, seed=3)
    for _ in range(3):
        a.train_step(ids, labels)
        b.train_step(ids, np.roll(labels, 3, axis=1))
    assert (a.optimizer.flat - b.optimizer.flat).abs().max() > 1e-5


def test_accumulated_training_converges():
    ids, _ = accum_data()
    tr = accum_trainer(2)
    losses = [tr.train_step(ids, ids)["loss"] for _ in range(8)]
    assert all(np.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]


def test_accumulated_memory_writes_land():
    """A store per optimizer step: every micro-batch's summaries write."""
    ids, _ = accum_data()
    tr = accum_trainer(2)
    for _ in range(3):
        tr.train_step(ids, ids)
    assert tr.hippocampus.memory_count >= ids.shape[0]
