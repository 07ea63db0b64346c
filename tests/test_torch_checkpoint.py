"""The port's checkpoints (`training/checkpoint.py`) and the JAX -> port ->
save -> restore -> next step chain.

- The JAX package's `test_save_restore_roundtrip` on the port at the debug
  preset: parameters equal, bank and string ids equal,
  `retrieve_similar_memories` equal, training continues.
- A JAX `Trainer` trains 3 steps; `models/convert.trainer_from_numpy`
  carries its parameters, optimizer state, step and bank across (equal
  bit for bit, the count that drives the schedule included); both take
  one more step, held with `tests/test_torch_trainer.py`'s tolerances.
  The port trainer is then saved and restored into a fresh one, and the
  next step of the two is equal bit for bit. Dropout is 0, and the
  thalamus and endocrine modulators are off: their last readings, like
  the dropout seed stream, are host state that no checkpoint holds (the
  JAX package's neither), and a fresh trainer starts them anew.
- The file format's guarantees: pruning to `max_to_keep`, a save cut
  short never becomes `latest_step()`, a corrupt or mis-shaped checkpoint
  raises and leaves the trainer as it was, `load_optimizer=False`, and
  every parameter still a view of the optimizer's flat buffer.
The sharded-bank cases of the JAX package's tests are held on gloo ranks
by `tests/test_torch_dp_trainer.py` and, with a 'model' axis of 2,
`tests/test_torch_mp_trainer.py`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.memory.state import MemoryState
from aura_snn_rag_tpu_torch.models.convert import trainer_from_numpy
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_torch_common import highest
from tests.test_torch_trainer import (
    LOSS_RTOL, JTrainer, assert_bank, assert_params, bank, batches,
    configs, first_moment, jax_named, named, run)

torch.set_num_threads(1)

# the chain's configuration: memory and a store at every step, no
# modulator whose reading a fresh trainer would start anew
CHAIN = dict(enable_thalamus=False, enable_endocrine=False,
             memory_store_interval=1)


def debug_config(**training):
    """The JAX package's checkpoint test's config, on the port."""
    cfg = port.get_debug_config()
    return cfg.replace(training=dataclasses.replace(
        cfg.training, **dict(dict(
            batch_size=4, memory_warmup_steps=0, memory_store_interval=1,
            enable_thalamus=False, sleep_interval=10_000,
            eval_steps=10_000), **training)))


def trained(cfg, seed=0, steps=3):
    tr = port.Trainer(cfg, seed=seed, device="cpu")
    rng = np.random.RandomState(0)
    batch = rng.randint(1, 500, (4, 16)).astype(np.int32)
    for _ in range(steps):
        tr.train_step(batch, batch)
    tr.hippocampus.write_batch(
        ["ck-a", "ck-b"], rng.randn(2, cfg.memory.feature_dim)
        .astype(np.float32))
    return tr, batch


def trainer_tensors(tr):
    """Every tensor a checkpoint restores, by name (CPU copies)."""
    count, mu, nu = tr.optimizer.state
    out = {"params": tr.optimizer.flat, "count": count, "mu": mu, "nu": nu}
    out.update({f"memory_state.{n}": t for n, t in
                zip(MemoryState._fields, tr.hippocampus.state)})
    out.update({f"cognitive_map.{i}": t for i, t in
                enumerate(tr.hippocampus.cognitive_map)})
    for name in ("amygdala", "thalamus"):
        mod = getattr(tr, name)
        if mod is not None:
            out.update({f"{name}.{k}": t for k, t in
                        mod.state_dict().items()})
    return {k: v.detach().clone() for k, v in out.items()}


def assert_tensors_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def assert_views_flat(tr):
    flat = tr.optimizer.flat
    lo = flat.data_ptr()
    hi = lo + flat.numel() * flat.element_size()
    for name, p in tr.model.named_parameters():
        assert p.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr(), name
        assert lo <= p.data_ptr() < hi, name


def test_save_restore_roundtrip(tmp_path):
    cfg = debug_config()
    tr, batch = trained(cfg)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(3, tr, loss=1.23)

    tr2 = port.Trainer(cfg, seed=99, device="cpu")
    step = CheckpointManager(str(tmp_path / "ckpt")).restore(tr2)
    assert step == 3 and tr2.state.step == 3
    assert torch.equal(tr.optimizer.flat, tr2.optimizer.flat)
    for (n1, p1), (n2, p2) in zip(tr.model.named_parameters(),
                                  tr2.model.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    assert tr2.hippocampus.memory_count == tr.hippocampus.memory_count
    assert (tr2.hippocampus.host_state_dict()["slot_ids"]
            == tr.hippocampus.host_state_dict()["slot_ids"])
    q = np.random.RandomState(1).randn(cfg.memory.feature_dim) \
        .astype(np.float32)
    got = tr2.hippocampus.retrieve_similar_memories(q, k=3)
    assert got == tr.hippocampus.retrieve_similar_memories(q, k=3)
    assert "ck-a" in [m for m, _ in tr2.hippocampus.retrieve_similar_memories(
        tr.hippocampus.state.features[tr.hippocampus._id_to_slot["ck-a"]],
        k=3)]
    m = tr2.train_step(batch, batch)
    assert np.isfinite(m["loss"])


def test_restore_equals_every_tensor_and_keeps_views(tmp_path):
    """With the thalamus and amygdala on and RAG in the model: every
    tensor, the ids and the step come back bit for bit, into the
    optimizer's buffers in place."""
    cfg = debug_config(enable_thalamus=True)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_rag=True))
    tr, _ = trained(cfg)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(5, tr, loss=0.5)
    tr2 = port.Trainer(cfg, seed=7, device="cpu")
    flat_before = tr2.optimizer.flat
    assert ckpt.restore(tr2) == 5
    assert tr2.optimizer.flat is flat_before
    assert_tensors_equal(trainer_tensors(tr), trainer_tensors(tr2))
    assert_views_flat(tr2)
    assert tr2.hippocampus.host_state_dict()["slot_ids"] == \
        tr.hippocampus.host_state_dict()["slot_ids"]
    # the model reads what the optimizer updates
    with torch.no_grad():
        tr2.optimizer.flat.add_(1.0)
    p = next(tr2.model.parameters())
    assert torch.equal(p, next(tr.model.parameters()) + 1.0)


def test_max_to_keep_prunes_oldest(tmp_path):
    cfg = debug_config()
    tr = port.Trainer(cfg, seed=0, device="cpu")
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4, 5):
        ckpt.save(step, tr)
    assert ckpt.all_steps() == [4, 5] and ckpt.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_4.pt", "ckpt_5.pt", "meta_4.json", "meta_5.json"]


def test_save_cut_short_is_not_latest(tmp_path, monkeypatch):
    cfg = debug_config()
    tr = port.Trainer(cfg, seed=0, device="cpu")
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, tr)

    def cut(payload, f):
        f.write(b"PK\x03\x04 half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(2, tr)
    monkeypatch.undo()
    assert ckpt.latest_step() == 1 and ckpt.all_steps() == [1]
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    # a stray temporary file of another process is no checkpoint either
    (tmp_path / "ckpt_9.pt.tmp-12345").write_bytes(b"partial")
    assert ckpt.latest_step() == 1
    assert CheckpointManager(str(tmp_path)).restore(
        port.Trainer(cfg, seed=3, device="cpu")) == 1


@pytest.mark.parametrize("fault", ["truncated", "missing_meta",
                                   "other_shape"])
def test_bad_checkpoint_raises_and_leaves_trainer(tmp_path, fault):
    cfg = debug_config()
    tr, _ = trained(cfg)
    if fault == "other_shape":     # a checkpoint of another bank size
        other = cfg.replace(memory=dataclasses.replace(
            cfg.memory, max_memories=512))
        src, _ = trained(other, seed=1)
    else:
        src = tr
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(4, src)
    if fault == "truncated":
        path = ckpt.path(4)
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
    elif fault == "missing_meta":
        os.remove(ckpt.meta_path(4))
    target = port.Trainer(cfg, seed=5, device="cpu")
    before = trainer_tensors(target)
    ids_before = target.hippocampus.host_state_dict()["slot_ids"]
    with pytest.raises((RuntimeError, ValueError, OSError)):
        ckpt.restore(target)
    assert_tensors_equal(before, trainer_tensors(target))
    assert target.hippocampus.host_state_dict()["slot_ids"] == ids_before
    assert target.state.step == 0


def test_restore_without_optimizer(tmp_path):
    cfg = debug_config()
    tr, _ = trained(cfg)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(3, tr)
    tr2 = port.Trainer(cfg, seed=8, device="cpu")
    assert ckpt.restore(tr2, step=3, load_optimizer=False) == 3
    assert torch.equal(tr2.optimizer.flat, tr.optimizer.flat)
    count, mu, nu = tr2.optimizer.state
    assert int(count) == 0 and not mu.any() and not nu.any()
    assert int(tr.optimizer.state.count) == 3
    assert_views_flat(tr2)


def test_empty_directory_restores_nothing(tmp_path):
    tr = port.Trainer(debug_config(), seed=0, device="cpu")
    assert CheckpointManager(str(tmp_path / "new")).restore(tr) == 0
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "new")).restore(tr, step=3)


def test_jax_to_port_to_checkpoint_chain(tmp_path):
    jcfg, tcfg = configs(**CHAIN)
    with highest():
        jt = JTrainer(jcfg, seed=0)
    jt.hippocampus.state = jax.tree.map(jnp.asarray, bank())
    ids = batches(7, 5)
    for x in ids[:3]:
        with highest():
            jt.train_step(x, x)

    tree = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    tt = trainer_from_numpy(
        tcfg, tree(jt.state.params), tree(jt.amygdala_params), None,
        tree(jt.hippocampus.state), device="cpu",
        opt_state=tree(jt.state.opt_state), step=int(jt.state.step))
    # carried across bit for bit
    assert tt.state.step == 3 and int(tt.optimizer.state.count) == 3
    for j, t in ((jt.state.params, tt.optimizer.flat),
                 (jt.state.opt_state[1][0].mu, tt.optimizer.state.mu),
                 (jt.state.opt_state[1][0].nu, tt.optimizer.state.nu)):
        want = jax_named(tcfg, j)
        got = named(tt, t)
        for name in want:
            np.testing.assert_array_equal(got[name].detach().numpy(),
                                          want[name], err_msg=name)
    assert_bank(jt, tt)

    # one more step on both: the resumed schedule and moments. Both
    # trainers report a step's metrics one step late, the fresh port
    # trainer its own at its first step: compare each step's own.
    (jm, tm), = run(jt, tt, ids[3:4])
    assert jm["step"] == tm["step"] == 3
    assert jm["use_memory"] and tm["use_memory"]
    want = np.asarray(jt._pending_metrics)
    got = tt.latest_metrics()
    np.testing.assert_allclose(got["loss"], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["ce"], want[1], rtol=LOSS_RTOL)
    jmu, tmu = first_moment(jt, tt)
    assert_params(jt, tt, jmu, tmu, 1)
    assert_bank(jt, tt)

    # save, restore into a fresh trainer, and the next step is the same
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(4, tt, loss=tt.latest_metrics()["loss"])
    tr = port.Trainer(tcfg, seed=99, device="cpu")
    assert ckpt.restore(tr) == 4
    assert_tensors_equal(trainer_tensors(tt), trainer_tensors(tr))
    tt.train_step(ids[4], ids[4])
    tr.train_step(ids[4], ids[4])
    assert tt.latest_metrics() == tr.latest_metrics()
    assert_tensors_equal(trainer_tensors(tt), trainer_tensors(tr))
    assert tt.state.step == tr.state.step == 5


def test_opt_state_counts_must_agree():
    jcfg, tcfg = configs(**CHAIN)
    with highest():
        jt = JTrainer(jcfg, seed=0)
    opt = jax.tree.map(np.asarray, jt.state.opt_state)
    adam, *rest = opt[1]
    bad = (opt[0], (adam._replace(count=np.asarray(5, np.int32)), *rest))
    with pytest.raises(ValueError, match="counts disagree"):
        trainer_from_numpy(tcfg, jax.tree.map(np.asarray, jt.state.params),
                           jax.tree.map(np.asarray, jt.amygdala_params),
                           device="cpu", opt_state=bad)
