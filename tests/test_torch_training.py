"""The port's training pieces against the JAX package's: the loss, the LR
schedule, the optimizer (optax's clip + adamw chain), dropout and remat,
the tokenizer and the data loaders. Inputs are made with numpy from a
seed and fed to both; JAX runs under
`jax.default_matmul_precision("highest")`. The trainer as a whole is in
`test_torch_trainer.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.training import data as jdata
from aura_snn_rag_tpu.training import tokenizer as jtok
from aura_snn_rag_tpu.training.losses import (
    hippocampal_loss as jloss, perplexity as jperplexity)
from aura_snn_rag_tpu.training.schedule import (
    warmup_cosine_schedule as jschedule)
from aura_snn_rag_tpu_torch.models.layers import Dropout
from aura_snn_rag_tpu_torch.training import data as tdata
from aura_snn_rag_tpu_torch.training import tokenizer as ttok
from aura_snn_rag_tpu_torch.training.losses import (
    hippocampal_loss as tloss, perplexity as tperplexity)
from aura_snn_rag_tpu_torch.training.optim import ClippedAdamW
from aura_snn_rag_tpu_torch.training.schedule import (
    warmup_cosine_schedule as tschedule)
from tests.test_torch_common import bank_pair, highest, queries_near

torch.set_num_threads(1)

# f32 reductions over the vocabulary in another order
LOSS_TOL = 2e-6


def test_training_config_fields_defaults_and_presets_match():
    jf = {f.name: f.default for f in
          dataclasses.fields(jconfig.TrainingConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(port.TrainingConfig)}
    assert jf == tf
    for name in ("get_debug_config", "get_test_config", "get_small_config",
                 "get_medium_config", "get_full_config", "get_xl_config"):
        assert (dataclasses.asdict(getattr(jconfig, name)().training)
                == dataclasses.asdict(getattr(port, name)().training)), name


@pytest.mark.parametrize("smoothing,entropy,sparsity,masked", [
    (0.1, 0.05, 0.02, True),
    (0.0, 0.0, 0.0, False),
    (0.2, 0.0, 0.1, True),
    (0.0, 0.3, 0.0, True),
])
def test_hippocampal_loss_value_and_gradient_match(smoothing, entropy,
                                                   sparsity, masked):
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 7, 33) * 3).astype(np.float32)
    labels = rng.randint(0, 33, (2, 7)).astype(np.int32)
    if masked:
        labels[0, :3] = -100
        labels[1, 6] = -100
    place = rng.rand(2, 7, 16).astype(np.float32) * 0.2
    kw = dict(label_smoothing=smoothing, entropy_lambda=entropy,
              sparsity_lambda=sparsity, target_sparsity=0.03)

    def jf(lg, pl):
        return jloss(lg, jnp.asarray(labels), pl, **kw)
    with highest():
        jv, (jgl, jgp) = jax.value_and_grad(jf, argnums=(0, 1))(
            jnp.asarray(logits), jnp.asarray(place))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tp = torch.from_numpy(place).requires_grad_(True)
    tv = tloss(tl, torch.from_numpy(labels), tp, **kw)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), rtol=0,
                               atol=LOSS_TOL)
    tgp = np.zeros_like(place) if tp.grad is None else tp.grad.numpy()
    assert (tp.grad is None) == (sparsity == 0)
    np.testing.assert_allclose(tgp, np.asarray(jgp), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(float(tperplexity(tv.detach())),
                               float(jperplexity(jv)), rtol=1e-6)


def test_hippocampal_loss_all_ignored_is_finite():
    labels = np.full((1, 4), -100, np.int32)
    logits = np.random.RandomState(0).randn(1, 4, 9).astype(np.float32)
    jv = float(jloss(jnp.asarray(logits), jnp.asarray(labels)))
    tv = float(tloss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert np.isfinite(tv) and tv == pytest.approx(jv, abs=1e-6)


@pytest.mark.parametrize("lr,warmup,max_steps,ratio", [
    (1e-4, 5, 40, 0.1),      # warmup then cosine to 10%
    (3e-3, 0, 12, 0.0),      # warmup clamped up to 1
    (1e-3, 50, 20, 0.5),     # warmup clamped down to max_steps - 1
    (2e-4, 2, 1, 0.1),       # max_steps clamped up to 2
])
def test_schedule_matches_optax_at_every_step(lr, warmup, max_steps, ratio):
    js, ts = jschedule(lr, warmup, max_steps, ratio), tschedule(
        lr, warmup, max_steps, ratio)
    steps = np.arange(max_steps + 5)
    want = np.asarray([float(js(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.asarray([float(ts(int(s))) for s in steps])
    # f32 cos and divisions in another library: within an ulp of lr
    np.testing.assert_allclose(got, want, rtol=0, atol=lr * 2e-7)
    assert got[0] == 0.0
    got_t = ts(torch.arange(max_steps + 5, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got_t, got.astype(np.float32))


def _optax_chain(schedule, wd, clip, mu_dtype):
    return optax.chain(
        optax.clip_by_global_norm(clip),
        optax.adamw(schedule, weight_decay=wd,
                    mu_dtype=jnp.bfloat16 if mu_dtype == "bfloat16"
                    else None))


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_optimizer_matches_optax_chain(mu_dtype):
    """Three updates with clipping active (global norm ~ 30 > 1), an
    LR scale, a non-finite loss that must change nothing, then a fourth
    update."""
    rng = np.random.RandomState(5)
    shapes = [(4, 6), (6,), (), (3, 2, 5)]
    p0 = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    grads = [[np.asarray(rng.randn(*s) * 5, np.float32) for s in shapes]
             for _ in range(4)]
    losses = [1.0, 2.0, float("nan"), 0.5]
    scales = [1.0, 1.05, 1.0, 0.93]
    sched_args = (1e-2, 2, 10, 0.1)
    tx = _optax_chain(jschedule(*sched_args), 0.01, 1.0, mu_dtype)
    jp = [jnp.asarray(x) for x in p0]
    st = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = ClippedAdamW(params, tschedule(*sched_args), 0.01, 1.0, mu_dtype)
    for g, loss, scale in zip(grads, losses, scales):
        with highest():
            upd, new_st = tx.update([jnp.asarray(x) for x in g], st, jp)
            new_p = optax.apply_updates(
                jp, jax.tree.map(lambda u: u * jnp.float32(scale), upd))
            finite = jnp.isfinite(jnp.float32(loss))
            jp = jax.tree.map(lambda n, o: jnp.where(finite, n, o),
                              new_p, jp)
            st = jax.tree.map(lambda n, o: jnp.where(finite, n, o),
                              new_st, st)
        if not np.isfinite(loss):
            g = [np.full_like(x, np.nan) for x in g]
        opt.zero_grad()
        for p, x in zip(params, g):
            p.grad.copy_(torch.from_numpy(x))
        opt.step(torch.tensor(loss), scale)
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=0, atol=2e-7)
        adam = st[1][0]
        assert int(opt.state.count) == int(adam.count)
        mu = torch.cat([m.reshape(-1) for m in
                        (torch.from_numpy(np.asarray(x, np.float32))
                         for x in adam.mu)])
        nu = np.concatenate([np.asarray(x).reshape(-1) for x in adam.nu])
        assert opt.state.mu.dtype == (torch.bfloat16 if mu_dtype ==
                                      "bfloat16" else torch.float32)
        np.testing.assert_allclose(opt.state.mu.float().numpy(), mu.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(opt.state.nu.numpy(), nu, rtol=1e-6,
                                   atol=0)
    assert int(opt.state.count) == 3


def test_optimizer_parameters_view_one_flat_buffer():
    lin = torch.nn.Linear(3, 2)
    opt = ClippedAdamW(lin.parameters(), tschedule(1e-3, 1, 10))
    x = torch.randn(4, 3)
    for _ in range(2):                       # two micro-batches accumulate
        lin(x).sum().backward()
    assert lin.weight.data_ptr() == opt.flat.data_ptr()
    assert lin.weight.grad.data_ptr() == opt.grad.data_ptr()
    np.testing.assert_allclose(lin.bias.grad.numpy(), [8.0, 8.0])


def test_dropout_statistics_and_identity():
    x = torch.ones(1000, 1000)
    d = Dropout(0.1)
    y = d(x, dropout_seed=3)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 3e-3
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.9, rtol=1e-6)
    assert torch.equal(y, d(x, dropout_seed=3))           # same seed
    assert not torch.equal(y, d(x, dropout_seed=4))
    d2 = Dropout(0.1)
    d2.site = 1
    assert not torch.equal(y, d2(x, dropout_seed=3))      # other site
    assert torch.equal(d(x), x)                           # no seed
    d.eval()
    assert torch.equal(d(x, dropout_seed=3), x)           # eval mode
    # bf16: divided by bf16(0.9) = 0.8984375, as JAX's weak-typed constant
    yb = Dropout(0.1)(x.to(torch.bfloat16), dropout_seed=3)
    assert yb.dtype == torch.bfloat16
    assert set(yb.float().unique().tolist()) == {
        0.0, float(torch.tensor(1.0, dtype=torch.bfloat16)
                   / torch.tensor(0.9, dtype=torch.bfloat16))}


LM = dict(vocab_size=256, embedding_dim=128, num_layers=2, num_heads=4,
          intermediate_size=256, max_seq_len=512, n_place_cells=128,
          snn_layers=(0,), dtype="float32", use_rag=True, dropout=0.1)


def _grads(model, ids, state, seed):
    for p in model.parameters():
        p.grad = None
    out, _ = model(ids, memory_state=state, dropout_seed=seed)
    (out.logits.square().mean() + out.memory_summary.sum()).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}, out.logits.detach()


def test_model_dropout_in_training_mode_only():
    _, tcfg, _, ts, _ = bank_pair("bf16")
    cfg = port.ModelConfig(**LM)
    model = port.HippocampalTransformer(cfg, tcfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 12)))
    with torch.no_grad():
        a = model(ids, memory_state=ts, dropout_seed=1)[0].logits
        b = model(ids, memory_state=ts, dropout_seed=1)[0].logits
        c = model(ids, memory_state=ts, dropout_seed=2)[0].logits
        plain = model(ids, memory_state=ts)[0].logits
        model.eval()
        ev = model(ids, memory_state=ts, dropout_seed=1)[0].logits
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain) and torch.equal(ev, plain)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat(policy, monkeypatch):
    """Both policies recompute each layer, dropout masks and kernel B's
    retrieval included, and give the same gradients bit for bit."""
    _, tcfg, _, ts, feats = bank_pair("bf16")
    cfg = port.ModelConfig(**LM)
    base = port.HippocampalTransformer(cfg, tcfg, device="cpu")
    remat = port.HippocampalTransformer(
        dataclasses.replace(cfg, use_gradient_checkpointing=True,
                            gradient_checkpoint_policy=policy), tcfg,
        device="cpu")
    remat.load_state_dict(base.state_dict())
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 12)))
    from aura_snn_rag_tpu_torch.memory import engine as tengine
    calls = []
    real = tengine.ivf_retrieve_fused

    def counted(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(tengine, "ivf_retrieve_fused", counted)
    g0, l0 = _grads(base, ids, ts, 9)
    n_base = len(calls)
    g1, l1 = _grads(remat, ids, ts, 9)
    assert n_base == 2 and len(calls) - n_base == 4   # forward + recompute
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    assert g0["layers.1.query_proj.weight"].abs().sum() > 0
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


# --------------------------------------------------------------------------
# tokenizer and data
# --------------------------------------------------------------------------

def test_byte_tokenizer_matches():
    text = "Hippocampal replay — sleep, wake; ünïcode ✓"
    jt, tt = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    for special in (False, True):
        assert (tt.encode(text, add_special_tokens=special)
                == jt.encode(text, add_special_tokens=special))
    ids = tt.encode(text, add_special_tokens=True)
    assert tt.decode(ids) == jt.decode(ids) == text
    assert tt(text) == jt(text)
    assert tt.vocab_size == jt.vocab_size == 259


def test_tokenize_file_matches(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("the quick brown fox jumps over the lazy dog. " * 40)
    for kw in (dict(seq_len=32), dict(seq_len=16, max_sequences=5)):
        np.testing.assert_array_equal(ttok.tokenize_file(str(path), **kw),
                                      jtok.tokenize_file(str(path), **kw))


def test_synthesize_and_load_match(tmp_path):
    jm = jconfig.ModelConfig(vocab_size=300, max_seq_len=24)
    tm = port.ModelConfig(vocab_size=300, max_seq_len=24)
    want = jdata.synthesize_sequences(jm, 20, seed=4)
    got = tdata.synthesize_sequences(tm, 20, seed=4)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    seqs = np.random.RandomState(1).randint(0, 999, (6, 24))
    np.save(tmp_path / "a.npy", seqs)
    np.savez(tmp_path / "b.npz", sequences=seqs)
    for name in ("a.npy", "b.npz"):
        p = str(tmp_path / name)
        np.testing.assert_array_equal(tdata.load_token_file(p),
                                      jdata.load_token_file(p))
        np.testing.assert_array_equal(tdata.load_or_synthesize(p, tm),
                                      jdata.load_or_synthesize(p, jm))
    missing = str(tmp_path / "missing.npy")
    np.testing.assert_array_equal(tdata.load_or_synthesize(missing, tm, 2),
                                  jdata.load_or_synthesize(missing, jm, 2))


def test_batch_iterator_and_token_stream_match(tmp_path):
    seqs = np.arange(7 * 5).reshape(7, 5)
    ti, ji = tdata.batch_iterator(seqs, 3, seed=2), jdata.batch_iterator(
        seqs, 3, seed=2)
    for _ in range(5):
        np.testing.assert_array_equal(next(ti), next(ji))
    np.save(tmp_path / "stream.npy",
            np.random.RandomState(0).randint(0, 60000, 5000).astype(
                np.uint16))
    path = str(tmp_path / "stream.npy")
    ts, js = tdata.TokenStream(path, 32, seed=3), jdata.TokenStream(
        path, 32, seed=3)
    np.testing.assert_array_equal(ts.sample_batch(4), js.sample_batch(4))
    np.testing.assert_array_equal(ts.sample_chunk(3, 2), js.sample_chunk(3, 2))
    for a, b in zip(ts.eval_batches(4, 3), js.eval_batches(4, 3)):
        np.testing.assert_array_equal(a, b)


def test_mesh_and_parallel_config_match():
    """`MeshConfig`, `ParallelConfig` and the whole `AuraConfig` carry the
    JAX package's fields and defaults."""
    for name in ("MeshConfig", "ParallelConfig"):
        jf = {f.name: f.default for f in
              dataclasses.fields(getattr(jconfig, name))}
        tf = {f.name: f.default for f in
              dataclasses.fields(getattr(port.config, name))}
        assert jf == tf, name
    assert ([f.name for f in dataclasses.fields(jconfig.AuraConfig)]
            == [f.name for f in dataclasses.fields(port.AuraConfig)])
    assert (dataclasses.asdict(jconfig.AuraConfig().mesh)
            == dataclasses.asdict(port.AuraConfig().mesh))
    assert (dataclasses.asdict(jconfig.AuraConfig().parallel)
            == dataclasses.asdict(port.AuraConfig().parallel))


# the JAX package's tests/training/test_data_stream.py, on the port's
# TokenStream over the same file


@pytest.fixture()
def token_streams(tmp_path):
    toks = np.arange(10_000, dtype=np.uint16) % 31_000
    path = tmp_path / "train.npy"
    np.save(path, toks)
    return (tdata.TokenStream(str(path), seq_len=64, seed=0),
            jdata.TokenStream(str(path), seq_len=64, seed=0))


def test_token_stream_batch_shapes_and_bounds(token_streams):
    ts, js = token_streams
    b = ts.sample_batch(8)
    assert b.shape == (8, 64) and b.dtype == np.int32
    assert b.min() >= 0 and b.max() < 31_000
    np.testing.assert_array_equal(b, js.sample_batch(8))


def test_token_stream_windows_are_contiguous(token_streams):
    b = token_streams[0].sample_batch(4)
    diffs = np.diff(b.astype(np.int64), axis=1) % 31_000
    assert (diffs == 1).all()


def test_token_stream_chunk_shape(token_streams):
    ts, js = token_streams
    c = ts.sample_chunk(5, 4)
    assert c.shape == (5, 4, 64)
    np.testing.assert_array_equal(c, js.sample_chunk(5, 4))


def test_token_stream_eval_batches_deterministic(token_streams):
    ts = token_streams[0]
    a = list(ts.eval_batches(2, max_batches=3))
    b = list(ts.eval_batches(2, max_batches=3))
    assert len(a) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_token_stream_short_stream_rejected(tmp_path):
    np.save(tmp_path / "s.npy", np.arange(10, dtype=np.uint16))
    for package in (tdata, jdata):
        with pytest.raises(AssertionError):
            package.TokenStream(str(tmp_path / "s.npy"), seq_len=64)
