"""The port's LM (`aura_snn_rag_tpu_torch.models`) against the JAX package's.

Every module of `models/layers.py` and the whole `HippocampalTransformer`
/ `SNNRAGTransformer` at a small size (2 layers, width 128, 4 heads, SNN
FFN on layer 0): flax initialises the weights, `models/convert.py`
carries them into the port, and both run on the same numpy inputs. JAX
runs under `jax.default_matmul_precision("highest")`.

Tolerances: at `dtype="float32"` logits agree within 2e-4 (they agree
within ~3e-5; matmuls sum in another order, and `floor` in the spiking FFN
would turn a last-bit difference into a whole spike level, which these
inputs do not meet); at bf16 the argmax agrees on at least 95% of
positions and the logits within 5e-2.

RAG layers retrieve from `tests/test_torch_common.py`'s bank (M = 4096,
D = 128, K = 32, probe 4, C = 256): B <= 3 takes IVF v3r (kernel B's
plain version here), B >= 4 the flat scan, and a bank without an index
brute force, in both packages alike.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.memory import state as jstate
from aura_snn_rag_tpu.models import layers as jlayers
from aura_snn_rag_tpu.models import snn_rag as jsnn_rag
from aura_snn_rag_tpu.models import transformer as jtransformer
import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.models import layers as tlayers
from aura_snn_rag_tpu_torch.models.convert import (
    params_from_numpy, tree_to_state_dict)
from tests.test_torch_common import (
    bank_pair, highest, make_data, spy_ivf_kernels, to_port)

torch.set_num_threads(1)

# max_seq_len 512 as in every preset: positions 0-20 then stay well
# before the theta carrier's quarter period (test_layer_norm_matches_flax)
SMALL_LM = dict(vocab_size=256, embedding_dim=128, num_layers=2,
                num_heads=4, intermediate_size=256, max_seq_len=512,
                n_place_cells=128, snn_layers=(0,), dtype="float32")
LOGIT_TOL = 2e-4


def lm_configs(**kw):
    cfg = dict(SMALL_LM, **kw)
    return jconfig.ModelConfig(**cfg), port.ModelConfig(**cfg)


def inputs(seed, B, L, vocab=256):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, L)).astype(np.int32),
            rng.randn(B, L, 4).astype(np.float32))


def np_out(x):
    return np.asarray(x.detach().cpu().float() if torch.is_tensor(x)
                      else jnp.asarray(x, jnp.float32))


def load(tmod, params):
    """flax params of one module into the port's module (strict)."""
    tmod.load_state_dict(tree_to_state_dict(jax.tree.map(np.asarray, params)))
    return tmod


@functools.lru_cache(maxsize=None)
def unbuilt_bank():
    """Both packages' copies of a bank whose index was never built."""
    jcfg, tcfg, _, _, _ = bank_pair("bf16")
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(make_data(5, 3000)),
                               jnp.zeros((3000, 2), jnp.float32))
    return js, to_port(js)


@functools.lru_cache(maxsize=None)
def lm_pair(rag=True, dtype="float32", **kw):
    """(jax model, params, port model) on the same weights; flax's init
    sees prosody and (with RAG) the bank, so every parameter exists. flax
    keeps f32 parameters whatever the compute dtype, so a bf16 model
    takes the f32 model's."""
    jm, tm = lm_configs(use_rag=rag, dtype=dtype, **kw)
    jcfg, tcfg, js, _, _ = bank_pair("bf16")
    jmodel = jtransformer.HippocampalTransformer(
        jm, memory_config=jcfg if rag else None)
    if dtype != "float32":
        params = lm_pair(rag, **kw)[1]
    else:
        ids, pros = inputs(0, 2, 8)
        with highest():
            params = jax.jit(lambda i, p, s: jmodel.init(
                jax.random.PRNGKey(0), i, prosody=p, use_memory=True,
                memory_state=s))(jnp.asarray(ids), jnp.asarray(pros),
                                 js if rag else None)
    tmodel = port.HippocampalTransformer(tm, tcfg if rag else None,
                                         device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, params), tm, tcfg if rag else None))
    return jmodel, params, tmodel


def run_both(jmodel, params, tmodel, ids, pros, js, ts, use_memory=True):
    with highest():
        jo, _ = jmodel.apply(params, jnp.asarray(ids),
                             prosody=None if pros is None
                             else jnp.asarray(pros),
                             use_memory=use_memory, memory_state=js)
    with torch.no_grad():
        to, _ = tmodel(torch.from_numpy(ids).long(),
                       prosody=None if pros is None
                       else torch.from_numpy(pros),
                       use_memory=use_memory, memory_state=ts)
    return jo, to


def assert_outputs_match(jo, to, tol=LOGIT_TOL):
    np.testing.assert_allclose(np_out(to.logits), np_out(jo.logits),
                               rtol=0, atol=tol)
    np.testing.assert_array_equal(np_out(to.place_activity) > 0,
                                  np_out(jo.place_activity) > 0)
    np.testing.assert_allclose(np_out(to.memory_summary),
                               np_out(jo.memory_summary), rtol=0, atol=tol)


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

def test_model_config_fields_defaults_and_presets_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.ModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(port.ModelConfig)}
    assert jf == tf
    for name in ("get_debug_config", "get_test_config", "get_small_config",
                 "get_medium_config", "get_full_config", "get_xl_config"):
        j, t = getattr(jconfig, name)(), getattr(port, name)()
        assert dataclasses.asdict(j.model) == dataclasses.asdict(t.model)
        assert dataclasses.asdict(j.memory) == dataclasses.asdict(t.memory)
        assert (j.model.head_dim, j.model.place_k) == (t.model.head_dim,
                                                       t.model.place_k)
    full = port.get_full_config()
    assert full.memory.bucket_capacity == 896 and full.model.place_k == 60
    assert jsnn_rag.snn_rag_config(jconfig.ModelConfig(num_layers=5)) == \
        jconfig.ModelConfig(**dataclasses.asdict(port.models.snn_rag_config(
            port.ModelConfig(num_layers=5))))


# --------------------------------------------------------------------------
# modules of layers.py
# --------------------------------------------------------------------------

def test_place_cell_encoder_and_tied_head_match():
    jm, tm = lm_configs()
    ids, _ = inputs(1, 2, 9)
    jmod = jlayers.PlaceCellEncoder(jm)
    with highest():
        params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(ids))
        je, ja = jmod.apply(params, jnp.asarray(ids))
        jl = jmod.apply(params, je, method=jmod.attend)
    tmod = load(tlayers.PlaceCellEncoder(tm), params)
    te, ta = tmod(torch.from_numpy(ids).long())
    np.testing.assert_allclose(np_out(ta), np_out(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_out(te), np_out(je), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_out(tmod.attend(te)), np_out(jl), rtol=0,
                               atol=1e-5)


def test_theta_gamma_positional_matches():
    jm, tm = lm_configs()
    pos = np.stack([np.arange(20), 7 + np.arange(20)]).astype(np.int32)
    jmod = jlayers.ThetaGammaPositional(jm)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(pos))
    want = jmod.apply(params, jnp.asarray(pos))
    got = load(tlayers.ThetaGammaPositional(tm), params)(
        torch.from_numpy(pos).long())
    np.testing.assert_allclose(np_out(got), np_out(want), rtol=0, atol=1e-6)


def test_layer_norm_matches_flax():
    """Rows whose mean is large against their spread (std 0.03 around
    1.2, as the positional encoding gives near a quarter period of its
    carrier): flax's one-pass variance cancels there, `F.layer_norm`'s
    two-pass one does not. Both against f64, and against each other."""
    import flax.linen as fnn
    rng = np.random.RandomState(15)
    x = np.concatenate([1.2 + 0.03 * rng.randn(4, 128),
                        rng.randn(4, 128)]).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.randn(128)).astype(np.float32), \
        (0.1 * rng.randn(128)).astype(np.float32)
    params = {"params": {"scale": scale, "bias": bias}}
    want = np.asarray(fnn.LayerNorm(dtype=jnp.float32).apply(
        params, jnp.asarray(x)))
    tmod = load(tlayers.LayerNorm(128, torch.float32), params)
    got = np_out(tmod(torch.from_numpy(x)))
    x64 = x.astype(np.float64)
    ref = ((x64 - x64.mean(-1, keepdims=True))
           / np.sqrt(x64.var(-1, keepdims=True) + 1e-6) * scale + bias)
    # well-conditioned rows: all three agree
    np.testing.assert_allclose(got[4:], want[4:], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[4:], ref[4:], rtol=0, atol=2e-6)
    # ill-conditioned rows: the port stays near f64; flax's error is larger
    port_err = np.abs(got[:4] - ref[:4]).max()
    flax_err = np.abs(want[:4] - ref[:4]).max()
    assert port_err <= 2e-5 and flax_err <= 2e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def _attention_pair():
    jm, tm = lm_configs()
    rng = np.random.RandomState(3)
    h = rng.randn(2, 6, 128).astype(np.float32)
    pros = rng.randn(2, 6, 4).astype(np.float32)
    jmod = jlayers.ProsodyGatedAttention(jm)
    with highest():
        params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(h),
                           jnp.asarray(pros), True)
    return jm, jmod, params, load(tlayers.ProsodyGatedAttention(tm),
                                  params), h, pros


@pytest.mark.parametrize("prosody,use_memory", [(False, False),
                                                (True, False), (True, True)])
def test_prosody_gated_attention_matches(prosody, use_memory):
    _, jmod, params, tmod, h, pros = _attention_pair()
    p = pros if prosody else None
    with highest():
        want, _ = jmod.apply(params, jnp.asarray(h),
                             None if p is None else jnp.asarray(p),
                             use_memory)
    got, cache = tmod(torch.from_numpy(h),
                      None if p is None else torch.from_numpy(p), use_memory)
    assert cache is None
    np.testing.assert_allclose(np_out(got), np_out(want), rtol=0, atol=1e-5)


def test_prosody_gated_attention_kv_cache_matches():
    """Rows [3, 6) written at cache_index 3 into a cache whose rows 0-2
    hold earlier keys: the queries attend rows [0, their position], with
    an explicit mask (`is_causal` would align it top-left)."""
    jm, jmod, params, tmod, h, _ = _attention_pair()
    rng = np.random.RandomState(4)
    T, H, Hd = 10, jm.num_heads, jm.head_dim
    ck, cv = (rng.randn(2, T, H, Hd).astype(np.float32) for _ in range(2))
    ck[:, 3:], cv[:, 3:] = 0, 0
    with highest():
        want, (jk, jv) = jmod.apply(params, jnp.asarray(h[:, 3:]), None,
                                    True, (jnp.asarray(ck), jnp.asarray(cv)),
                                    jnp.asarray(3))
    tk, tv = (torch.from_numpy(c.transpose(0, 2, 1, 3).copy())
              for c in (ck, cv))                              # [B, H, T, Hd]
    got, (gk, gv) = tmod(torch.from_numpy(h[:, 3:]), None, True, (tk, tv), 3)
    assert gk is tk and gv is tv                          # updated in place
    np.testing.assert_allclose(np_out(got), np_out(want), rtol=0, atol=1e-5)
    for g, j in ((gk, jk), (gv, jv)):
        np.testing.assert_allclose(np_out(g).transpose(0, 2, 1, 3),
                                   np_out(j), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="cache_index"):
        tmod(torch.from_numpy(h), None, True, (tk, tv), 5)


@pytest.mark.parametrize("name", ["MLP", "SNNFFN", "HybridFFN"])
def test_ffn_matches(name):
    jm, tm = lm_configs()
    x = (np.random.RandomState(5).randn(2, 7, 128) * 1.5).astype(np.float32)
    jmod = getattr(jlayers, name)(jm)
    with highest():
        params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
        want = jmod.apply(params, jnp.asarray(x))
    got = load(getattr(tlayers, name)(tm), params)(torch.from_numpy(x))
    np.testing.assert_allclose(np_out(got), np_out(want), rtol=0, atol=1e-5)


def test_synapsis_matches():
    x = (np.random.RandomState(6).rand(3, 4, 64) * 4).round() \
        .astype(np.float32)                                   # spike counts
    jmod = jlayers.Synapsis(32, dtype=jnp.float32)
    with highest():
        params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(x))
        want = jmod.apply(params, jnp.asarray(x))
    tmod = tlayers.Synapsis(64, 32, dtype=torch.float32)
    tmod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          params["params"].items()})
    assert tuple(tmod.kernel.shape) == (64, 32)               # flax's layout
    np.testing.assert_allclose(np_out(tmod(torch.from_numpy(x))),
                               np_out(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("snn", [False, True])
def test_transformer_layer_matches(snn):
    jm, tm = lm_configs()
    h, pros = (np.random.RandomState(7).randn(2, 6, d).astype(np.float32)
               for d in (128, 4))
    jmod = jlayers.TransformerLayer(jm, use_snn_ffn=snn)
    with highest():
        params = jmod.init(jax.random.PRNGKey(7), jnp.asarray(h),
                           jnp.asarray(pros), True)
        want, _ = jmod.apply(params, jnp.asarray(h), jnp.asarray(pros), True)
    got, _ = load(tlayers.TransformerLayer(tm, use_snn_ffn=snn), params)(
        torch.from_numpy(h), torch.from_numpy(pros), True)
    np.testing.assert_allclose(np_out(got), np_out(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["gate", "cross_attention", "concat"])
def test_memory_augmented_layer_matches(mode, monkeypatch):
    jm, tm = lm_configs(use_rag=True, memory_injection=mode)
    jcfg, tcfg, js, ts, _ = bank_pair("bf16")
    h, pros = (np.random.RandomState(8).randn(2, 5, d).astype(np.float32)
               for d in (128, 4))
    jmod = jlayers.MemoryAugmentedLayer(jm, jcfg, use_snn_ffn=True)
    with highest():
        params = jmod.init(jax.random.PRNGKey(8), jnp.asarray(h), js,
                           jnp.asarray(pros))
        want, _ = jmod.apply(params, jnp.asarray(h), js, jnp.asarray(pros))
    tmod = load(tlayers.MemoryAugmentedLayer(tm, tcfg, use_snn_ffn=True),
                params)
    calls = spy_ivf_kernels(monkeypatch)
    got, _ = tmod(torch.from_numpy(h), ts, torch.from_numpy(pros))
    assert calls == ["ivf_retrieve_fused"]                # B = 2: IVF v3r
    np.testing.assert_allclose(np_out(got), np_out(want), rtol=0, atol=1e-5)


def test_memory_augmented_layer_retrieve_fn():
    """`retrieve_fn(memory_config, state, queries, k)` replaces the
    engine's dispatch, in both packages: here the exact brute force."""
    jm, tm = lm_configs(use_rag=True)
    jcfg, tcfg, js, ts, _ = bank_pair("bf16")
    h = np.random.RandomState(9).randn(2, 5, 128).astype(np.float32)
    jmod = jlayers.MemoryAugmentedLayer(
        jm, jcfg, retrieve_fn=lambda c, s, q, k: jengine.retrieve_bruteforce(
            c, s, q, None, k))
    with highest():
        params = jmod.init(jax.random.PRNGKey(9), jnp.asarray(h), js,
                           jnp.zeros((2, 5, 4)))
        want, _ = jmod.apply(params, jnp.asarray(h), js)
    seen = []

    def brute(cfg, state, q, k):
        seen.append((cfg, tuple(q.shape), q.dtype, k))
        return port.retrieve_bruteforce(cfg, state, q, None, k)
    tmod = load(tlayers.MemoryAugmentedLayer(tm, tcfg, retrieve_fn=brute),
                params)
    got, _ = tmod(torch.from_numpy(h), ts)
    assert seen == [(tcfg, (2, 128), torch.float32, tm.num_retrieved)]
    np.testing.assert_allclose(np_out(got), np_out(want), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prosody", [False, True])
def test_hippocampal_transformer_matches(prosody):
    jmodel, params, tmodel = lm_pair(rag=False)
    ids, pros = inputs(10, 3, 11)
    jo, to = run_both(jmodel, params, tmodel, ids, pros if prosody else None,
                      None, None)
    assert to.logits.shape == (3, 11, 256) and to.logits.dtype == torch.float32
    assert_outputs_match(jo, to)


@pytest.mark.parametrize("mode", ["gate", "cross_attention", "concat"])
def test_snn_rag_transformer_matches_through_ivf(mode, monkeypatch):
    jmodel, params, tmodel = lm_pair(memory_injection=mode)
    _, _, js, ts, _ = bank_pair("bf16")
    ids, pros = inputs(11, 2, 8)
    calls = spy_ivf_kernels(monkeypatch)
    jo, to = run_both(jmodel, params, tmodel, ids, pros, js, ts)
    # every RAG layer reaches kernel B (its plain version on the CPU)
    assert calls == ["ivf_retrieve_fused"] * SMALL_LM["num_layers"]
    assert_outputs_match(jo, to)


@pytest.mark.parametrize("path", ["flat", "bruteforce"])
def test_snn_rag_transformer_matches_through_flat_and_bruteforce(
        path, monkeypatch):
    jmodel, params, tmodel = lm_pair()
    if path == "flat":
        _, _, js, ts, _ = bank_pair("bf16")
        B = 4                             # B * probe * C >= M: the flat scan
    else:
        js, ts = unbuilt_bank()
        B = 2
    ids, pros = inputs(12, B, 8)
    calls = spy_ivf_kernels(monkeypatch)
    jo, to = run_both(jmodel, params, tmodel, ids, pros, js, ts)
    assert calls == []
    assert_outputs_match(jo, to)
    # memory moves the output: the injection is live on this path
    _, off = run_both(jmodel, params, tmodel, ids, pros, None, None)
    assert np.abs(np_out(off.logits) - np_out(to.logits)).max() > 1e-3


def test_snn_rag_transformer_bf16():
    """bf16 compute over f32 weights. Agreement here is statistical: the
    packages round some bf16 steps differently (attention probabilities,
    LayerNorm statistics), and where that moves a GIF membrane across an
    integer the spiking FFN emits another level, which shifts that
    position's logits by ~0.1 and later positions' through attention.
    Python constants are rounded to bf16 first in both packages."""
    jmodel, params, tmodel = lm_pair(dtype="bfloat16")
    _, _, js, ts, _ = bank_pair("bf16")
    ids, pros = inputs(16, 3, 20)
    jo, to = run_both(jmodel, params, tmodel, ids, pros, js, ts)
    assert to.hidden.dtype == torch.bfloat16
    assert to.logits.dtype == torch.float32
    assert next(tmodel.parameters()).dtype == torch.float32   # f32 weights
    a, b = np_out(jo.logits), np_out(to.logits)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.95
    np.testing.assert_allclose(b, a, rtol=0, atol=5e-2)


def test_kv_cached_forward_matches_full_forward():
    """Prefill of 5 tokens into the caches, then one token at a time: the
    logits of every position equal the full forward's."""
    _, _, tmodel = lm_pair()
    _, _, _, ts, _ = bank_pair("bf16")
    ids, pros = inputs(14, 2, 9)
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        # without memory: each position's retrieval query would otherwise
        # be the chunk's mean, which differs between the two schedules
        full, _ = tmodel(ids_t, use_memory=False)
        caches = tmodel.init_kv_caches(2, SMALL_LM["max_seq_len"])
        assert caches[0][0].shape == (2, 4, 512, 32)
        out, caches = tmodel(ids_t[:, :5], use_memory=False,
                             kv_caches=caches, cache_index=0)
        got = [out.logits]
        for p in range(5, 9):
            out, caches = tmodel(ids_t[:, p:p + 1], use_memory=False,
                                 positions=torch.full((2, 1), p),
                                 kv_caches=caches, cache_index=p)
            got.append(out.logits)
        # with memory the decode path runs too (retrieval per token)
        tmodel(ids_t[:, :1], memory_state=ts, positions=torch.full((2, 1), 9),
               kv_caches=caches, cache_index=9)
    np.testing.assert_allclose(np_out(torch.cat(got, dim=1)),
                               np_out(full.logits), rtol=0, atol=1e-5)


def test_snn_rag_transformer_create():
    _, tm = lm_configs(num_layers=3, snn_layers=())
    jcfg, tcfg, _, _, _ = bank_pair("bf16")
    m = port.SNNRAGTransformer.create(tm, tcfg, device="cpu")
    assert m.config.use_rag and m.config.snn_layers == (0, 2)
    assert [type(layer.ffn).__name__ for layer in m.layers] == [
        "HybridFFN", "MLP", "HybridFFN"]
    assert all(isinstance(layer, tlayers.MemoryAugmentedLayer)
               for layer in m.layers)


def test_params_from_numpy_checks_keys_and_shapes():
    jm, tm = lm_configs(use_rag=True)
    _, tcfg, _, _, _ = bank_pair("bf16")
    _, params, _ = lm_pair()
    tree = jax.tree.map(np.asarray, params)
    # a tree from an init without a memory_state lacks the RAG parameters
    bare = {"params": {k: ({n: p for n, p in v.items() if n not in (
        "query_proj", "memory_proj", "memory_gate_proj")}
        if k.startswith("layer_") else v)
        for k, v in tree["params"].items()}}
    with pytest.raises(KeyError, match="query_proj"):
        params_from_numpy(bare, tm, tcfg)
    # the whole tree is too much for a model without RAG layers
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(tree, tm, None)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, dataclasses.replace(tm, vocab_size=300),
                          tcfg)
    sd = params_from_numpy(tree, tm, tcfg)
    assert sd["layers.0.attention.q_proj.weight"].shape == (128, 128)
    k = np.asarray(tree["params"]["layer_1"]["attention"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(
        sd["layers.1.attention.q_proj.weight"].numpy(), k.T)


@pytest.mark.parametrize("mode", ["gate", "cross_attention"])
def test_initialisers_mirror_flax_in_distribution(mode):
    """The port's own initialisers against flax's, parameter by parameter:
    constants equal, the truncated normals cut at two of their stds, and
    on tensors of 1000 or more entries the same std within 10% and mean
    within a tenth of it."""
    _, tm = lm_configs(use_rag=True, memory_injection=mode)
    _, tcfg, _, _, _ = bank_pair("bf16")
    jtree = params_from_numpy(jax.tree.map(
        np.asarray, lm_pair(memory_injection=mode)[1]), tm, tcfg)
    tsd = port.HippocampalTransformer(
        tm, tcfg, device="cpu",
        generator=torch.Generator().manual_seed(3)).state_dict()
    assert set(jtree) == set(tsd)
    for key, want in jtree.items():
        got = tsd[key]
        assert got.dtype == torch.float32, key
        if want.numel() == 1 or want.std().item() == 0.0:
            assert torch.equal(got, want), key     # zeros, ones, logit(0.5)
            continue
        if key.endswith("weight") and "norm" not in key \
                and "token_embedding" not in key:
            fan_in = got.shape[1]
            bound = 2 * math.sqrt(1 / fan_in) / tlayers.LECUN_TRUNC
            assert got.abs().max().item() <= bound * (1 + 1e-6), key
            assert want.abs().max().item() <= bound * (1 + 1e-6), key
        if want.numel() >= 1000:
            sj, st = want.std().item(), got.std().item()
            assert abs(st - sj) <= 0.1 * sj, (key, st, sj)
            assert abs(got.mean().item() - want.mean().item()) <= 0.1 * sj
