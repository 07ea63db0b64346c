"""The port's sampler, KV-cached decode, batched server and one-shot
helpers against the JAX package's.

`jax.random` and `torch` do not share random bits, so sampled ids are
never compared: the filters are compared value for value, `sample_token`
by the distribution it draws from, and decoding only where it is greedy
(top_k = 1, or a temperature of 1e-6 that leaves one token a chance).
The model is `tests/test_torch_model.py`'s small LM at f32 on the same
weights; with memory, B = 2 retrieves through IVF v3r and B = 4 through
the flat scan.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.generation import sampler as jsampler
from aura_snn_rag_tpu.generation import serving as jserving
from aura_snn_rag_tpu.memory.hippocampus import (
    HippocampalFormation as JHippocampalFormation)
from aura_snn_rag_tpu.services import one_shot as jone_shot
import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.generation import sampler as tsampler
from aura_snn_rag_tpu_torch.generation.serving import (
    BatchedGenerator, GenerationRequest)
from aura_snn_rag_tpu_torch.services import one_shot as tone_shot
from tests.test_torch_common import bank_pair, highest, spy_ivf_kernels
from tests.test_torch_model import SMALL_LM, lm_pair

torch.set_num_threads(1)


def _logits(seed, B=3, V=101, scale=3.0):
    return (np.random.RandomState(seed).randn(B, V) * scale).astype(
        np.float32)


# --------------------------------------------------------------------------
# filters and sampling
# --------------------------------------------------------------------------

def test_repetition_penalty_matches():
    x = _logits(0)
    counts = np.random.RandomState(1).randint(0, 3, x.shape).astype(np.int32)
    want = jsampler.apply_repetition_penalty(jnp.asarray(x),
                                             jnp.asarray(counts), 1.3)
    got = tsampler.apply_repetition_penalty(torch.from_numpy(x),
                                            torch.from_numpy(counts), 1.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [0, 1, 17])
def test_top_k_filter_matches(k):
    x = _logits(2)
    want = jsampler.top_k_filter(jnp.asarray(x), k)
    got = tsampler.top_k_filter(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.01, 0.8, 1.0, "per_row"])
def test_top_p_filter_matches(p):
    x = _logits(3)
    if p == "per_row":
        jp, tp = jnp.asarray([0.3, 0.9, 1.0]), torch.tensor([0.3, 0.9, 1.0])
    else:
        jp = tp = p
    want = np.asarray(jsampler.top_p_filter(jnp.asarray(x), jp))
    got = tsampler.top_p_filter(torch.from_numpy(x), tp).numpy()
    # a token whose exclusive cumulative probability lies within 1e-6 of
    # p may fall either side: the cumsums round in another order
    ps = np.broadcast_to(np.asarray(tp, np.float64).reshape(-1, 1),
                         (3, 1))
    order = np.argsort(-x, axis=-1)
    prob = np.take_along_axis(np.exp(x - x.max(-1, keepdims=True)), order,
                              -1)
    prob /= prob.sum(-1, keepdims=True)
    excl = np.cumsum(prob, -1) - prob
    edge = np.zeros_like(x, bool)
    np.put_along_axis(edge, order, np.abs(excl - ps) < 1e-6, -1)
    np.testing.assert_array_equal(np.where(edge, 0, got),
                                  np.where(edge, 0, want))
    assert ((got > -1e29).sum(-1) >= 1).all()


@pytest.mark.parametrize("top_k,top_p,temperature", [
    (10, 0.8, 0.7), (0, 0.9, 1.3), (25, 1.0, "per_row")])
def test_sample_token_draws_from_the_filtered_distribution(top_k, top_p,
                                                           temperature):
    """20,000 draws for one row of logits: never outside the support that
    the JAX package's filters keep, frequencies within 0.015 (over 4
    standard errors) of its softmax."""
    n = 20_000
    x = _logits(4, B=1, V=40, scale=1.5)
    counts = np.zeros((1, 40), np.int32)
    counts[0, :5] = 1
    t = 0.6 if temperature == "per_row" else temperature
    ref = jsampler.apply_repetition_penalty(jnp.asarray(x),
                                            jnp.asarray(counts), 1.2) / t
    ref = jsampler.top_p_filter(jsampler.top_k_filter(ref, top_k), top_p)
    ref_p = np.asarray(jax.nn.softmax(ref, axis=-1))[0]
    tt = torch.full((n,), t) if temperature == "per_row" else t
    got = tsampler.sample_token(
        torch.Generator().manual_seed(5),
        torch.from_numpy(x).expand(n, 40), temperature=tt, top_k=top_k,
        top_p=top_p, token_counts=torch.from_numpy(counts).expand(n, 40),
        repetition_penalty=1.2)
    freq = np.bincount(got.numpy(), minlength=40) / n
    assert freq[ref_p < 1e-12].sum() == 0
    np.testing.assert_allclose(freq, ref_p, rtol=0, atol=0.015)


def test_sample_token_greedy_and_blockwise():
    x = torch.from_numpy(_logits(6, B=4, V=3000))
    got = tsampler.sample_token(torch.Generator().manual_seed(0), x,
                                top_k=1)
    assert torch.equal(got, x.argmax(-1))
    a, b = (tsampler.sample_token(torch.Generator().manual_seed(9), x, 0.8,
                                  50, 0.9, topk_impl=impl)
            for impl in ("sort", "blockwise"))
    assert torch.equal(a, b)


@pytest.mark.parametrize("V,k", [(32000, 50), (31999, 50), (1000, 17),
                                 (100, 100)])
def test_exact_topk_blockwise_matches_topk(V, k):
    x = torch.from_numpy(np.random.RandomState(V).randn(3, V)
                         .astype(np.float32))
    v_ref, i_ref = torch.topk(x, k)
    v, i = tsampler.exact_topk_blockwise(x, k)
    assert torch.equal(v, v_ref)
    assert torch.equal(i, i_ref)             # distinct values: same indices
    jv, _ = jsampler.exact_topk_blockwise(jnp.asarray(x.numpy()), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_exact_topk_blockwise_under_ties():
    x = torch.zeros(2, 512)
    x[:, 7] = 1.0
    v, i = tsampler.exact_topk_blockwise(x, 5)
    assert (v[:, 0] == 1.0).all() and (i[:, 0] == 7).all()
    assert torch.equal(x.gather(-1, i), v)


# --------------------------------------------------------------------------
# KV-cached decode
# --------------------------------------------------------------------------

def _prompt(seed, B, L):
    return np.random.RandomState(seed).randint(
        0, SMALL_LM["vocab_size"], (B, L)).astype(np.int32)


@pytest.mark.parametrize("memory", [False, True])
def test_greedy_generate_matches_jax(memory, monkeypatch):
    jmodel, params, tmodel = lm_pair()
    _, _, js, ts, _ = bank_pair("bf16")
    ids = _prompt(20, 2, 5)
    with highest():
        want = jsampler.generate(
            jmodel, params, jnp.asarray(ids), 6, jax.random.PRNGKey(0),
            top_k=1, memory_state=js if memory else None, use_memory=memory)
    calls = spy_ivf_kernels(monkeypatch)
    got = tsampler.generate(tmodel, torch.from_numpy(ids), 6,
                            torch.Generator().manual_seed(0), top_k=1,
                            memory_state=ts if memory else None,
                            use_memory=memory)
    assert got.dtype == torch.long and got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the model runs 6 times; with memory each run's RAG layers reach B
    assert calls == ["ivf_retrieve_fused"] * (6 * SMALL_LM["num_layers"]
                                              if memory else 0)


def test_greedy_cached_matches_full_recompute():
    """Greedy decode through the KV cache emits the same tokens as
    recomputing the whole prefix for every token."""
    _, _, tmodel = lm_pair()
    ids = torch.from_numpy(_prompt(21, 1, 4)).long()
    got = tsampler.generate(tmodel, ids, 8, None, top_k=1,
                            repetition_penalty=1.0)[0, 4:]
    seq = ids
    with torch.no_grad():
        for _ in range(8):
            out, _ = tmodel(seq, use_memory=False)
            seq = torch.cat([seq, out.logits[:, -1].argmax(-1)[:, None]], 1)
    assert torch.equal(got, seq[0, 4:])


def test_generate_eos_padding_and_limits():
    _, _, tmodel = lm_pair()
    ids = torch.from_numpy(_prompt(22, 3, 2)).long()
    out = tsampler.generate(tmodel, ids, 10, torch.Generator().manual_seed(1),
                            temperature=5.0, top_k=0, eos_token_id=3)
    for row in out[:, 2:].tolist():
        if 3 in row:
            assert set(row[row.index(3):]) == {3}
    with pytest.raises(ValueError, match="max_seq_len|new"):
        tsampler.generate(tmodel, ids, SMALL_LM["max_seq_len"], None)


def test_snn_rag_transformer_generate():
    _, _, tmodel = lm_pair()
    _, _, _, ts, _ = bank_pair("bf16")
    m = port.SNNRAGTransformer(tmodel.config, tmodel.memory_config,
                               device="cpu")
    m.load_state_dict(tmodel.state_dict())
    ids = torch.from_numpy(_prompt(23, 2, 4)).long()
    out = m.generate(ids, 5, memory_state=ts, top_k=1)
    want = tsampler.generate(tmodel, ids, 5, None, top_k=1,
                             memory_state=ts, use_memory=True)
    assert torch.equal(out, want)


# --------------------------------------------------------------------------
# batched server
# --------------------------------------------------------------------------

def _requests(seed, n, **kw):
    rng = np.random.RandomState(seed)
    return [GenerationRequest(rng.randint(1, SMALL_LM["vocab_size"],
                                          rng.randint(1, 12)),
                              max_new_tokens=int(rng.randint(1, 5)), **kw)
            for _ in range(n)]


def test_batched_generator_matches_jax_greedy():
    """Three requests, left-padded into a batch of 4 (the flat path of the
    bank), at temperature 1e-6: the port's tokens equal the JAX server's,
    request by request, each trimmed to its own max_new_tokens."""
    jmodel, params, tmodel = lm_pair()
    _, _, js, ts, _ = bank_pair("bf16")
    reqs = _requests(30, 3, temperature=1e-6, top_p=1.0)
    jgen = jserving.BatchedGenerator(jmodel, params, batch_size=4,
                                     prompt_pad=8, max_new_tokens=4,
                                     memory_state=js)
    with highest():
        want = jgen.generate_batch([jserving.GenerationRequest(
            r.prompt_ids, r.max_new_tokens, r.temperature, r.top_p)
            for r in reqs])
    gen = BatchedGenerator(tmodel, batch_size=4, prompt_pad=8,
                           max_new_tokens=4, memory_state=ts)
    got = gen.generate_batch(reqs)
    for g, w, r in zip(got, want, reqs):
        assert g.shape == (r.max_new_tokens,)
        np.testing.assert_array_equal(g, w)
    assert gen.stats == jgen.stats


def test_batched_generator_sync_stats_and_buckets():
    _, _, tmodel = lm_pair()
    gen = BatchedGenerator(tmodel, batch_size=4, prompt_pad=8,
                           max_new_tokens=6)
    assert [gen._bucket(n) for n in (0, 1, 2, 3, 5, 6, 9)] == [
        1, 1, 2, 4, 6, 6, 6]
    reqs = [GenerationRequest(np.arange(1, 14), max_new_tokens=2),
            GenerationRequest(np.asarray([4, 5]), max_new_tokens=5),
            GenerationRequest(np.asarray([7]), max_new_tokens=9)]
    pad = gen._pad_batch(reqs)
    assert pad.shape == (4, 8) and (pad[3] == 0).all()
    assert pad[0].tolist() == list(range(6, 14))      # the last 8 ids
    assert pad[1].tolist() == [0] * 6 + [4, 5]        # left-padded
    outs = gen.generate_batch(reqs)
    assert [o.shape for o in outs] == [(2,), (5,), (6,)]
    assert all(((o >= 0) & (o < SMALL_LM["vocab_size"])).all() for o in outs)
    assert gen.stats == {"requests": 3, "batches": 1, "tokens": 13,
                         "mean_batch_fill": 0.75}
    with pytest.raises(ValueError):
        gen.generate_batch(_requests(1, 5))


def test_batched_generator_serve_forever():
    """Five submissions through the asyncio loop with batches of 2: every
    future completes with its own request's tokens, in three batches."""
    _, _, tmodel = lm_pair()
    gen = BatchedGenerator(tmodel, batch_size=2, prompt_pad=8,
                           max_new_tokens=4)
    reqs = _requests(31, 5)

    async def run():
        server = asyncio.create_task(gen.serve_forever(flush_ms=20))
        try:
            return await asyncio.wait_for(asyncio.gather(*[
                gen.submit(r.prompt_ids, r.max_new_tokens, 1e-6, 1.0)
                for r in reqs]), timeout=120)
        finally:
            server.cancel()
            with pytest.raises(asyncio.CancelledError):
                await server

    outs = asyncio.run(run())
    assert [o.shape for o in outs] == [(r.max_new_tokens,) for r in reqs]
    assert gen.stats["batches"] == 3 and gen.stats["requests"] == 5
    # the same server under a new event loop serves again
    again = asyncio.run(run())
    assert [o.shape for o in again] == [o.shape for o in outs]
    assert gen.stats["batches"] == 6


def test_batched_generator_reports_a_failed_batch():
    """A batch whose decode raises fails its requests' futures; the loop
    keeps serving the next batch."""
    _, _, tmodel = lm_pair()
    small = dataclasses.replace(tmodel.config, max_seq_len=10)
    model = port.HippocampalTransformer(small, device="cpu")
    gen = BatchedGenerator(model, batch_size=1, prompt_pad=8,
                           max_new_tokens=4)

    async def run():
        server = asyncio.create_task(gen.serve_forever(flush_ms=1))
        try:
            with pytest.raises(ValueError, match="max_seq_len"):
                await asyncio.wait_for(gen.submit([1, 2], 4), timeout=60)
            return await asyncio.wait_for(gen.submit([1, 2], 2), timeout=60)
        finally:
            server.cancel()

    assert asyncio.run(run()).shape == (2,)


def test_batched_generator_bf16_weights():
    _, _, tmodel = lm_pair()
    cfg = dataclasses.replace(tmodel.config, dtype="bfloat16")
    model = port.HippocampalTransformer(cfg, device="cpu")
    gen = BatchedGenerator(model, batch_size=2, prompt_pad=8,
                           max_new_tokens=4, weights_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in gen.model.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = gen.generate_batch([GenerationRequest(np.asarray([1, 2, 3]))])
    assert out[0].shape == (4,) and (out[0] >= 0).all()
    with pytest.raises(ValueError, match="weights_dtype"):
        BatchedGenerator(model, weights_dtype="float16")


# --------------------------------------------------------------------------
# one-shot memorisation
# --------------------------------------------------------------------------

def test_one_shot_memorize_and_generate_matches_jax():
    jmodel, params, tmodel = lm_pair()
    jcfg, tcfg, _, _, _ = bank_pair("bf16")
    memo, prompt = _prompt(40, 1, 6)[0], _prompt(41, 1, 3)[0]
    jh = JHippocampalFormation(jcfg)
    th = port.HippocampalFormation(tcfg, device="cpu")
    with highest():
        jmid, jout = jone_shot.one_shot_memorize_and_generate(
            jmodel, params, jh, memo, prompt, max_new_tokens=4,
            rng=jax.random.PRNGKey(0), top_k=1)
    tmid, tout = tone_shot.one_shot_memorize_and_generate(
        tmodel, th, memo, prompt, max_new_tokens=4, top_k=1)
    assert tmid == jmid and th.memory_count == jh.memory_count == 1
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    # the stored summary is the model's, and it retrieves itself
    emb = tone_shot.embed_with_model(tmodel, memo)
    np.testing.assert_allclose(emb.numpy(), np.asarray(
        jone_shot.embed_with_model(jmodel, params, memo[None])), rtol=0,
        atol=2e-4)
    tone_shot.store_custom_memory(th, "other", emb[0] * -1.0)
    hits = tone_shot.retrieve_custom_memories(th, emb[0], k=2)
    assert [h[0] for h in hits] == [tmid, "other"]


# the JAX package's temperature cases (tests/models/test_serving.py:72,
# 91): the port has no compile cache, so "traced, not baked" becomes:
# each request's temperature reaches the sampler in its own row


def test_batched_generator_temperature_is_per_request_and_live():
    """Near-zero temperature decodes greedily: the same tokens in two
    batches, and the same again beside a hot request in one batch; then a
    hot batch decodes too."""
    _, _, tmodel = lm_pair()
    gen = BatchedGenerator(tmodel, batch_size=2, prompt_pad=8,
                           max_new_tokens=4)
    cold = GenerationRequest(np.asarray([1, 2, 3]), temperature=1e-4,
                             top_p=1.0)
    out1 = gen.generate_batch([cold])[0]
    out2 = gen.generate_batch([cold])[0]
    np.testing.assert_array_equal(out1, out2)
    mixed = gen.generate_batch([cold, GenerationRequest(
        np.asarray([1, 2, 3]), temperature=50.0, top_p=1.0)])
    np.testing.assert_array_equal(mixed[0], out1)
    hot = gen.generate_batch([GenerationRequest(
        np.asarray([1, 2, 3]), temperature=5.0, top_p=1.0)])[0]
    assert hot.shape == (4,)


def test_batched_generator_hot_temperature_differs_from_cold():
    _, _, tmodel = lm_pair()
    gen = BatchedGenerator(tmodel, batch_size=2, prompt_pad=8,
                           max_new_tokens=4)
    cold = gen.generate_batch([GenerationRequest(
        np.asarray([1, 2, 3]), temperature=1e-4, top_p=1.0)])[0]
    hots = [gen.generate_batch([GenerationRequest(
        np.asarray([1, 2, 3]), temperature=50.0, top_p=1.0)])[0]
        for _ in range(4)]
    # at T = 50 the distribution is near uniform over the vocabulary: the
    # odds that all 4 samples equal the greedy tokens are negligible
    assert any(not np.array_equal(cold, h) for h in hots)
