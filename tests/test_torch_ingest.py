"""The port's ingestion path against the JAX package's: the hash embedder,
the embedding cache, JSONL/CSV ingestion, the continuous-learning
orchestrator, online learning (Oja, STDP, whitener, NLMS), the STDP
dictionary and `leaky_integrate`.

Tolerances: the embedder is held bit for bit, on the native path and on
the numpy path each (the two paths differ from each other in the last
bit of a norm and in what counts as whitespace, as in the JAX package).
Ingested bank rows equal within BANK_ATOL (the embeddings are equal, the
banks store them as given). The online learners' f32 arithmetic runs in
another order than XLA's (Hillis-Steele for `associative_scan`,
`index_add` for `.at[].add`, PyTorch's reductions): within ONLINE_RTOL
relative and ONLINE_ATOL absolute. NLMS and the STDP dictionary are the
same host code: equal.
"""

import asyncio
import csv
import ctypes
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.encoders import EmbeddingCache as JCache
from aura_snn_rag_tpu.encoders import FastHashEmbedder as JEmbedder
from aura_snn_rag_tpu.memory.hippocampus import (
    HippocampalFormation as JHippo)
from aura_snn_rag_tpu.ops.neurons import leaky_integrate as j_leaky
from aura_snn_rag_tpu.services import continuous_learning as jcl
from aura_snn_rag_tpu.services import ingest as jingest
from aura_snn_rag_tpu.training import online as jon
from aura_snn_rag_tpu.training.stdp_dict import STDPLearnerDict as JDict

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.encoders import EmbeddingCache, FastHashEmbedder
from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation
from aura_snn_rag_tpu_torch.ops.neurons import leaky_integrate
from aura_snn_rag_tpu_torch.services import continuous_learning as tcl
from aura_snn_rag_tpu_torch.services import ingest as tingest
from aura_snn_rag_tpu_torch.training import online as ton
from aura_snn_rag_tpu_torch.training.stdp_dict import STDPLearnerDict

torch.set_num_threads(1)

BANK_ATOL = 1e-6
ONLINE_RTOL = 1e-5
ONLINE_ATOL = 1e-6

TEXTS = ["hello world", "", "a", "the cat sat on the mat",
         "héllo wörld ☃ 日本語のテキスト", "tab\tand　ideographic space\n",
         "x" * 5000 + " long tail " + "yz" * 1000]

MEM = dict(max_memories=256, feature_dim=64, k_centroids=8,
           rebuild_interval=10_000, n_place_cells=16, n_grid_cells=8,
           n_time_cells=4)


def hippos():
    return (JHippo(jconfig.MemoryConfig(**MEM), seed=0),
            HippocampalFormation(port.MemoryConfig(**MEM), seed=0,
                                 device="cpu"))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=ONLINE_RTOL, atol=ONLINE_ATOL)


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library, loaded. Its loader links
    `native/libaura_native.so` in place (`g++ -o`, no temporary and
    rename) and the JAX embedder module tries it once, at import: a test
    worker that imports it while another worker is still linking gets
    None for the process's life. So when the module holds None, this
    retries the loader (its `_loaded` flag reset) for up to 60 s and
    patches the module's `_NATIVE` with the library it gets, for this
    module's tests; the JAX package itself is not changed. If none
    loads, the test fails, naming the cause."""
    from aura_snn_rag_tpu import _native
    from aura_snn_rag_tpu.encoders import hash_embedder
    if hash_embedder._NATIVE is not None:
        yield hash_embedder._NATIVE
        return
    deadline = time.monotonic() + 60
    with pytest.MonkeyPatch.context() as mp:
        while True:
            mp.setattr(_native, "_loaded", False)
            mp.setattr(_native, "_lib", None)
            lib = hash_embedder._load_native()
            if lib is not None:
                break
            if time.monotonic() > deadline:
                try:
                    ctypes.CDLL(_native._SO_PATH)
                    cause = "it loads, but lacks the embedder's symbols"
                except OSError as exc:
                    state = ("exists" if os.path.exists(_native._SO_PATH)
                             else "is missing")
                    cause = f"{_native._SO_PATH} {state}: {exc}"
                pytest.fail(f"the JAX package's native library did not "
                            f"load within 60 s: {cause}")
            time.sleep(0.5)
        mp.setattr(hash_embedder, "_NATIVE", lib)
        yield lib


@pytest.mark.parametrize("native", [True, False])
def test_hash_embedder_equals_jax(native, jax_native):
    j = JEmbedder(dim=256, token_vocab=1000, use_native=native)
    t = FastHashEmbedder(dim=256, token_vocab=1000, use_native=native)
    assert t.native == native and (j._native is not None) == native
    for text in TEXTS:
        np.testing.assert_array_equal(t.embed(text), j.embed(text))
        np.testing.assert_array_equal(t.token_indices(text),
                                      j.token_indices(text))
    out = t.embed_batch(TEXTS)
    assert out.shape == (len(TEXTS), 256) and out.dtype == np.float32
    np.testing.assert_array_equal(out, j.embed_batch(TEXTS))
    np.testing.assert_allclose(np.linalg.norm(out[[0, 3, 4]], axis=1), 1.0,
                               atol=1e-6)
    assert not out[1].any() and not out[2].any()   # no 2-gram


def test_embedding_cache(tmp_path):
    cache = EmbeddingCache(str(tmp_path))
    assert cache.get("x") is None
    cache.put("x", np.ones(4, np.float32), np.arange(3))
    e, t = cache.get("x")
    np.testing.assert_array_equal(e, np.ones(4))
    np.testing.assert_array_equal(t, np.arange(3))
    # the same files as the JAX package's cache
    e, t = JCache(str(tmp_path)).get("x")
    np.testing.assert_array_equal(t, np.arange(3))
    JCache(str(tmp_path)).put("ü", np.zeros(2), np.ones(1, np.int64))
    np.testing.assert_array_equal(cache.get("ü")[1], [1])


# --------------------------------------------------------------------------
# ingestion
# --------------------------------------------------------------------------

def corpus_rows(n=150):
    rng = np.random.RandomState(3)
    words = ["alpha", "beta", "gamma", "delta", "épsilon", "ζeta", "eta"]
    rows = []
    for i in range(n):
        text = " ".join(rng.choice(words, 6)) + f" {i}"
        kind = i % 5
        rows.append({"text": text} if kind == 0 else
                    {"content": text} if kind == 1 else
                    {"prompt": text, "response": f"r{i}"} if kind == 2 else
                    {"question": text, "answer": f"a{i}"} if kind == 3 else
                    {"irrelevant": text})
    return rows


def assert_same_bank(jh, th, n):
    assert jh.memory_count == th.memory_count == n
    jsd, tsd = jh.state_dict(), th.state_dict()
    assert tsd["slot_ids"] == jsd["slot_ids"]
    np.testing.assert_allclose(tsd["memory_state"].features,
                               np.asarray(jsd["memory_state"].features),
                               rtol=0, atol=BANK_ATOL)
    q = FastHashEmbedder(dim=MEM["feature_dim"]).embed_batch(
        ["alpha beta gamma", "ζeta eta 17", "r42"])
    jr = jh.retrieve_batch(jnp.asarray(q), k=5)
    tr = th.retrieve_batch(q, k=5)
    np.testing.assert_array_equal(tr.indices.numpy(),
                                  np.asarray(jr.indices))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               rtol=0, atol=BANK_ATOL)


@pytest.mark.parametrize("max_items", [None, 37])
def test_ingest_jsonl_equals_jax(tmp_path, max_items):
    p = tmp_path / "corpus.jsonl"
    lines = [json.dumps(r, ensure_ascii=False) for r in corpus_rows()]
    lines[7] = "{not json"
    lines.insert(20, "")
    lines.insert(30, json.dumps("a bare string row"))
    p.write_text("\n".join(lines), encoding="utf-8")
    jh, th = hippos()
    je = JEmbedder(dim=MEM["feature_dim"])
    te = FastHashEmbedder(dim=MEM["feature_dim"])
    nj = jingest.ingest_jsonl_to_memory(jh, str(p), je.embed_batch,
                                        max_items=max_items, batch_size=16)
    nt = tingest.ingest_jsonl_to_memory(th, str(p), te.embed_batch,
                                        max_items=max_items, batch_size=16)
    assert nt == nj == (37 if max_items else 120)
    assert th.host_state_dict()["slot_ids"][:3] == [
        "jsonl-0", "jsonl-1", "jsonl-2"]
    assert_same_bank(jh, th, nt)


def test_ingest_csv_pairs_equals_jax(tmp_path):
    p = tmp_path / "pairs.csv"
    with open(p, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["Prompt", "Response", "extra"])
        for i in range(40):
            w.writerow([f"question {i} ☃", f"answer {i}", "x"])
        w.writerow(["", "", ""])       # stored as " → ", as in JAX
    other = tmp_path / "loose.csv"
    other.write_text("a,b\nfirst,second\nonly,\n", encoding="utf-8")
    for path, want in ((p, 41), (other, 2)):
        jh, th = hippos()
        embed = FastHashEmbedder(dim=MEM["feature_dim"]).embed_batch
        nj = jingest.ingest_csv_pairs_to_memory(
            jh, str(path), JEmbedder(dim=MEM["feature_dim"]).embed_batch,
            batch_size=16)
        nt = tingest.ingest_csv_pairs_to_memory(th, str(path), embed,
                                                batch_size=16)
        assert nt == nj == want
        assert_same_bank(jh, th, nt)


# --------------------------------------------------------------------------
# continuous learning (mirrors tests/test_services.py)
# --------------------------------------------------------------------------

def test_process_batch_equals_jax():
    jh, th = hippos()
    jo = jcl.ContinuousLearningOrchestrator(jh, vocab_size=1000)
    to = tcl.ContinuousLearningOrchestrator(th, vocab_size=1000)
    batch = ["the quick brown fox", "jumps over the lazy dog the fox",
             "ünïcode tokens here"]
    jo.process_batch([jcl.IngestItem(t) for t in batch])
    to.process_batch([tcl.IngestItem(t) for t in batch])
    assert th.memory_count == 3 and to.stats == jo.stats
    assert to.stats["memories_stored"] == 3
    assert float(to.stdp_state.token_weights.max()) > 0.5
    close(to.stdp_state.token_weights.numpy(),
          jo.stdp_state.token_weights)
    assert th.host_state_dict()["slot_ids"] == jh.state_dict()["slot_ids"]
    np.testing.assert_allclose(th.state_dict()["memory_state"].features,
                               np.asarray(jh.state.features), atol=BANK_ATOL)


def test_zone_executor_instead_of_memory():
    th = hippos()[1]
    seen = []
    orch = tcl.ContinuousLearningOrchestrator(
        th, memory_only=False, zone_executor=lambda f, c: seen.append(
            (f.shape, c)))
    orch.process_batch([tcl.IngestItem("x y", "science")])
    assert th.memory_count == 0 and seen == [((MEM["feature_dim"],),
                                              "science")]


def test_dedup():
    orch = tcl.ContinuousLearningOrchestrator(hippos()[1])

    async def run():
        return await orch.submit("same text"), await orch.submit("same text")
    a, b = asyncio.run(run())
    assert a and not b
    assert orch.stats["duplicates_skipped"] == 1


def test_one_shot_memorize_and_retrieve():
    th = hippos()[1]
    orch = tcl.ContinuousLearningOrchestrator(th)
    mid = orch.one_shot_memorize_text("the capital of france is paris")
    assert mid == jcl.ContinuousLearningOrchestrator(
        hippos()[0]).one_shot_memorize_text("the capital of france is paris")
    q = orch.hash_embedder.embed("capital of france")
    assert th.retrieve_similar_memories(q, k=1)[0][0] == mid


def test_vocab_dir_watcher_and_queue(tmp_path):
    th = hippos()[1]
    d = tmp_path / "vocab"
    d.mkdir()
    (d / "a.txt").write_text("hello vocab world")
    (d / "skip.md").write_text("not a vocab file")
    orch = tcl.ContinuousLearningOrchestrator(th, vocab_dir=str(d),
                                              batch_size=4)

    async def run():
        await orch.start()
        await orch.submit("queued text one")
        await asyncio.sleep(1.5)
        await orch.stop()
    asyncio.run(run())
    assert th.memory_count == 2 and orch.stats["items_processed"] == 2
    assert not orch._tasks


def test_feed_loop_without_aiohttp_returns(monkeypatch):
    """The RSS loop imports aiohttp lazily and stops when it is missing;
    no test opens the network."""
    monkeypatch.setitem(sys.modules, "aiohttp", None)
    orch = tcl.ContinuousLearningOrchestrator(
        hippos()[1], feeds=tcl.create_default_feeds())
    asyncio.run(asyncio.wait_for(orch._loop_feeds(), timeout=5))
    assert orch.stats["feeds_fetched"] == 0
    assert [f.category for f in orch.feeds] == [
        f.category for f in jcl.create_default_feeds()]


def test_config_roundtrip(tmp_path):
    th = hippos()[1]
    orch = tcl.ContinuousLearningOrchestrator(
        th, feeds=[tcl.FeedConfig("http://x/rss", "tech")],
        vocab_dir="/v", batch_size=8)
    p = tmp_path / "cl.json"
    orch.save_config(str(p))
    orch2 = tcl.ContinuousLearningOrchestrator.load_config(str(p), th)
    assert orch2.feeds[0].url == "http://x/rss" and orch2.batch_size == 8
    # the JAX package reads the same file
    assert jcl.ContinuousLearningOrchestrator.load_config(
        str(p), hippos()[0]).vocab_dir == "/v"


@pytest.mark.parametrize("body", [
    """<?xml version="1.0"?><rss version="2.0"><channel>
      <item><title>First story</title><description>Body &lt;b&gt;one&lt;/b&gt;</description></item>
      <item><title>Second</title><description>two</description></item>
    </channel></rss>""",
    """<?xml version="1.0"?><feed xmlns="http://www.w3.org/2005/Atom">
      <entry><title>Atom title</title><summary>atom body</summary></entry>
    </feed>""",
    "not xml at all"])
def test_parse_feed_entries_equals_jax(body):
    assert tcl.parse_feed_entries(body) == jcl.parse_feed_entries(body)


# --------------------------------------------------------------------------
# online learning (mirrors tests/training/test_online.py) and the neuron
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((7, 3, 5), -2), ((2, 33), -1),
                                        ((16, 4), 0)])
def test_leaky_integrate_equals_jax(shape, axis):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    for decay in (np.float32(0.8),
                  rng.uniform(0.5, 1.0, np.moveaxis(x, axis, 0).shape[1:])
                  .astype(np.float32)):
        want = j_leaky(jnp.asarray(decay), jnp.asarray(x), axis=axis)
        close(leaky_integrate(torch.from_numpy(np.asarray(decay)),
                              torch.from_numpy(x), axis=axis), want)
    # the recurrence itself
    ref = np.moveaxis(x, axis, 0).copy()
    for t in range(1, ref.shape[0]):
        ref[t] += 0.8 * ref[t - 1]
    close(leaky_integrate(0.8, torch.from_numpy(x), axis=axis),
          np.moveaxis(ref, 0, axis))


def oja_pair(seed, input_dim, n, max_components):
    js = jon.init_oja(jax.random.PRNGKey(seed), input_dim, n, max_components)
    ts = ton.OjaState(*[torch.from_numpy(np.array(x)) for x in js])
    return js, ts


def assert_oja(ts, js):
    close(ts.W, js.W)
    assert int(ts.K) == int(js.K)
    assert int(ts.update_count) == int(js.update_count)
    close(ts.residual_ema, js.residual_ema)


def test_oja_equals_jax():
    js, ts = oja_pair(0, 16, 4, 8)
    x = np.ones((3, 16), np.float32)
    close(ton.oja_forward(ts, torch.from_numpy(x)),
          jon.oja_forward(js, jnp.asarray(x)))
    rng = np.random.RandomState(0)
    # steady steps, then a batch whose residual passes the threshold
    # (neurogenesis), then a 1-D input
    for x, th in [(rng.randn(8, 16), 1e9), (rng.randn(8, 16), 1e9),
                  (rng.randn(4, 16) * 10, 0.1), (rng.randn(16), 1e9)]:
        x = x.astype(np.float32)
        js, jy = jon.oja_step(js, jnp.asarray(x), 0.05, 0.9, th)
        ts, ty = ton.oja_step(ts, torch.from_numpy(x), 0.05, 0.9, th)
        close(ty, jy)
        assert_oja(ts, js)
    assert int(ts.K) == 5
    assert abs(float(torch.linalg.vector_norm(ts.W[:, 4])) - 1.0) < 1e-5


def test_oja_learns_dominant_direction():
    st = ton.init_oja(torch.Generator().manual_seed(0), 8, 1,
                      max_components=4, device="cpu")
    assert int(st.K) == 1 and st.W.shape == (8, 4)
    v = np.zeros(8, np.float32)
    v[0] = 1.0
    data = torch.from_numpy(np.outer(np.random.RandomState(0).randn(64), v)
                            .astype(np.float32))
    for _ in range(10):
        for i in range(0, 64, 8):
            st, _ = ton.oja_step(st, data[i:i + 8], 0.1, 0.99, 1e9)
    assert abs(abs(float(st.W[0, 0])) - 1.0) < 0.1


def test_stdp_equals_jax():
    rng = np.random.RandomState(1)
    js, ts = jon.init_stdp(50), ton.init_stdp(50, device="cpu")
    for _ in range(3):
        toks = rng.randint(0, 50, (4, 12)).astype(np.int32)
        js, jst = jon.stdp_process_sequence(js, jnp.asarray(toks))
        ts, tst = ton.stdp_process_sequence(ts, torch.from_numpy(toks))
        close(ts.token_weights, js.token_weights)
        for key in ("mean_weight", "max_weight"):
            close(tst[key], jst[key])
        assert int(tst["active_count"]) == int(jst["active_count"])
    spikes = rng.rand(1, 9).astype(np.float32)
    toks = np.array([3, 3, 4, 5, 3, 6, 7, 3, 9], np.int32)
    js, _ = jon.stdp_process_sequence(js, jnp.asarray(toks), 0.05, 3,
                                      0.95, 0.0, 1.0, jnp.asarray(spikes))
    ts, _ = ton.stdp_process_sequence(ts, torch.from_numpy(toks), 0.05, 3,
                                      0.95, 0.0, 1.0,
                                      torch.from_numpy(spikes))
    close(ts.token_weights, js.token_weights)
    ids = np.array([[0, 3], [5, 9]])
    close(ton.stdp_modulations(ts, torch.from_numpy(ids)),
          jon.stdp_modulations(js, jnp.asarray(ids)))
    # clamped to the bounds
    for _ in range(20):
        ts, _ = ton.stdp_process_sequence(ts, torch.ones(1, 64, dtype=int))
    assert float(ts.token_weights.max()) <= 1.0 + 1e-6
    assert float(ts.token_weights.min()) >= 0.0


def test_whitener_equals_jax():
    rng = np.random.RandomState(0)
    js, ts = jon.init_whitener(4), ton.init_whitener(4, device="cpu")
    batches = [rng.randn(1, 4)] + [rng.randn(20, 4) * 5 + 3
                                   for _ in range(4)] + [rng.randn(4)]
    for x in batches:
        x = x.astype(np.float32)
        js, jo = jon.whiten_update(js, jnp.asarray(x), 0.1)
        ts, to = ton.whiten_update(ts, torch.from_numpy(x), 0.1)
        close(to, jo)
        close(ts.mean, js.mean)
        close(ts.var, js.var)
        assert int(ts.count) == int(js.count)
    x = rng.randn(6, 4).astype(np.float32)
    close(ton.whiten(ts, torch.from_numpy(x)), jon.whiten(js, jnp.asarray(x)))
    # a first batch of more than one row sets the variance
    js, _ = jon.whiten_update(jon.init_whitener(4), jnp.asarray(x))
    ts, _ = ton.whiten_update(ton.init_whitener(4, device="cpu"),
                              torch.from_numpy(x))
    close(ts.var, js.var)


def test_nlms_equals_jax():
    rng = np.random.RandomState(0)
    true_w = rng.randn(8).astype(np.float32)
    je, te = jon.NLMSExpert(8, lr=0.5), ton.NLMSExpert(8, lr=0.5)
    for _ in range(300):
        x = rng.randn(8).astype(np.float32)
        assert te.update(x, float(np.dot(true_w, x))) == je.update(
            x, float(np.dot(true_w, x)))
    np.testing.assert_array_equal(te.w, je.w)
    assert te.rmse == je.rmse
    x = rng.randn(8).astype(np.float32)
    assert abs(te.predict(x) - np.dot(true_w, x)) < 0.3


def test_stdp_dict_equals_jax():
    j, t = JDict(prune_below=0.3), STDPLearnerDict(prune_below=0.3)
    rng = np.random.RandomState(2)
    for _ in range(5):
        seq = rng.randint(0, 20, 15).tolist()
        assert t.process_sequence(seq) == j.process_sequence(seq)
    assert t.weights == j.weights and t.items_seen == 5
    assert t.get_modulations([1, 2, 99]) == j.get_modulations([1, 2, 99])
