"""The overflow annex's pass on kernel B's path (`ops/cuda/annex.py`): its
plain version, which CPU tensors run, against the JAX package's v3r annex
merge (`aura_snn_rag_tpu/memory/engine.py:385-404`, rebuilt here from the
JAX package's own `_annex_coarse`, `_l2norm` and `_combined_score`) on
the same bank, queries and kernel B lanes.

Banks: the annex full (4096 rows rebuilt at C = 128, so more rows
overflow than its 512 slots hold), partly filled (2000 rows at C = 128,
as `test_torch_ivf.py::test_retrieve_reaches_annexed_rows` builds it),
empty (`overflow_buckets` 0), and full with planted equal scores: one
annex entry repeated under another bank slot, and kernel B's first lane
at the best annex score of the first query. Kernel B's lanes are made up
from a seed (scores in the annex's range, misses in the first query).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.memory import state as jstate
from aura_snn_rag_tpu_torch.ops.cuda import annex
from tests.test_torch_common import (
    assert_topk_match, configs, highest, make_data, queries_near)

torch.set_num_threads(1)

SCORE_TOL = 1e-5      # exact f32 rerank, dot products in another order
K_OUT = 5
KK = 128


def _bank(kind):
    """(jcfg, tcfg, the bank's arrays, feats) for one kind of annex."""
    kw = {"overflow_buckets": 0} if kind == "empty" else {}
    jcfg, tcfg = configs(coarse_dtype="bf16", bucket_overprovision=1.0, **kw)
    feats = make_data(11, 4096)
    n = 2000 if kind == "partial" else 4096
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(feats[:n]),
                               jnp.zeros((n, 2), jnp.float32))
        js = jengine.rebuild_centroids(jcfg, js, jax.random.PRNGKey(0))
    arrays = {k: np.array(v) for k, v in js._asdict().items()}
    if kind == "ties":
        # entry e2 repeats e1 under bank slot s2: equal coarse and exact
        # scores for every query
        G = min(jcfg.overflow_buckets, jcfg.k_centroids // 4)
        slot = arrays["cluster_slot"][-G:].reshape(-1)
        e1, e2 = np.nonzero(slot >= 0)[0][[3, 40]]
        s1, s2 = slot[e1], slot[e2]
        for name in ("features", "features_nb16", "coarse_scale",
                     "strength", "timestamp"):
            arrays[name][s2] = arrays[name][s1]
        C = arrays["cluster_slot"].shape[1]
        K0 = arrays["cluster_slot"].shape[0] - G
        for name in ("clustered", "cluster_ts", "cluster_decay"):
            a = arrays[name]
            a[K0 + e2 // C, e2 % C] = a[K0 + e1 // C, e1 % C]
        feats = arrays["features"]
    return jcfg, tcfg, arrays, feats


def _jax_merge(jcfg, js, qn, scores, slots, kk, k):
    """The JAX package's v3r merge of kernel B's lanes with the annex."""
    found = jengine._annex_coarse(jcfg, js, qn, None, kk)
    if found is None:
        return scores, slots
    a_s, a_sl, a_valid = found
    a_cos = jnp.einsum("bkd,bd->bk",
                       jengine._l2norm(js.features[a_sl].astype(jnp.float32)),
                       qn, precision=jax.lax.Precision.HIGHEST)
    a_exact = jengine._combined_score(jcfg, js, a_cos, a_sl, None)
    a_exact = jnp.where(a_valid, a_exact, jengine.NEG_INF)
    all_s = jnp.concatenate([scores, a_exact], axis=1)
    all_sl = jnp.concatenate([slots, a_sl], axis=1)
    top, pick = jax.lax.top_k(all_s, k)
    return top, jnp.take_along_axis(all_sl, pick, axis=1)


def _lanes(seed, B, M):
    """Kernel B's output lanes [B, 128]: k sorted scores, random slots,
    misses in the first query's second half."""
    rng = np.random.RandomState(seed)
    s = np.full((B, 128), -1e30, np.float32)
    sl = np.full((B, 128), -1, np.int32)
    s[:, :K_OUT] = -np.sort(-(rng.rand(B, K_OUT) * 0.5 + 0.2), axis=1)
    sl[:, :K_OUT] = rng.randint(0, M, (B, K_OUT))
    s[0, 2:K_OUT], sl[0, 2:K_OUT] = -1e30, -1
    return s, sl


@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("kind", ["full", "partial", "empty", "ties"])
def test_annex_merge_plain_matches_jax(kind, B):
    jcfg, tcfg, arrays, feats = _bank(kind)
    js = jstate.MemoryState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ts = port.state_from_numpy(jstate.MemoryState(**arrays), "cpu")
    G = min(jcfg.overflow_buckets, jcfg.k_centroids // 4)
    if G:
        # half of the queries near annexed rows, so the annex has hits
        slot = arrays["cluster_slot"][-G:].reshape(-1)
        live = slot[(slot >= 0) & (arrays["cluster_gen"][-G:].reshape(-1)
                                   >= 0)]
        fill = len(live) / slot.size
        assert (fill > 0.95) if kind in ("full", "ties") else (0 < fill < 0.5)
        src = np.where(np.arange(B) % 2 == 0, live[np.arange(B) % len(live)],
                       np.random.RandomState(B).randint(0, 4096, B))
        q = feats[src] + 0.3 * np.random.RandomState(B + 1).randn(
            B, feats.shape[1]).astype(np.float32)
    else:
        q = queries_near(feats, B, B)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    b_s, b_sl = _lanes(B, B, arrays["features"].shape[0])
    if kind == "ties":
        # kernel B's first lane ties the first query's best annex score
        with highest():
            top, _ = _jax_merge(jcfg, js, jnp.asarray(qn[:1]),
                                jnp.full((1, K_OUT), -1e30),
                                jnp.full((1, K_OUT), -1), KK, K_OUT)
        b_s[0, 0] = float(top[0, 0])
        b_s[0, :K_OUT] = -np.sort(-b_s[0, :K_OUT])
    with highest():
        jsc, jsl = _jax_merge(jcfg, js, jnp.asarray(qn),
                              jnp.asarray(b_s[:, :K_OUT]),
                              jnp.asarray(b_sl[:, :K_OUT]), KK, K_OUT)
    jsc, jsl = np.asarray(jsc), np.asarray(jsl)
    tsc, tsl = annex.annex_merge(tcfg, ts, torch.from_numpy(qn),
                                 torch.from_numpy(b_s), torch.from_numpy(b_sl),
                                 KK, K_OUT)
    tsc, tsl = tsc.numpy(), tsl.numpy()
    assert tsc.shape == tsl.shape == (B, K_OUT) and tsl.dtype == np.int64
    hit = jsc > -5e29
    np.testing.assert_array_equal(tsc > -5e29, hit)
    assert (tsl[~hit] == -1).all()
    assert_topk_match(np.where(hit, tsl, -1), np.where(hit, tsc, 0.0),
                      np.where(hit, jsl, -1), np.where(hit, jsc, 0.0),
                      SCORE_TOL)
    for r in range(B):                  # tied lanes hold the same slots
        for v in np.unique(jsc[r][hit[r]]):
            same = np.abs(jsc[r] - v) <= SCORE_TOL
            assert set(tsl[r][same]) == set(jsl[r][same]), (r, v)
    if G:
        assert np.isin(tsl[hit], arrays["cluster_slot"][-G:]).any()
    if kind == "ties":
        assert abs(tsc[0, 0] - tsc[0, 1]) <= SCORE_TOL
