"""IVF v2 and v3: kernels E (`ivf_topk_scores`) and D (`ivf_candidates`)
through their plain versions against the Pallas kernels in interpret mode,
and the port's `retrieve` on the v2 and v3 branches (and the v3r -> v2
fallback) against the JAX package on the same states.

The JAX package takes its kernel branches on the CPU only with
AURA_PALLAS_INTERPRET=1, which every test in this file sets.
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
from aura_snn_rag_tpu.ops.pallas import ivf_scan as jivf
from aura_snn_rag_tpu_torch.memory import engine as tengine
from aura_snn_rag_tpu_torch.ops.cuda import ivf_scan as tivf
from tests.test_torch_common import (
    SMALL, assert_topk_match, bank_pair, built_jax_state, configs, highest,
    ivf_kernel_inputs, make_data, queries_near, result_np, retrieve_both,
    spy_ivf_kernels, to_port)
from tests.test_torch_probes import crowded_probes

torch.set_num_threads(1)

SCORE_TOL = 1e-5      # exact f32 rerank, dot products in another order
COARSE_TOL = 1e-5     # aux0 * cos + aux1, bf16 products summed in f32 in
                      # another order: a few ulp of values below 2
DEAD = -5e29


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AURA_PALLAS_INTERPRET", "1")


def _live_match(ts, tsl, js, jsl):
    """Live lanes (coarse score above -5e29) agree: the same lanes are live,
    scores within COARSE_TOL, slots wherever the score is clear of its
    neighbours. Dead lanes may hold any dead entry in either package."""
    live = js > DEAD
    assert (live == (ts > DEAD)).all()
    assert_topk_match(np.where(live, tsl, -1), np.where(live, ts, 0.0),
                      np.where(live, jsl, -1), np.where(live, js, 0.0),
                      COARSE_TOL)


# --------------------------------------------------------------------------
# kernels E and D: plain versions against the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("C", [128, 200, 256])     # 200: not a multiple of 64
def test_ivf_topk_scores_plain_matches_pallas_kernel(k, C):
    jx, tx = ivf_kernel_inputs(C + k, C=C)
    cl, aux, _, qn, top_c = jx
    with highest():
        js, jsl = (np.asarray(x) for x in jivf.ivf_topk_scores(
            cl, aux, qn, top_c, k, interpret=True))
    tcl, taux, _, tqn, ttop = tx
    ts, tsl = (x.numpy() for x in tivf.ivf_topk_scores(tcl, taux, tqn,
                                                       ttop, k))
    B, P = ttop.shape
    assert ts.shape == tsl.shape == (B, P, 128)
    assert tsl.dtype == np.int32
    _live_match(ts[..., :k].reshape(B * P, k), tsl[..., :k].reshape(B * P, k),
                js[..., :k].reshape(B * P, k), jsl[..., :k].reshape(B * P, k))
    # each probe's lanes sorted descending
    assert (np.diff(ts[..., :k], axis=-1) <= 0).all()
    # pad lanes, as the TPU kernel initialises them
    assert (ts[..., k:] == np.float32(-1e30)).all()
    assert (tsl[..., k:] == 0).all()


@pytest.mark.parametrize("kk", [128, 256, 1024])     # 1024 = P*C: every entry
def test_ivf_candidates_plain_matches_pallas_kernel(kk):
    _assert_candidates_match(*ivf_kernel_inputs(kk + 7), kk)


# Crowded probes, the inputs on which a card's kernel D takes the
# cluster-major coarse pass: 32 queries over 16 clusters ("shared"), or
# every query on the same 4 clusters ("same").
@pytest.mark.parametrize("hot", [0, 4], ids=["shared", "same"])
def test_ivf_candidates_plain_matches_pallas_kernel_at_crowded_probes(hot):
    B, K, P, kk = 32, 16, 4, 256
    inputs = ivf_kernel_inputs(
        91, K=K, B=B, P=P,
        probes=lambda rng: crowded_probes(rng, K, B, P, hot=hot))
    _assert_candidates_match(*inputs, kk)


def _assert_candidates_match(jx, tx, kk):
    cl, aux, _, qn, top_c = jx
    with highest():
        js, jsl = (np.asarray(x) for x in jivf.ivf_candidates(
            cl, aux, qn, top_c, kk, interpret=True))
    tcl, taux, _, tqn, ttop = tx
    ts, tsl = (x.numpy() for x in tivf.ivf_candidates(tcl, taux, tqn, ttop,
                                                      kk))
    assert ts.shape == tsl.shape == (ttop.shape[0], kk)
    assert tsl.dtype == np.int32
    _live_match(ts, tsl, js, jsl)
    assert (np.diff(ts, axis=1) <= 0).all()
    if kk == ttop.shape[1] * tcl.shape[1]:
        assert (ts <= DEAD).any()         # the dead entries come last


def test_select_kernels_reject_what_they_cannot_take():
    _, (cl, aux, _, qn, top_c) = ivf_kernel_inputs(1, C=128)
    with pytest.raises(ValueError, match="ivf_topk_scores"):
        tivf.ivf_topk_scores(cl, aux, qn, top_c, 129)
    with pytest.raises(ValueError, match="ivf_candidates"):
        tivf.ivf_candidates(cl, aux, qn, top_c, 200)      # not lane-aligned
    with pytest.raises(ValueError, match="ivf_candidates"):
        tivf.ivf_candidates(cl, aux, qn, top_c, 640)      # > P*C = 512
    # above the 16384 keys kernel D holds in shared memory, though
    # P*C = 16896 would have room
    _, (cl, aux, _, qn, top_c) = ivf_kernel_inputs(2, K=40, C=512, D=8,
                                                    P=33, M=64)
    with pytest.raises(ValueError, match="16384"):
        tivf.ivf_candidates(cl, aux, qn, top_c, 16512)


# --------------------------------------------------------------------------
# retrieve: the v2 and v3 branches against the JAX package
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bank_4092():
    """A built bank with max_memories % 8 != 0 (v3r must fall back)."""
    jcfg, _ = configs(max_memories=4092)
    feats = make_data(51, 4092)
    js = built_jax_state(jcfg, feats, seed=2)
    return jax.tree.map(np.asarray, js), feats


@pytest.mark.parametrize("entry", ["retrieve", "retrieve_auto"])
def test_v3r_falls_back_to_v2_when_bank_rows_not_multiple_of_8(
        monkeypatch, entry):
    arrays, feats = _bank_4092()
    jcfg, tcfg = configs(max_memories=4092)        # ivf_kernel "v3r"
    js = jax.tree.map(jnp.asarray, arrays)
    ts = port.state_from_numpy(arrays, "cpu")
    q = queries_near(feats, 52, 2)                 # 2 * 4 * 256 < M: IVF
    calls = spy_ivf_kernels(monkeypatch)
    with highest():
        jr = result_np(getattr(jengine, entry)(jcfg, js, jnp.asarray(q),
                                               None, 10))
    tr = result_np(getattr(port, entry)(tcfg, ts, torch.from_numpy(q),
                                        None, 10))
    assert calls == ["ivf_topk_scores"]
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)


@pytest.mark.parametrize("kernel,k,M,K,want", [
    ("v3", 130, 4096, 32, "ivf_candidates"),      # v3 takes k > 128
    ("v3", 5, 64, 256, "ivf_topk_scores"),        # C = 8: P*C = 32 < 128
    ("v3r", 5, 64, 256, "ivf_topk_scores"),
])
def test_branch_conditions_are_the_jax_packages(monkeypatch, kernel, k, M, K,
                                                want):
    """The branch each configuration takes where `test_retrieve_matches`
    does not reach it, and the JAX package's top-k from it (at C = 8 the
    index is empty and both return no hit)."""
    jcfg, tcfg = configs(max_memories=M, k_centroids=K, ivf_kernel=kernel)
    rows = min(M, 512)
    feats = make_data(53, rows)
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(feats),
                               jnp.zeros((rows, 2), jnp.float32))
        if K < M:
            js = jengine.rebuild_centroids(jcfg, js, jax.random.PRNGKey(3))
    ts = to_port(js)
    q = queries_near(feats, 54, 2)
    calls = spy_ivf_kernels(monkeypatch)
    jr, tr = retrieve_both(jcfg, tcfg, js, ts, q, None, k)
    assert calls == [want]
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)


def test_v2_fallback_wider_than_128_per_probe_raises():
    """v3r with k > 128 falls back to v2, whose per-probe width k exceeds
    the kernel's 128 lanes: the JAX package fails its assertion, the port
    raises ValueError and says why."""
    jcfg, tcfg, js, ts, feats = bank_pair("bf16")
    q = queries_near(feats, 26, 2)
    with pytest.raises(AssertionError):
        with highest():
            jengine.retrieve(jcfg, js, jnp.asarray(q), None, 130)
    with pytest.raises(ValueError, match="k=130"):
        port.retrieve(tcfg, ts, torch.from_numpy(q), None, 130)


# --------------------------------------------------------------------------
# mirrors of tests/memory/test_ivf_v2.py on the port
# --------------------------------------------------------------------------

def _mk_cfgs(n, **kw):
    """tests/memory/test_ivf_v2.py's small configuration, both packages."""
    cfg = dict(max_memories=n, feature_dim=64, k_centroids=16,
               probe_centroids=4, retrieve_k=5, bucket_overprovision=2.0,
               rebuild_lloyd_iters=2, n_place_cells=8, n_grid_cells=4,
               n_time_cells=2, **kw)
    return jconfig.MemoryConfig(**cfg), port.MemoryConfig(**cfg)


@pytest.mark.parametrize("kernel", ["v2", "v3"])
def test_partial_bank_fewer_live_rows_than_funnel(kernel):
    """40 live rows, a 128-wide funnel: dead lanes come back as no-hit
    (-1, score 0), never as a duplicate of a live slot."""
    rng = np.random.RandomState(10)
    N, used = 2048, 40
    jcfg, tcfg = _mk_cfgs(N, ivf_kernel=kernel)
    feats = rng.randn(used, 64).astype(np.float32)
    js = built_jax_state(jcfg, feats)
    q = feats[:3]
    jr, tr = retrieve_both(jcfg, tcfg, js, to_port(js), q, None, 5)
    idx, sc = tr[0], tr[1]
    assert ((idx >= -1) & (idx < used)).all()
    assert (idx[:, 0] == np.arange(3)).all()          # self-retrieval
    assert ((idx >= 0) | (sc == 0.0)).all()
    assert np.isfinite(sc).all()
    for row in idx:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live), row
    assert_topk_match(idx, sc, jr[0], jr[1], SCORE_TOL)
    # the plain gather path of the port agrees
    plain = result_np(port.retrieve(
        dataclasses.replace(tcfg, use_pallas_ivf=False), to_port(js),
        torch.from_numpy(q), None, 5))
    np.testing.assert_array_equal(idx, plain[0])


@pytest.mark.parametrize("kernel", ["v2", "v3"])
def test_decay_and_fifo_overwrite_shape_the_ranking(kernel):
    """Strength decay and FIFO liveness ride in the aux rows: after heavy
    decay, a fresh write of query 0's vector (overwriting slot 0) wins.
    Decay and write run in each package on its own state."""
    rng = np.random.RandomState(2)
    N = 512
    jcfg, tcfg = _mk_cfgs(N, ivf_kernel=kernel)
    feats = rng.randn(N, 64).astype(np.float32)
    js = built_jax_state(jcfg, feats)
    ts = to_port(js)
    q = feats[:2]
    with highest():
        for _ in range(8):
            js = jengine.decay_memories(js, 0.5)
        js = jengine.write_memories(jcfg, js, jnp.asarray(q[:1]),
                                    jnp.zeros((1, 2), np.float32))
    for _ in range(8):
        ts = port.decay_memories(ts, 0.5)
    ts = port.write_memories(tcfg, ts, torch.from_numpy(q[:1]),
                             torch.zeros(1, 2))
    jr, tr = retrieve_both(jcfg, tcfg, js, ts, q, None, 5)
    assert tr[0][0, 0] == N % tcfg.max_memories
    # every other row carries strength 0.5^8 = 1/256
    assert (tr[1][0, 1:] < tr[1][0, 0] / 100).all()
    assert np.isfinite(tr[1]).all()
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)


@functools.lru_cache(maxsize=None)
def _annexed_bank():
    """K = 16, overprovision 1.0 -> C = 256: 12 real clusters hold 3072 of
    3800 rows, the 4-bucket annex the rest."""
    cfg = dict(max_memories=4096, feature_dim=64, k_centroids=16,
               probe_centroids=4, retrieve_k=5, bucket_overprovision=1.0,
               rebuild_lloyd_iters=2, n_place_cells=8, n_grid_cells=4,
               n_time_cells=2)
    feats = np.random.RandomState(11).randn(3800, 64).astype(np.float32)
    js = built_jax_state(jconfig.MemoryConfig(**cfg), feats)
    return cfg, jax.tree.map(np.asarray, js), feats


@pytest.mark.parametrize("kernel", ["v2", "v3", "v3r"])
def test_annexed_rows_reachable_on_every_kernel(kernel):
    cfg, arrays, feats = _annexed_bank()
    jcfg = jconfig.MemoryConfig(**cfg, ivf_kernel=kernel)
    tcfg = port.MemoryConfig(**cfg, ivf_kernel=kernel)
    K, C = arrays.cluster_slot.shape
    G = min(jcfg.overflow_buckets, K // 4)
    annexed = sorted(set(int(x) for x in arrays.cluster_slot[K - G:]
                         .reshape(-1) if x >= 0))
    assert len(annexed) > 200                          # annex actually used
    sample = np.asarray(annexed[:8] + [0, 1, 2, 3])
    js = jax.tree.map(jnp.asarray, arrays)
    jr, tr = retrieve_both(jcfg, tcfg, js, port.state_from_numpy(arrays, "cpu"),
                           feats[sample], None, 3)
    np.testing.assert_array_equal(tr[0][:, 0], sample)
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)


@pytest.mark.parametrize("kernel", ["v2", "v3"])
def test_hippocampus_aux_cache_serves_v2_and_v3(kernel):
    """HippocampalFormation's cached aux gives the engine call's result,
    before and after a mutation."""
    h = port.HippocampalFormation(device="cpu", ivf_kernel=kernel, **SMALL)
    feats = make_data(61, 1024)
    h.write_batch([f"v{i}" for i in range(1024)], feats)
    assert h.index_ready
    q = torch.from_numpy(queries_near(feats, 62, 3))
    for step in range(2):
        got = h.retrieve_batch(q, k=5)
        assert h._aux_cache is not None and h._aux_cache[0] is h.state
        want = port.retrieve(h.config, h.state, q, None, 5)
        assert torch.equal(got.indices, want.indices)
        assert torch.equal(got.scores, want.scores)
        h.decay_memories(0.3)
    assert h.retrieve_similar_memories(feats[7], k=3)[0][0] == "v7"
