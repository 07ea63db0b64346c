"""Host API and cognitive map: `HippocampalFormation` after loading the JAX
package's `state_dict()`, the cell rates on shared parameters, and the
slice end to end in the port (write -> rebuild -> flat, IVF v3r and IVF
v1 retrieval -> host API)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.memory import cognitive_map as jcm
from aura_snn_rag_tpu.memory.hippocampus import (
    HippocampalFormation as JaxFormation)
from tests.test_torch_common import (
    SMALL, assert_topk_match, highest, make_data, queries_near)

torch.set_num_threads(1)

SCORE_TOL = 1e-5      # exact f32 rerank, dot products in another order


def test_cognitive_map_rates_match():
    import jax
    cfg = port.MemoryConfig(n_place_cells=64, n_grid_cells=32,
                            n_time_cells=16)
    params = jcm.init_cognitive_map(jax.random.PRNGKey(0), cfg)
    tparams = port.CognitiveMapParams(
        *[torch.from_numpy(np.array(x)) for x in params])
    loc = np.random.RandomState(0).randn(5, 2).astype(np.float32) * 4
    elapsed = np.array([0.0, 3.0, 70.0, 900.0], np.float32)
    for jfn, tfn, x in (
            (jcm.place_cell_rates, port.place_cell_rates, loc),
            (jcm.grid_cell_rates, port.grid_cell_rates, loc),
            (jcm.time_cell_rates, port.time_cell_rates, elapsed)):
        want = np.asarray(jfn(params, jnp.asarray(x)))
        got = tfn(tparams, torch.from_numpy(x)).numpy()
        # transcendental functions of two libraries: a few f32 ulp of the
        # rates (<= 25)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    # the port's own parameters: same shapes and ranges, seeded
    own = port.init_cognitive_map(torch.Generator().manual_seed(1), cfg,
                                  device="cpu")
    for a, b in zip(own, params):
        assert tuple(a.shape) == tuple(b.shape)
    assert float(own.place_centers.abs().max()) <= 10.0


def _jax_formation(monkeypatch, n_write=1536):
    monkeypatch.setenv("AURA_PALLAS_INTERPRET", "1")
    h = JaxFormation(seed=0, rebuild_interval=512, **SMALL)
    feats = make_data(31, n_write)
    locs = np.random.RandomState(32).randn(n_write, 2).astype(np.float32)
    with highest():
        for i in range(0, n_write, 512):
            h.write_batch([f"m{j}" for j in range(i, i + 512)],
                          feats[i:i + 512], locs[i:i + 512])
        h.decay_memories(0.05)
        h.tick(30.0)
    return h, feats


def test_load_jax_state_dict_and_retrieve(monkeypatch):
    jh, feats = _jax_formation(monkeypatch)
    assert jh.index_ready
    th = port.HippocampalFormation(device="cpu", **SMALL)
    th.load_state_dict(jh.state_dict())
    assert th.memory_count == jh.memory_count and th.index_ready
    q = queries_near(feats, 33, 4)
    qloc = np.random.RandomState(34).randn(4, 2).astype(np.float32)
    for loc in (None, qloc):        # v3r kernel path, v1 kernel path
        with highest():
            jr = jh.retrieve_batch(jnp.asarray(q), None if loc is None
                                   else jnp.asarray(loc), k=8)
        tr = th.retrieve_batch(q, loc, k=8)
        assert_topk_match(tr.indices.numpy(), tr.scores.numpy(),
                          np.asarray(jr.indices), np.asarray(jr.scores),
                          SCORE_TOL)
    with highest():
        jl = jh.retrieve_similar_memories(q[0], k=5)
    tl = th.retrieve_similar_memories(q[0], k=5)
    assert [m for m, _ in tl] == [m for m, _ in jl]
    np.testing.assert_allclose([s for _, s in tl], [s for _, s in jl],
                               rtol=0, atol=SCORE_TOL)
    sd = th.state_dict()
    assert sd["slot_ids"] == jh.state_dict()["slot_ids"]
    # contexts read the loaded cognitive map
    np.testing.assert_allclose(
        th.get_spatial_context()["place_cells"].numpy(),
        np.asarray(jh.get_spatial_context()["place_cells"]), atol=2e-5)


def test_state_dict_round_trip():
    h = port.HippocampalFormation(device="cpu", seed=3, **SMALL)
    feats = make_data(36, 600)
    h.write_batch([f"r{i}" for i in range(600)], feats,
                  np.random.RandomState(37).randn(600, 2))
    h.decay_memories(0.2)
    g = port.HippocampalFormation(device="cpu", **SMALL)
    g.load_state_dict(h.state_dict())
    for a, b in zip(h.state, g.state):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(h.cognitive_map, g.cognitive_map):
        assert torch.equal(a, b)
    q = feats[5]
    assert (g.retrieve_similar_memories(q, k=4)
            == h.retrieve_similar_memories(q, k=4))
    assert g.retrieve_similar_memories(q, k=1)[0][0] == "r5"


def test_aux_cache_follows_every_mutation():
    h = port.HippocampalFormation(device="cpu", **SMALL)
    feats = make_data(35, 1024)
    h.write_batch([f"a{i}" for i in range(1024)], feats)
    assert h.index_ready
    q = feats[:2]
    h.retrieve_batch(q, k=5)
    first = h._aux_cache
    assert first is not None and first[0] is h.state
    h.retrieve_batch(q, k=5)
    assert h._aux_cache is first
    for mutate in (lambda: h.decay_memories(0.3), lambda: h.tick(5.0),
                   lambda: h.write_batch(["z"], feats[:1])):
        mutate()
        assert h._aux_cache is None
        h.retrieve_batch(q, k=5)
        assert h._aux_cache[0] is h.state


@pytest.mark.parametrize("coarse", ["int8", "bf16"])
def test_slice_end_to_end_on_the_port(coarse):
    """write -> rebuild -> live writes -> every retrieval path, held
    against the port's exact brute force."""
    cfg = port.MemoryConfig(coarse_dtype=coarse, flat_score_dtype="bf16",
                            **SMALL)
    feats = make_data(41, 4096 + 300)
    st = port.init_memory_state(cfg, device="cpu")
    st = port.bulk_load(cfg, st, torch.from_numpy(feats[:4000]),
                        torch.zeros(4000, 2))
    st = port.write_memories(cfg, st, torch.from_numpy(feats[4000:4096]),
                             torch.zeros(96, 2))
    st = port.rebuild_centroids(cfg, st, torch.Generator().manual_seed(0))
    st = port.write_memories(cfg, st, torch.from_numpy(feats[4096:]),
                             torch.zeros(300, 2))          # FIFO overwrite
    q = torch.from_numpy(queries_near(feats[300:4096], 42, 64))
    exact = port.retrieve_bruteforce(cfg, st, q, None, 10).indices

    def recall(idx):
        return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                        for a, b in zip(idx, exact)])

    import dataclasses
    for strategy in ("scan", "blockmax"):
        c = dataclasses.replace(cfg, flat_strategy=strategy)
        assert recall(port.retrieve_flat(c, st, q, None, 10).indices) >= 0.99
    ivf = torch.cat([port.retrieve_auto(cfg, st, q[i:i + 2], None, 10)
                     .indices for i in range(0, 64, 2)])
    assert recall(ivf) >= 0.9
    loc = torch.zeros(64, 2)
    v1 = port.retrieve(cfg, st, q, loc, 10).indices
    assert recall(v1) >= 0.9

    h = port.HippocampalFormation(device="cpu", **dict(SMALL,
                                                       coarse_dtype=coarse))
    for i in range(0, 1024, 512):
        h.write_batch([f"e{j}" for j in range(i, i + 512)],
                      feats[i:i + 512])
    assert h.index_ready
    hits = h.retrieve_similar_memories(feats[7], k=3)
    assert hits[0][0] == "e7"
    hits = h.retrieve_similar_memories(feats[9], location=[0.0, 0.0], k=3)
    assert hits[0][0] == "e9"
