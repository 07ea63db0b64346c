"""Index rebuild: the port's `_rebuild_from_init` against the JAX package's
`rebuild_centroids`, fed the same initial centroid rows.

`jax.random.uniform` draws the initial rows in the JAX package; torch
cannot reproduce that stream, so the test recomputes the JAX package's
`init_idx` from the same key and hands it to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.memory import state as jstate
from aura_snn_rag_tpu_torch.memory import engine as tengine
from tests.test_torch_common import (
    configs, highest, make_data, np_state, to_port)

torch.set_num_threads(1)


def _jax_init_idx(jcfg, js, key):
    """The rows `rebuild_centroids` (engine.py:966-969) starts from."""
    M, K = js.max_memories, js.k_centroids
    Ku = K - min(jcfg.overflow_buckets, K // 4)
    active = jnp.arange(M) < js.active_count()
    r = jax.random.uniform(key, (M,)) + jnp.where(active, 0.0, 1e9)
    return np.asarray(jax.lax.top_k(-r, Ku)[1])


def _by_slot(st, n):
    """Per bank slot: its bucket and the payload stored beside it."""
    r, c = np.nonzero(st.cluster_slot >= 0)
    s = st.cluster_slot[r, c]
    assert len(np.unique(s)) == len(s)                  # no row twice
    out = {"bucket": np.full(n, -1)}
    out["bucket"][s] = r
    for name, arr in (("gen", st.cluster_gen), ("ts", st.cluster_ts),
                      ("decay", st.cluster_decay), ("loc", st.cluster_loc),
                      ("row", st.clustered)):
        v = np.zeros((n,) + arr.shape[2:], arr.dtype)
        v[s] = arr[r, c]
        out[name] = v
    return out


@pytest.mark.parametrize("n,overprov", [(4096, 2.0), (3800, 1.0), (700, 2.0)])
def test_rebuild_from_init_matches_jax(n, overprov):
    """Full bank, a bank that overflows into the annex (C = 128 at
    overprovision 1.0), and a partly filled bank."""
    jcfg, tcfg = configs(bucket_overprovision=overprov)
    feats = make_data(n, n, noise=1.5)
    key = jax.random.PRNGKey(3)
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(feats),
                               jnp.zeros((n, 2), jnp.float32))
        js = jengine.decay_memories(js, 0.1)
        ts = to_port(js)
        init_idx = _jax_init_idx(jcfg, js, key)
        jr = np_state(jengine.rebuild_centroids(jcfg, js, key))
    tr = np_state(tengine._rebuild_from_init(
        tcfg, ts, torch.from_numpy(init_idx.copy())))
    # centroids: the same f32 means, summed in another order
    np.testing.assert_allclose(tr.centroids, jr.centroids, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tr.centroid_counts, jr.centroid_counts)
    np.testing.assert_array_equal(tr.centroid_id, jr.centroid_id)
    np.testing.assert_array_equal(tr.bucket_fill, jr.bucket_fill)
    assert bool(tr.index_ready) == bool(jr.index_ready)
    # the layout: every row in the same bucket with the same payload. The
    # order inside a bucket follows f32 distances, which the two packages
    # sum in another order, so two rows a few ulp apart may swap places.
    jm, tm = _by_slot(jr, n), _by_slot(tr, n)
    for name in ("bucket", "gen", "ts", "loc"):
        np.testing.assert_array_equal(tm[name], jm[name], err_msg=name)
    np.testing.assert_allclose(tm["decay"], jm["decay"], rtol=0, atol=1e-6)
    # bf16 copies of the normalised rows: at most one bf16 ulp apart
    # (the f32 norms can differ in the last bit)
    np.testing.assert_allclose(tm["row"], jm["row"], rtol=2 ** -7,
                               atol=1e-6)
    assert (tr.cluster_slot != jr.cluster_slot).mean() < 0.002
    if overprov == 1.0:
        G = min(jcfg.overflow_buckets, jcfg.k_centroids // 4)
        assert (tr.cluster_slot[-G:] >= 0).sum() > 100    # annex in use


def test_rebuild_centroids_seeded_and_device_independent_draw():
    """The port's own init: K - G distinct active rows from a CPU
    generator, so one seed gives one index."""
    _, tcfg = configs()
    feats = make_data(1, 2000)
    import aura_snn_rag_tpu_torch as port
    outs = []
    for _ in range(2):
        st = port.init_memory_state(tcfg, device="cpu")
        st = port.bulk_load(tcfg, st, torch.from_numpy(feats),
                            torch.zeros(2000, 2))
        st = port.rebuild_centroids(tcfg, st,
                                    torch.Generator().manual_seed(5))
        outs.append(st)
    assert torch.equal(outs[0].cluster_slot, outs[1].cluster_slot)
    assert bool(outs[0].index_ready)
    live = outs[0].cluster_slot[outs[0].cluster_slot >= 0]
    assert len(torch.unique(live)) == 2000
