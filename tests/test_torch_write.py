"""Write path: `write_memories`, `bulk_load`, `decay_memories`, `tick` of
the port against the JAX package, on an empty bank and on a live index
(FIFO wrap included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.memory import state as jstate
from aura_snn_rag_tpu_torch.memory import engine as tengine
from tests.test_torch_common import (
    built_jax_state, configs, highest, make_data, np_state, to_port)

torch.set_num_threads(1)

EXACT = ("locations", "strength", "timestamp", "centroid_id", "slot_gen",
         "centroid_counts", "cluster_slot", "cluster_gen", "cluster_ts",
         "cluster_decay", "cluster_loc", "bucket_fill", "count", "step",
         "decay_accum", "index_ready")


def _compare(ts, js, coarse):
    t, j = np_state(ts), np_state(js)
    for name in EXACT:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    np.testing.assert_array_equal(t.features, j.features)
    # centroid eta = 1/n updates: the same f32 formula, but the L2 norm
    # feeding the nearest-centroid search sums in another order
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=0, atol=1e-5)
    # coarse copies of the normalised rows: the f32 norm may differ in its
    # last bit, which moves a bf16 value by at most one ulp and an int8
    # level by at most one
    np.testing.assert_allclose(t.clustered, j.clustered, rtol=2 ** -7,
                               atol=1e-6)
    if coarse == "int8":
        assert np.abs(t.features_nb16.astype(int)
                      - j.features_nb16.astype(int)).max() <= 1
        np.testing.assert_allclose(t.coarse_scale, j.coarse_scale,
                                   rtol=1e-6)
    else:
        np.testing.assert_allclose(t.features_nb16, j.features_nb16,
                                   rtol=2 ** -7, atol=1e-6)
        np.testing.assert_array_equal(t.coarse_scale, j.coarse_scale)


@pytest.mark.parametrize("coarse", ["bf16", "int8"])
def test_write_and_bulk_load_on_empty_bank(coarse):
    jcfg, tcfg = configs(coarse_dtype=coarse)
    feats = make_data(1, 1300)
    locs = np.random.RandomState(2).randn(1300, 2).astype(np.float32)
    with highest():
        js = jstate.init_memory_state(jcfg)
        js = jengine.bulk_load(jcfg, js, jnp.asarray(feats[:1000]),
                               jnp.asarray(locs[:1000]))
        js = jengine.tick(js, 3.0)
        js = jengine.write_memories(jcfg, js, jnp.asarray(feats[1000:]),
                                    jnp.asarray(locs[1000:]))
    ts = port.init_memory_state(tcfg, device="cpu")
    ts = port.bulk_load(tcfg, ts, torch.from_numpy(feats[:1000]),
                        torch.from_numpy(locs[:1000]))
    ts = tengine.tick(ts, 3.0)
    ts = port.write_memories(tcfg, ts, torch.from_numpy(feats[1000:]),
                             torch.from_numpy(locs[1000:]))
    assert int(ts.count) == 1300 and not bool(ts.index_ready)
    _compare(ts, js, coarse)


@pytest.mark.parametrize("coarse", ["bf16", "int8"])
def test_write_on_live_index_with_fifo_wrap(coarse):
    """4000 rows indexed, then 300 more: slots 4000..4095 and 0..203 take
    the new rows; each row joins its nearest centroid's bucket ring."""
    jcfg, tcfg = configs(coarse_dtype=coarse)
    feats = make_data(3, 4300)
    locs = np.random.RandomState(4).randn(300, 2).astype(np.float32)
    js = built_jax_state(jcfg, feats[:4000])
    with highest():
        js = jengine.decay_memories(js, 0.2)
        js = jengine.tick(js, 7.0)
        ts = to_port(js)
        js = jengine.write_memories(jcfg, js, jnp.asarray(feats[4000:]),
                                    jnp.asarray(locs))
    ts = port.write_memories(tcfg, ts, torch.from_numpy(feats[4000:]),
                             torch.from_numpy(locs))
    assert int(ts.count) == 4300 and bool(ts.index_ready)
    _compare(ts, js, coarse)


def test_decay_and_tick():
    jcfg, tcfg = configs()
    feats = make_data(5, 500)
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(feats),
                               jnp.zeros((500, 2), jnp.float32))
        ts = to_port(js)
        for rate in (0.01, 0.3, 0.05):
            js = jengine.decay_memories(js, rate)
            ts = port.decay_memories(ts, rate)
        js = jengine.tick(js, 2.5)
    ts = tengine.tick(ts, 2.5)
    t, j = np_state(ts), np_state(js)
    np.testing.assert_array_equal(t.strength, j.strength)
    np.testing.assert_allclose(t.decay_accum, j.decay_accum, rtol=1e-7)
    assert float(t.step) == float(j.step) == 2.5
