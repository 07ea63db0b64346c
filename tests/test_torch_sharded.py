"""The port's sharded bank (`memory/sharded.py`) against the JAX package's,
on the same inputs: the JAX side on the virtual CPU devices of this
process, the port's on gloo ranks (`test_torch_ranks.spawn`), one spawned
group per mesh: ('data', 'model') of (2, 1) and (4, 1), and the
multislice ('replica', 'data', 'model') of (2, 2, 1).

Each rank writes its rows of one batch, retrieves (brute force on the
fresh bank), decays, rebuilds from the initial rows the JAX package's
split keys draw (injected through `_rebuild_from_init`, as
`test_torch_rebuild.py` does), then retrieves through IVF (kernel B's
plain version) and the flat scan, and takes the gradient of the scores
with respect to a query projection. Shard s of the port is held to row s
of JAX's stacked state:
- written shards bit-equal (the bf16 coarse copy within one ulp, as
  `test_torch_write.py` holds it); decay within 1e-6;
- retrieval slots equal, scores within 1e-5, features equal;
- the rebuilt index within `test_torch_rebuild.py`'s gap (rows a few
  ulp apart may swap places inside a bucket: under 0.2% of positions);
- the projection's gradient within 1e-5 of the RMS of JAX's.
Sizes: 1024 rows per shard (half filled), D = 32, K = 16, probe 2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.memory import sharded as jsharded
from aura_snn_rag_tpu.parallel.distributed import multislice_mesh
from aura_snn_rag_tpu_torch.memory import sharded as tsharded
from aura_snn_rag_tpu_torch.memory import state as tstate
from tests.test_torch_common import highest, make_data, np_state
from tests.test_torch_ranks import spawn

MEMORY = dict(max_memories=1024, feature_dim=32, k_centroids=16, spill_rounds=1,
              probe_centroids=2, n_place_cells=8, n_grid_cells=4,
              n_time_cells=4)
ROWS = 512                   # written per shard
K = 5
DECAY = 0.3
SCORE_TOL = 1e-5
DECAY_TOL = 1e-6
GRAD_TOL = 1e-5              # of the RMS of JAX's gradient
REBUILD_GAP = 0.002          # share of bucket positions that may differ
SHAPES = [(2,), (4,), (2, 2)]


def jax_mesh(shape):
    n = int(np.prod(shape))
    devs = jax.devices()[:n]
    if len(shape) == 1:
        return Mesh(np.asarray(devs).reshape(n, 1), ("data", "model")), \
            "data"
    return multislice_mesh(shape[0], 1, devices=devs), ("replica", "data")


def jax_init_idx(jcfg, st, key):
    """The rows `rebuild_centroids` starts from (engine.py:966-969)."""
    M, Kc = st.max_memories, st.k_centroids
    Ku = Kc - min(jcfg.overflow_buckets, Kc // 4)
    active = jnp.arange(M) < st.active_count()
    r = jax.random.uniform(key, (M,)) + jnp.where(active, 0.0, 1e9)
    return np.asarray(jax.lax.top_k(-r, Ku)[1])


def jax_result(res):
    return {name: np.asarray(getattr(res, name))
            for name in ("indices", "scores", "features")}


def inputs_for(S):
    rng = np.random.RandomState(S)
    feats = make_data(S, S * ROWS, d=MEMORY["feature_dim"], n_centers=16)
    near = lambda idx: (feats[idx] + 0.05 * rng.randn(
        len(idx), MEMORY["feature_dim"])).astype(np.float32)
    return dict(
        feats=feats,
        queries=near(rng.randint(0, len(feats), 5)),
        ivf_queries=near(rng.randint(0, len(feats), 3)),
        flat_queries=near(rng.randint(0, len(feats), 8)),
        x=near(rng.randint(0, len(feats), 3)),
        W=(np.eye(32) + 0.1 * rng.randn(32, 32)).astype(np.float32),
        cw=rng.randn(3, K).astype(np.float32),
        decay=np.float32(DECAY))


@functools.lru_cache(maxsize=None)
def jax_run(shape):
    """The JAX package's sharded bank through the same steps, each call
    under `jax.jit` (an eager shard_map compiles op by op: ~100x
    slower on the CPU)."""
    S = int(np.prod(shape))
    inp = inputs_for(S)
    jcfg = jconfig.MemoryConfig(**MEMORY)
    mesh, axis = jax_mesh(shape)

    def jit(fn, **kw):
        return jax.jit(functools.partial(fn, jcfg, mesh, **kw))
    retrieve = jit(jsharded.retrieve_sharded, k=K, axis=axis)
    out = {}
    with highest():
        st = jsharded.init_sharded_memory(jcfg, mesh, axis)
        st = jit(jsharded.write_memories_sharded, axis=axis)(
            st, jnp.asarray(inp["feats"]), jnp.zeros((S * ROWS, 2)))
        out["written"] = np_state(st)
        out["fresh"] = jax_result(retrieve(st, jnp.asarray(inp["queries"])))
        st = jsharded.decay_memories_sharded(st, DECAY)
        out["decayed"] = np_state(st)
        key = jax.random.PRNGKey(7)
        keys = jax.random.split(key, S)
        inp["init_idx"] = np.stack([
            jax_init_idx(jcfg, jax.tree.map(lambda x: x[s], st), keys[s])
            for s in range(S)])
        st = jit(jsharded.rebuild_centroids_sharded, axis=axis)(st, key)
        out["rebuilt"] = np_state(st)
        for name in ("ivf", "flat"):
            out[name] = jax_result(retrieve(
                st, jnp.asarray(inp[f"{name}_queries"])))

        @jax.jit
        def loss(W):
            res = retrieve(st, jnp.asarray(inp["x"]) @ W)
            return (res.scores * inp["cw"]).sum(), res
        (_, res), g = jax.value_and_grad(loss, has_aux=True)(
            jnp.asarray(inp["W"]))
        out["grad_forward"] = jax_result(res)
        out["grad_W"] = np.asarray(g)
    return inp, out


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def run(request, tmp_path_factory):
    shape = request.param
    inp, want = jax_run(shape)
    outs = spawn("sharded_bank", int(np.prod(shape)),
                 tmp_path_factory.mktemp("ranks"), inp, shape=shape,
                 memory=MEMORY, k=K)
    return shape, want, outs


def shards(outs, prefix):
    """The port's shards (rank s holds shard s at 'model' size 1) as one
    stacked numpy state."""
    return tstate.MemoryState(*[np.stack([o[f"{prefix}/{name}"]
                                          for o in outs])
                                for name in tstate.MemoryState._fields])


def assert_result(got, want):
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got["features"], want["features"], rtol=0,
                               atol=0)


def rank_results(outs, prefix):
    return [{name: o[f"{prefix}/{name}"]
             for name in ("indices", "scores", "features")} for o in outs]


def test_written_shards_are_bit_equal(run):
    """Every field bit for bit but the bf16 coarse copy of the normalised
    rows, held as `test_torch_write.py` holds the unsharded write: the
    f32 norm may differ in its last bit, which moves a bf16 value by at
    most one ulp."""
    shape, want, outs = run
    got = shards(outs, "written")
    for name, a, b in zip(tstate.MemoryState._fields, got,
                          want["written"]):
        if name == "features_nb16":
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.count == ROWS).all()


@pytest.mark.parametrize("prefix", ["fresh", "ivf", "flat",
                                    "grad_forward"])
def test_retrieval_matches_on_every_rank(run, prefix):
    """Brute force on the fresh bank, IVF (B = 3) and the flat scan
    (B = 8) on the rebuilt one: every rank returns JAX's result."""
    _, want, outs = run
    for got in rank_results(outs, prefix):
        assert_result(got, want[prefix])
    if prefix != "fresh":
        assert (want[prefix]["indices"] >= 0).all()


def test_decay_matches(run):
    _, want, outs = run
    got = shards(outs, "decayed")
    for name in ("strength", "decay_accum"):
        np.testing.assert_allclose(getattr(got, name),
                                   getattr(want["decayed"], name),
                                   rtol=0, atol=DECAY_TOL, err_msg=name)


def test_rebuild_from_injected_rows_matches(run):
    _, want, outs = run
    got, ref = shards(outs, "rebuilt"), want["rebuilt"]
    np.testing.assert_allclose(got.centroids, ref.centroids, rtol=0,
                               atol=2e-5)
    for name in ("centroid_counts", "centroid_id", "bucket_fill",
                 "index_ready", "count"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    differ = (got.cluster_slot != ref.cluster_slot).mean()
    assert differ < REBUILD_GAP, differ
    assert np.asarray(ref.index_ready).all()


def test_query_gradient_through_the_merge_matches(run):
    _, want, outs = run
    ref = want["grad_W"]
    rms = np.sqrt((ref ** 2).mean())
    assert rms > 0
    for o in outs:
        np.testing.assert_allclose(o["grad_W"], ref, rtol=0,
                                   atol=GRAD_TOL * rms)


def test_stacked_layout_round_trips():
    """`shard_of` / `stack_shards` carry a JAX stacked state in and out."""
    _, want = jax_run((2,))
    stacked = want["written"]
    back = tsharded.stack_shards([tsharded.shard_of(stacked, s, "cpu")
                                  for s in range(2)])
    for name, a, b in zip(tstate.MemoryState._fields, back, stacked):
        np.testing.assert_array_equal(a, b, err_msg=name)
