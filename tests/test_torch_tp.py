"""The port's tensor- and expert-parallel half of `parallel/mesh.py`
against the JAX package's:
- `param_specs` of every parameter of the flagship model
  (`get_full_config()`) and of `MoELanguageZone(32000)` equal
  `aura_snn_rag_tpu.parallel.mesh.param_specs` of the JAX parameter trees
  (shapes only, `jax.eval_shape`), mapped onto the port's layout as
  `models/convert.py` maps the tensors; every sharded dimension divides
  by 2 and 4 (a rank-free mirror of the slow
  `tests/parallel/test_flagship_shard_specs.py`); `param_sharding_rules`
  equals JAX's on every path; `memory_state_specs` of a bank equals
  JAX's, field by field;
- on gloo ranks ('data', 'model') of (1, 2) and (1, 4)
  (`test_torch_ranks.spawn`): `global_mesh(n_model=2)`
  (`tests/parallel/test_distributed.py::test_global_mesh_covers_all_
  devices`); the expert bank of `tests/parallel/test_expert_parallel.py`
  with its experts split by `shard_params`, sparse and dense, within
  that test's 2e-5 of JAX's; and a tensor-parallel `BatchedGenerator`
  whose greedy tokens equal the JAX package's single-device decode
  (`tests/models/test_serving.py::TestShardedServing`), with KV caches
  of H/n heads and the caller's model left whole.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.config import get_debug_config, get_full_config
from aura_snn_rag_tpu.generation.serving import (
    BatchedGenerator, GenerationRequest)
from aura_snn_rag_tpu.memory.state import init_memory_state
from aura_snn_rag_tpu.models import HippocampalTransformer
from aura_snn_rag_tpu.models.language_zone import (
    ExpertBank, MoELanguageZone)
from aura_snn_rag_tpu.parallel import mesh as jmesh
from aura_snn_rag_tpu_torch.models.convert import (
    _convert_leaf, params_from_numpy, tree_to_state_dict)
from aura_snn_rag_tpu_torch.models.language_zone import (
    MoELanguageZone as TMoELanguageZone)
from aura_snn_rag_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_ranks import spawn

torch.set_num_threads(1)

EP_TOL = 2e-5                   # tests/parallel/test_expert_parallel.py
SERVE = dict(prompt=[1, 2, 3], temperature=1e-4, max_new_tokens=4,
             batch_size=2, prompt_pad=8)


def _flat_specs(tree):
    """{'a/b/c': spec} of a JAX spec tree (without the 'params/' of a
    flax variables tree)."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jmesh._path_str(kp).removeprefix("params/"): tuple(s)
            for kp, s in leaves}


def _port_layout(path, spec, ndim):
    """A JAX spec of the flax parameter at `path` in the port's layout:
    a Dense kernel [in, out] is [out, in]; the memory attention's
    [D, H, Hd] / [H, Hd, D] kernels and [H, Hd] biases flatten their
    head dimensions (sharded where either was); everything else keeps
    flax's layout."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    parts = path.split("/")
    leaf, parent = parts[-1], parts[-2]
    if "memory_attention" in parts:
        if leaf == "kernel":
            return ((spec[2], spec[0] or spec[1]) if parent == "out"
                    else (spec[1] or spec[2], spec[0]))
        if parent != "out":
            return (spec[0] or spec[1],)
        return spec
    if leaf == "kernel" and parent not in ("syn1", "syn2") \
            and "experts" not in parts:
        return spec[::-1]
    return spec


def assert_specs_match(jparams, tmodule):
    want = {}
    for path, spec in _flat_specs(jmesh.param_specs(jparams)).items():
        key, _ = _convert_leaf(tuple(path.split("/")),
                               np.zeros((1,), np.float32))
        ndim = len(dict(tmodule.named_parameters())[key].shape)
        want[key] = _port_layout(path, spec, ndim)
    got = tmesh.param_specs(tmodule)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])
    sharded = 0
    for key, p in tmodule.named_parameters():
        for dim, axis in enumerate(got[key]):
            if axis == "model":
                assert p.shape[dim] % 4 == 0, (key, p.shape)
                sharded += 1
    assert sharded > 0
    return got


def _shapes(fn, *args):
    """A flax init's parameter tree as zero-size stand-ins of its shapes
    (ndim is all `param_specs` reads)."""
    tree = jax.eval_shape(fn, *args)
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                        tree)


def test_flagship_param_specs_match_jax():
    cfg = get_full_config()
    model = HippocampalTransformer(cfg.model, memory_config=cfg.memory)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = _shapes(lambda: model.init(
        jax.random.PRNGKey(0), ids, prosody=jnp.zeros((1, 8, 4)),
        use_memory=True, memory_state=init_memory_state(cfg.memory)))
    tcfg = port.get_full_config()
    tmodel = port.HippocampalTransformer(tcfg.model, tcfg.memory,
                                         device="meta")
    got = assert_specs_match(params, tmodel)
    # the tensor-parallel pattern: column Q/K/V, FFN up, syn1; row O,
    # FFN down, gif1_in, syn2; the embedding's features
    assert got["layers.0.attention.q_proj.weight"] == ("model", None)
    assert got["layers.0.attention.o_proj.weight"] == (None, "model")
    assert got["layers.0.ffn.snn.gif1_in.weight"] == (None, "model")
    assert got["layers.0.ffn.snn.syn2.kernel"] == ("model", None)
    assert got["semantic_encoder.token_embedding.weight"] == (None, "model")
    assert got["layers.0.query_proj.weight"] == (None, None)


def test_moe_zone_param_specs_match_jax():
    zone = MoELanguageZone(32000)
    params = _shapes(lambda: zone.init(jax.random.PRNGKey(0),
                                       jnp.zeros((2, 4), jnp.int32)))
    got = assert_specs_match(params, TMoELanguageZone(32000, device="meta"))
    experts = [k for k in got if ".experts." in k]
    assert experts and all(got[k][0] == "model" for k in experts)


def test_param_sharding_rules_match_jax():
    cfg = get_debug_config()
    model = HippocampalTransformer(
        dataclasses.replace(cfg.model, use_rag=True,
                            memory_injection="cross_attention",
                            snn_layers=(0,)), memory_config=cfg.memory)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = _shapes(lambda: model.init(
        jax.random.PRNGKey(0), ids, prosody=jnp.zeros((1, 8, 4)),
        use_memory=True, memory_state=init_memory_state(cfg.memory)))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) > 50
    for kp, x in leaves:
        path = jmesh._path_str(kp)
        assert tmesh.param_sharding_rules(path, x.ndim) == tuple(
            jmesh.param_sharding_rules(path, x.ndim)), path
    # pruning: the rules on a mesh without 'model' replicate
    tcfg = port.get_debug_config()
    tmodel = port.HippocampalTransformer(
        dataclasses.replace(tcfg.model, use_rag=True), tcfg.memory,
        device="meta")

    class DataSeq:
        mesh_dim_names = ("data", "seq")
    assert all(all(a is None for a in spec) for spec in
               tmesh.param_specs(tmodel, DataSeq()).values())


# --------------------------------------------------------------------------
# on ranks: expert parallelism, tensor-parallel serving, global_mesh
# --------------------------------------------------------------------------

def serve_lm():
    return dataclasses.replace(get_debug_config().model, dropout=0.0,
                               max_seq_len=512)


@functools.lru_cache(maxsize=None)
def jax_side():
    """The inputs of every rank and JAX's results."""
    inputs = {}
    # tests/parallel/test_expert_parallel.py::_bank_and_inputs
    B, T, D, E = 6, 4, 16, 4
    bank = ExpertBank(E, D, D, levels=4, capacity_factor=8.0)
    x = jax.random.normal(jax.random.PRNGKey(0), (B, T, D))
    rng = np.random.RandomState(0)
    idx = jnp.asarray(rng.randint(0, E, (B, 2)), jnp.int32)
    w = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (B, 2)))
    routing = {"indices": idx, "weights": w}
    params = bank.init(jax.random.PRNGKey(2), x, routing)
    # jitted, as the JAX test's sharded forward (XLA then fuses
    # dropped_fraction's 1 - sum / S, as the port does)
    y, aux = jax.jit(bank.apply)(params, x, routing)
    dense = jax.jit(bank.apply)(params, x)
    sd = tree_to_state_dict(jax.tree.map(np.asarray, params))
    inputs.update({f"ep/sd/{k}": v.numpy() for k, v in sd.items()})
    inputs.update({"ep/E": np.int64(E), "ep/D": np.int64(D),
                   "ep/x": np.asarray(x), "ep/idx": np.asarray(idx),
                   "ep/w": np.asarray(w)})
    want = {"ep/y": np.asarray(y), "ep/dense": np.asarray(dense),
            "ep/dropped": float(aux["dropped_fraction"])}

    # tests/models/test_serving.py::make_generator, its model's every
    # parameter (prosody_gate included) for the port to load
    cfg = serve_lm()
    model = HippocampalTransformer(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        prosody=jnp.zeros((1, 8, 4)))
    gen = BatchedGenerator(model, params, batch_size=SERVE["batch_size"],
                           prompt_pad=SERVE["prompt_pad"],
                           max_new_tokens=SERVE["max_new_tokens"])
    want["serve"] = gen.generate_batch([GenerationRequest(
        np.asarray(SERVE["prompt"]), temperature=SERVE["temperature"],
        top_p=1.0, max_new_tokens=SERVE["max_new_tokens"])])[0]
    tcfg = port.ModelConfig(**dataclasses.asdict(cfg))
    sd = params_from_numpy(jax.tree.map(np.asarray, params), tcfg)
    inputs.update({f"lm/{k}": v.numpy() for k, v in sd.items()})
    return inputs, want, dataclasses.asdict(cfg)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    inputs, want, lm = jax_side()
    outs = spawn("tests.test_torch_mp_ranks:tp_modules", request.param,
                 tmp_path_factory.mktemp("tp"), inputs, lm=lm, serve=SERVE)
    return request.param, outs, want


def test_global_mesh_covers_all_devices(ranks):
    world, outs, _ = ranks
    for o in outs:
        assert o["global_mesh_2"].tolist() == [world // 2, 2]


def test_expert_parallel_forward_matches_jax(ranks):
    world, outs, want = ranks
    for o in outs:
        assert int(o["ep/local_experts"]) == 4 // world
        np.testing.assert_allclose(o["ep/y"], want["ep/y"], rtol=0,
                                   atol=EP_TOL)
        np.testing.assert_allclose(o["ep/dense"], want["ep/dense"], rtol=0,
                                   atol=EP_TOL)
        assert float(o["ep/dropped"]) == want["ep/dropped"]


def test_tp_decode_matches_single_device(ranks):
    world, outs, want = ranks
    for o in outs:
        np.testing.assert_array_equal(o["serve/tp"], want["serve"])
        np.testing.assert_array_equal(o["serve/plain"], want["serve"])
        assert int(o["serve/local_heads"]) == 4 // world
        assert bool(o["serve/model_left_whole"])


def test_memory_state_specs_match_jax():
    cfg = get_debug_config().memory
    jstate = init_memory_state(cfg)
    tstate = port.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    want = jmesh.memory_state_specs(jstate)
    got = tmesh.memory_state_specs(tstate)
    assert type(got) is type(tstate)
    assert got._fields == tuple(want._fields)
    for name in got._fields:
        assert getattr(got, name) == tuple(getattr(want, name)), name
    assert got.features == ("data",) and got.count == ()
