"""The port's retrieval benchmarks (`aura_snn_rag_tpu_torch/benchmarks/
bench_retrieval_latency.py` and `bench_retrieval_breakdown.py`) against
the JAX scripts `benchmarks/bench_retrieval_latency.py` and
`bench_retrieval_breakdown.py`, loaded by their paths. The JAX scripts
fix their sizes inside `main` (only `--small` changes them), so:

- the data: the latency script's `main` at `--small` draws its rows and
  queries, and spies on its `bulk_load` and its first `retrieve` stop it
  there; the port's rows and queries are bit-equal. The breakdown
  script draws them with the same statements (compared by their AST);
- the results: one JAX bank at 8192 x 768, K = 64, probe 8 (the scripts'
  MemoryConfig at those sizes; `bulk_load` + `rebuild_centroids` of the
  JAX package) is carried into the port (`build_index` patched) and the
  port's benchmarks run on it at B = 1 and 8: each path's and each stage's
  output equals the JAX package's (the latency script's `retrieve` and
  `retrieve_flat`) or the JAX script's own stage function (the
  breakdown's nested functions, run from its source), the Pallas
  kernels in interpret mode; scores within 1e-5 (bf16 products or f32
  dot products summed in another order), indices wherever a score is
  clear of its neighbours by that much;
- the lines: each JAX script's `main` at `--small` with its heavy calls
  stubbed prints its line; the port's lines carry the same keys in the
  same order, and the values that do not depend on time are equal;
- the flags and the device rule.
"""

import ast
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu import memory as jmemory
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.ops.pallas import ivf_scan as jivf
from aura_snn_rag_tpu_torch.bench import memory_config, recall_at_k
from aura_snn_rag_tpu_torch.benchmarks import bench_retrieval_breakdown as tbd
from aura_snn_rag_tpu_torch.benchmarks import bench_retrieval_latency as tlat
from tests.test_torch_common import (
    assert_topk_match, built_jax_state, highest, result_np, to_port)

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENCY = os.path.join(ROOT, "benchmarks", "bench_retrieval_latency.py")
BREAKDOWN = os.path.join(ROOT, "benchmarks", "bench_retrieval_breakdown.py")
TINY = (8192, 64, 8, 8)          # rows, centroids, probe, overflow buckets
BATCHES = (1, 8)
TOL = 1e-5
DEAD = -5e29


class Stop(Exception):
    pass


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_main(path, argv, patches):
    """The JAX script's `main` under `argv`, with `patches` ((object,
    attribute, value) triples) in place; returns its printed lines."""
    module = load(path, "jax_" + os.path.basename(path)[:-3])
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", [os.path.basename(path), *argv])
    for obj, attr, value in patches:
        mp.setattr(obj, attr, value)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), highest():
            module.main()
    finally:
        mp.undo()
    return out.getvalue().strip().splitlines()


def jax_config(n, k_centroids, probe, overflow, **kw):
    """The scripts' MemoryConfig at explicit sizes."""
    return jconfig.MemoryConfig(
        max_memories=n, feature_dim=768, k_centroids=k_centroids,
        probe_centroids=probe, retrieve_k=10, bucket_overprovision=2.0,
        rebuild_lloyd_iters=2, overflow_buckets=overflow, n_place_cells=16,
        n_grid_cells=8, n_time_cells=4, **kw)


def empty_state(cfg):
    """What the latency script reads of its state once the calls that
    use it are stubbed."""
    return types.SimpleNamespace(centroid_counts=np.zeros(1))


def fake_result(q, k=10):
    B = q.shape[0]
    return jengine.RetrievalResult(jnp.zeros((B, k), jnp.int32),
                                   jnp.zeros((B, k)),
                                   jnp.zeros((B, k, q.shape[1])))


@pytest.fixture(scope="module")
def bank():
    """(JAX config, JAX state, its aux, rows, queries) at TINY."""
    jcfg = jax_config(*TINY)
    feats, queries = tlat.make_inputs(TINY[0])
    js = built_jax_state(jcfg, feats, seed=0)
    with highest():
        jaux = jengine.build_ivf_aux(jcfg, js)
    return jcfg, js, jaux, feats, queries


@pytest.fixture(scope="module")
def interpret():
    mp = pytest.MonkeyPatch()
    mp.setenv("AURA_PALLAS_INTERPRET", "1")
    yield
    mp.undo()


def port_on(bank, module, argv):
    """The port's benchmark `module` at TINY on the JAX bank."""
    js = bank[1]
    mp = pytest.MonkeyPatch()
    mp.setattr(tlat, "sizes", lambda small: TINY)
    mp.setattr(tlat, "build_index", lambda cfg, feats, dev: to_port(js))
    try:
        return module.run([*argv, "--device", "cpu"])
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def latency(bank):
    return port_on(bank, tlat, ["--batches", "1,8", "--reps", "1"])


@pytest.fixture(scope="module")
def breakdown(bank):
    return port_on(bank, tbd, ["--batches", "1,8", "--reps", "1"])


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_rows_and_queries_are_the_jax_script_s():
    seen = {}

    def bulk_load(cfg, state, feats, locs):
        seen["feats"] = np.asarray(feats)
        return state

    def retrieve(cfg, state, q, *a, **kw):
        seen["queries"] = np.asarray(q)
        raise Stop

    with pytest.raises(Stop):
        run_main(LATENCY, ["--small", "--batches", "128"], [
            (jengine, "bulk_load", bulk_load),
            (jmemory, "init_memory_state", empty_state),
            (jmemory, "rebuild_centroids", lambda cfg, state, key: state),
            (jengine, "build_ivf_aux", lambda cfg, state: jnp.zeros((1, 1,
                                                                     1))),
            (jmemory, "retrieve", retrieve)])
    feats, queries = tlat.make_inputs(100_000)
    np.testing.assert_array_equal(feats, seen["feats"])
    np.testing.assert_array_equal(queries, seen["queries"])
    assert feats.dtype == queries.dtype == np.float32
    # past 128 queries the port draws more; the first 128 stay
    _, more = tlat.make_inputs(4096, 300)
    np.testing.assert_array_equal(more[:128], tlat.make_inputs(4096)[1])
    assert more.shape == (300, 768)


def test_the_breakdown_draws_the_latency_script_s_data():
    def draws(path):
        main = next(node for node in ast.parse(open(path).read()).body
                    if isinstance(node, ast.FunctionDef)
                    and node.name == "main")
        lines = [ast.dump(node) for node in main.body]
        start = next(i for i, x in enumerate(lines)
                     if "RandomState" in x)
        return lines[start:start + 5], lines[start - 5:start]
    (lat_draws, lat_sizes), (bd_draws, bd_sizes) = (draws(LATENCY),
                                                    draws(BREAKDOWN))
    assert lat_draws == bd_draws and lat_sizes == bd_sizes
    assert "queries" in lat_draws[-1]


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B", BATCHES)
def test_latency_paths_match_jax(bank, latency, interpret, B):
    jcfg, js, jaux, _, queries = bank
    q = jnp.asarray(queries[:B])
    with highest():
        want = {"ivf": result_np(jengine.retrieve(jcfg, js, q, None, 10,
                                                  aux=jaux)),
                "flat": result_np(jengine.retrieve_flat(jcfg, js, q, None,
                                                        10))}
    for name in ("ivf", "flat"):
        key = f"{name}_B{B}"
        idx, scores = latency.results[key]
        assert_topk_match(idx, scores, want[name][0], want[name][1], TOL)
        assert latency.line[key]["recall_at_10"] == round(
            recall_at_k(want[name][0], latency.exact[:B]), 4)
        assert latency.calls[key] == 12


def jax_stages(jcfg, probe, per_k, kk, KK):
    """The breakdown script's nested stage functions, from its source."""
    ns = dict(jax=jax, jnp=jnp, functools=functools, cfg=jcfg, PROBE=probe,
              per_k=per_k, kk=kk, KK=KK, TOPK=10, interp=True,
              NEG_INF=jengine.NEG_INF, _combined_score=jengine._combined_score,
              _l2norm=jengine._l2norm, build_ivf_aux=jengine.build_ivf_aux,
              ivf_topk_scores=jivf.ivf_topk_scores,
              ivf_scan_scores=jivf.ivf_scan_scores,
              ivf_candidates=jivf.ivf_candidates)
    main = next(node for node in ast.parse(open(BREAKDOWN).read()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    defs = [node for node in main.body if isinstance(node, ast.FunctionDef)
            and node.name.startswith("stage_")]
    exec(compile(ast.Module(body=defs, type_ignores=[]), BREAKDOWN, "exec"),
         ns)
    return ns


def live_match(got, want):
    """Coarse (scores, slots): the same live lanes; scores within TOL;
    slots wherever the score is clear of its row's others."""
    ts, tsl = (np.asarray(x) for x in got)
    js, jsl = (np.asarray(x) for x in want)
    ts, tsl, js, jsl = (x.reshape(-1, x.shape[-1]) for x in (ts, tsl, js,
                                                             jsl))
    live = js > DEAD
    assert (live == (ts > DEAD)).all()
    assert_topk_match(np.where(live, tsl, -1), np.where(live, ts, 0.0),
                      np.where(live, jsl, -1), np.where(live, js, 0.0), TOL)


@pytest.mark.parametrize("B", BATCHES)
def test_breakdown_stages_match_jax(bank, breakdown, interpret, B):
    jcfg, js, jaux, _, queries = bank
    line = breakdown.line
    probe, C, per_k = line["probe"], line["bucket_capacity"], line["per_k"]
    kk = min(max(jcfg.rerank_candidates, 40), probe * C)
    KK = -(-kk // 128) * 128
    st = jax_stages(jcfg, probe, per_k, kk, KK)
    out = breakdown.outputs[B]
    q = jnp.asarray(queries[:B])
    with highest():
        np.testing.assert_array_equal(out["aux_build"].numpy(),
                                      np.asarray(st["stage_aux"](js)))
        qn, top_c = st["stage_centroid"](js, q)
        np.testing.assert_array_equal(out["centroid_topP"][1].numpy(),
                                      np.asarray(top_c))
        np.testing.assert_allclose(out["centroid_topP"][0].numpy(),
                                   np.asarray(qn), rtol=0, atol=1e-6)
        sc, sl = st["stage_kernel_v2"](js, jaux, qn, top_c)
        got_sc, got_sl = out["kernel_v2"]
        live_match((got_sc[..., :per_k], got_sl[..., :per_k]),
                   (sc[..., :per_k], sl[..., :per_k]))
        np.testing.assert_allclose(
            out["kernel_v1"].numpy(),
            np.asarray(st["stage_kernel_v1"](js, qn, top_c)), rtol=0,
            atol=TOL)
        live_match(out["kernel_v3"],
                   st["stage_kernel_v3"](js, jaux, qn, top_c))
        slots, scores = st["stage_funnel"](js, qn, sc, sl)
        got_slots, got_scores = out["funnel_rerank"]
        assert_topk_match(got_slots.numpy(), got_scores.numpy(),
                          np.asarray(slots), np.asarray(scores), TOL)
        for stage, kernel, aux in (("full_v3", None, jaux),
                                   ("full_v3r", "v3r", jaux),
                                   ("full_v2", "v2", jaux),
                                   ("full_noaux", None, None)):
            cfg = (jcfg if kernel is None
                   else dataclasses.replace(jcfg, ivf_kernel=kernel))
            want = result_np(jengine.retrieve(cfg, js, q, None, 10, aux=aux))
            got = result_np(out[stage])
            assert_topk_match(got[0], got[1], want[0], want[1], TOL)
    # each stage: one warm-up call and one timed; kernel_v2 once more for
    # the funnel's input
    assert breakdown.calls[B] == {s: 3 if s == "kernel_v2" else 2
                                  for s in tbd.STAGES}


# --------------------------------------------------------------------------
# lines and flags
# --------------------------------------------------------------------------

def test_latency_line_carries_the_jax_keys(latency):
    lines = run_main(LATENCY, ["--small", "--batches", "1,8"], [
        (jmemory, "init_memory_state", empty_state),
        (jengine, "bulk_load", lambda cfg, state, f, l: state),
        (jmemory, "rebuild_centroids", lambda cfg, state, key: state),
        (jengine, "build_ivf_aux", lambda cfg, state: jnp.zeros((1, 1, 1))),
        (jmemory, "retrieve", lambda cfg, state, q, *a, **kw:
         fake_result(q)),
        (jmemory, "retrieve_flat", lambda cfg, state, q, *a, **kw:
         fake_result(q))])
    want = json.loads(lines[-1])
    got = latency.line
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert list(got[key]) == list(value), key
    assert got["metric"] == want["metric"]
    assert want["n_vectors"] == tlat.sizes(True)[0] == 100_000
    assert tlat.sizes(False) == (1_000_000, 4096, 64, 64)
    assert tlat.sizes(True) == (100_000, 1024, 32, 8)


def test_breakdown_line_carries_the_jax_keys(breakdown):
    def topk(cl, aux, qn, top_c, k, interpret=False):
        B, P = top_c.shape
        return (jnp.full((B, P, 128), -1e30), jnp.zeros((B, P, 128),
                                                        jnp.int32))

    def cands(cl, aux, qn, top_c, kk, interpret=False):
        B = top_c.shape[0]
        return jnp.full((B, kk), -1e30), jnp.zeros((B, kk), jnp.int32)

    lines = run_main(BREAKDOWN, ["--small", "--batches", "1,8", "--reps",
                                 "1"], [
        (jengine, "bulk_load", lambda cfg, state, f, l: state),
        (jmemory, "rebuild_centroids", lambda cfg, state, key: state),
        (jivf, "ivf_topk_scores", topk),
        (jivf, "ivf_candidates", cands),
        (jivf, "ivf_scan_scores", lambda cl, qn, top_c, interpret=False:
         jnp.zeros(top_c.shape + (cl.shape[1],))),
        (jmemory, "retrieve", lambda cfg, state, q, *a, **kw:
         fake_result(q))])
    want = json.loads(lines[-1])
    got = breakdown.line
    assert list(got) == list(want)
    for B in BATCHES:
        assert list(got[f"B{B}"]) == list(want[f"B{B}"])
    assert got["metric"] == want["metric"]
    # the values that depend on the sizes, at --small
    cfg = memory_config(*tlat.sizes(True), "bf16")
    C = cfg.bucket_capacity
    kk = min(max(cfg.rerank_candidates, 40), cfg.probe_centroids * C)
    assert (want["n_vectors"], want["probe"], want["bucket_capacity"],
            want["per_k"]) == (100_000, cfg.probe_centroids, C,
                               min(max(10, -(-kk // cfg.probe_centroids)),
                                   C))


def test_flags_and_defaults():
    a = tlat.parser().parse_args([])
    assert (a.small, a.batches, a.reps, a.kernel, a.device) == (
        False, "1,8,32,128", 5, "", "cuda")
    a = tlat.parser().parse_args(["--small", "--batches", "1,2", "--reps",
                                  "3", "--kernel", "v2"])
    assert (a.small, a.batches, a.reps, a.kernel) == (True, "1,2", 3, "v2")
    b = tbd.parser().parse_args([])
    assert (b.small, b.batches, b.reps, b.device) == (False, "1,8", 16,
                                                      "cuda")


@pytest.mark.parametrize("kernel, name", [("v2", "ivf_topk_scores"),
                                          ("v3", "ivf_candidates"),
                                          ("", "ivf_retrieve_fused")])
def test_kernel_flag_picks_the_ivf_kernel(bank, monkeypatch, kernel, name):
    from aura_snn_rag_tpu_torch.memory import engine as tengine
    seen = []
    real = getattr(tengine, name)
    monkeypatch.setattr(tengine, name,
                        lambda *a, **kw: seen.append(name) or real(*a, **kw))
    res = port_on(bank, tlat, ["--batches", "1", "--reps", "1",
                               "--kernel", kernel])
    assert seen.count(name) == res.calls["ivf_B1"] == 12
    assert (res.cfg.ivf_kernel == (kernel or "v3r"))


def test_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for module in (tlat, tbd):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.run(["--small"])
