"""The port's retrieval benchmark (`aura_snn_rag_tpu_torch/bench.py`)
against the root `bench.py`, loaded by its path and shrunk only through
its module globals (N, K, PROBE, QUERY_BATCH, N_QUERY_BATCHES, SMALL and
the baseline's query count, which `--small` sets at import):

- the data and the queries are bit-equal to the JAX script's;
- `ReferenceMathIndex`, `exact_topk_numpy` and `recall_at_k` equal the
  JAX script's;
- the engine half, `engine_bench`, against `tpu_bench` on the same rows
  at 8192 x 768, K = 64, probe 8, 2 batches of 32: the device's exact
  ground truth and the flat results are equal, so is recall@10;
- `main()` at `--small --n=4096` prints one JSON line whose keys are the
  JAX script's and whose values that do not depend on time are equal;
- the CLI's `bench` and the device rule (`--sharded` is held in
  `tests/test_torch_bench_sharded.py`).
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from aura_snn_rag_tpu_torch import bench as tbench
from aura_snn_rag_tpu_torch import cli
from tests.test_torch_common import highest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(N=8192, K=64, PROBE=8, QUERY_BATCH=32, N_QUERY_BATCHES=2,
            SMALL=True)
# `--small` at a bank of 4096 rows
SMALL = dict(N=4096, K=1024, PROBE=32, QUERY_BATCH=32, N_QUERY_BATCHES=8,
             SMALL=True, BASELINE_QUERIES=8)
# the keys of the JSON line whose values do not depend on time
STABLE_KEYS = ("metric", "unit", "recall_at_10", "recall_eval_queries",
               "recall_at_10_vs_f32_data", "baseline_recall_at_10",
               "n_vectors", "coarse_dtype")


def jax_bench():
    """The root `bench.py`, the JAX script, as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def jbench(monkeypatch):
    module = jax_bench()

    def shrink(sizes):
        for name, value in sizes.items():
            monkeypatch.setattr(module, name, value)
        return module
    return shrink


def jax_main_inputs(jb):
    """(feats, queries) as the JAX script's `main` passes them to
    `tpu_bench`, which is replaced by a spy that stops the run."""
    seen = {}

    class Stop(Exception):
        pass

    def spy(feats, queries):
        seen.update(feats=feats, queries=queries)
        raise Stop

    jb.tpu_bench = spy
    with pytest.raises(Stop):
        jb.main()
    return seen["feats"], seen["queries"]


def test_data_and_queries_are_bench_py_s(jbench):
    jb = jbench(dict(N=5000, QUERY_BATCH=32, N_QUERY_BATCHES=3))
    feats, queries = jax_main_inputs(jb)
    got, centers = tbench.make_data(5000, tbench.D)
    want_centers = jb.make_data(5000, jb.D)[1]
    assert got.dtype == feats.dtype == np.float32
    np.testing.assert_array_equal(got, feats)
    np.testing.assert_array_equal(centers, want_centers)
    q = tbench.make_queries(got, 96)
    assert q.dtype == queries.dtype
    np.testing.assert_array_equal(q, queries)


def test_reference_math_index_matches_bench_py():
    jb = jax_bench()
    feats, _ = tbench.make_data(4096, tbench.D)
    queries = tbench.make_queries(feats, 8)
    got, want = tbench.ReferenceMathIndex(feats), jb.ReferenceMathIndex(feats)
    assert torch.equal(got.centroids, want.centroids)
    assert torch.equal(got.assign, want.assign)
    assert torch.equal(got.feats_norm, want.feats_norm)
    for q in queries:
        np.testing.assert_array_equal(got.query(q), want.query(q))


def test_exact_topk_numpy_and_recall_match_bench_py():
    jb = jax_bench()
    feats, _ = tbench.make_data(3000, tbench.D)
    queries = tbench.make_queries(feats, 20)
    got = tbench.exact_topk_numpy(feats, queries, 10)
    np.testing.assert_array_equal(got, jb.exact_topk_numpy(feats, queries,
                                                           10))
    rng = np.random.RandomState(3)
    approx = np.where(rng.rand(*got.shape) < 0.3, -1, got)
    assert tbench.recall_at_k(approx, got) == jb.recall_at_k(approx, got)
    assert 0.0 < tbench.recall_at_k(approx, got) < 1.0


@pytest.mark.parametrize("dtype", ["f16", "u16", "f32"])
def test_ingest_dtypes_store_bench_py_s_rows(dtype):
    """f16 and u16 ship the f16-rounded rows, f32 the rows as drawn."""
    feats, _ = tbench.make_data(64, tbench.D)
    got = tbench._upload(feats, dtype, torch.device("cpu"))
    want = feats if dtype == "f32" else feats.astype(np.float16).astype(
        np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_half_matches_tpu_bench(jbench):
    """The port's engine half and the JAX script's `tpu_bench` on the same
    rows and queries: the exact ground truth over the stored bank and the
    flat results are equal, so recall@10 is too. The IVF results are not
    compared (the index's initial centroids come from each package's own
    generator); they are finite, and probing 8 of 64 clusters finds at
    least 0.8 of the exact top-10."""
    jb = jbench(TINY)
    feats, _ = jb.make_data(jb.N, jb.D)
    queries = tbench.make_queries(feats, jb.QUERY_BATCH * jb.N_QUERY_BATCHES)
    with highest():
        (_, _, _, _, _, japprox, jexact, jn_eval,
         jstate) = jb.tpu_bench(feats, queries)
    cfg = tbench.memory_config(jb.N, jb.K, jb.PROBE, 8,
                               flat_score_dtype="bf16", rerank_candidates=128)
    eng = tbench.engine_bench(feats, queries, cfg, jb.QUERY_BATCH,
                              jb.N_QUERY_BATCHES, device="cpu")
    np.testing.assert_array_equal(eng.state.features.numpy(),
                                  np.asarray(jstate.features))
    assert eng.n_eval == jn_eval == len(queries)
    np.testing.assert_array_equal(eng.exact_idx, jexact)
    np.testing.assert_array_equal(eng.approx_idx, japprox)
    recall = tbench.recall_at_k(eng.approx_idx[:eng.n_eval], eng.exact_idx)
    assert recall == jb.recall_at_k(japprox[:jn_eval], jexact)
    assert eng.ivf_idx.shape == eng.approx_idx.shape == (len(queries), 10)
    assert np.isfinite(eng.ivf_scores).all()
    assert tbench.recall_at_k(eng.ivf_idx[:eng.n_eval],
                              eng.exact_idx) >= 0.8
    for t in (eng.build_s, eng.build_cold_s, eng.ingest_s, eng.flat_qps,
              eng.ivf_qps):
        assert t > 0


def test_main_prints_bench_py_s_line(jbench):
    jb = jbench(SMALL)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), highest():
        jb.main()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = tbench.main(["--small", "--n=4096", "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == got
    assert list(got) == list(want) and len(got) == 16
    for key in STABLE_KEYS:
        assert got[key] == want[key], key
    assert got["recall_at_10"] >= 0.99


def test_flags_reach_the_memory_config():
    s = tbench.settings(tbench.parser().parse_args([
        "--n=5000", "--bf16", "--kernel=v3", "--flat-score=f32",
        "--flat-strategy=blockmax", "--flat-tile-m=4096",
        "--flat-block-funnel=16", "--batch=512", "--rerank=384",
        "--flat-recall=0.99", "--rescue=0", "--rescue-width=2048",
        "--ingest-f32"]))
    c = s.cfg
    assert (c.max_memories, c.k_centroids, c.probe_centroids,
            c.overflow_buckets) == (5000, 4096, 64, 64)
    assert (c.coarse_dtype, c.ivf_kernel, c.flat_score_dtype,
            c.flat_strategy, c.flat_tile_m, c.flat_block_funnel,
            c.rerank_candidates, c.flat_funnel_recall, c.flat_rescue_queries,
            c.flat_rescue_width) == ("bf16", "v3", "f32", "blockmax", 4096,
                                     16, 384, 0.99, 0, 2048)
    assert (s.batch, s.n_batches, s.baseline_queries, s.ingest_dtype,
            s.device) == (512, 16, 16, "f32", "cuda")
    small = tbench.settings(tbench.parser().parse_args(
        ["--small", "--ingest-dtype=u16", "--device=cpu"]))
    assert (small.cfg.max_memories, small.cfg.k_centroids,
            small.cfg.probe_centroids, small.cfg.overflow_buckets,
            small.batch, small.n_batches, small.baseline_queries,
            small.ingest_dtype, small.device) == (
        100_000, 1024, 32, 8, 32, 8, 8, "u16", "cpu")


def test_bench_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.main(["--small"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["bench", "--small"])


def test_cli_bench_dispatches(monkeypatch):
    seen = []
    monkeypatch.setattr(tbench, "main",
                        lambda argv=None: seen.append(list(argv)) or {})
    assert cli.main(["bench", "--small", "--device", "cpu"]) == 0
    assert cli.main(["bench"]) == 0
    assert seen == [["--small", "--device", "cpu"], ["--device", "cuda"]]
    assert "bench" in cli.parser().format_help()
    help_text = io.StringIO()
    with contextlib.redirect_stdout(help_text), pytest.raises(SystemExit):
        cli.main(["bench", "--help"])
    assert "--small" in help_text.getvalue()

