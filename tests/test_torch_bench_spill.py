"""The port's host-spilled bank benchmark
(`aura_snn_rag_tpu_torch/benchmarks/bench_host_spill.py`) against the JAX
script `benchmarks/bench_host_spill.py`, loaded by its path and shrunk
only through its module globals (N, CHUNK, QUERY_BATCH, N_QUERY_BATCHES,
BREAKDOWN) or the argv it reads at import; the port's module through its
CHUNK global and its flags:

- the rows and the queries are the JAX script's, bit for bit;
- the exact ground truth (the port's, in chunks through torch) picks the
  same rows as the JAX script's own chunked numpy search (its nested
  `exact_ground_truth`, run from the script's source);
- both `main`s at 8192 x 768, chunks of 2048, 2 batches of 128 with the
  breakdown: the retrieved indices equal the JAX `SpilledBank`'s (int8
  coarse rows, so no bf16 funnel gap), the lines carry the JAX keys in
  order and their values that do not depend on time are equal;
- `--sweep` items and every flag reach the config, and the device rule.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.memory import host_spill as jax_spill
from aura_snn_rag_tpu_torch.benchmarks import bench_host_spill as tspill
from tests.test_torch_common import highest

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "benchmarks", "bench_host_spill.py")
TINY = dict(N=8192, CHUNK=2048, QUERY_BATCH=128, N_QUERY_BATCHES=2,
            BREAKDOWN=True)
PORT_ARGV = ["--n=8192", "--batch=128", "--batches=2", "--breakdown",
             "--device", "cpu"]
# the keys whose values do not depend on time
STABLE = ("metric", "unit", "recall_at_10", "n_vectors", "coarse_dtype",
          "batch", "funnel_blocks", "funnel_rows", "query_chunk",
          "host_resident_gb")
STABLE_BREAKDOWN = ("funnel_bytes_per_batch", "funnel_blocks",
                    "funnel_rows", "n_vectors")


def jax_script(argv=()):
    """The JAX script as a module of its own name, its import-time flags
    read from `argv`."""
    saved = sys.argv
    sys.argv = ["bench_host_spill.py", *argv]
    try:
        spec = importlib.util.spec_from_file_location("jax_bench_host_spill",
                                                      SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.argv = saved
    return module


def nested_function(outer, name, namespace):
    """The function `name` defined inside the JAX script's `outer`, from
    its source, with `namespace` as its globals."""
    tree = ast.parse(open(SCRIPT).read())
    fn = next(node for node in ast.walk(tree)
              if isinstance(node, ast.FunctionDef) and node.name == outer)
    inner = next(node for node in fn.body
                 if isinstance(node, ast.FunctionDef) and node.name == name)
    code = compile(ast.Module(body=[inner], type_ignores=[]), SCRIPT, "exec")
    exec(code, namespace)
    return namespace[name]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's `main` at TINY: its printed lines, the queries it
    streamed, its results and its bank."""
    mp = pytest.MonkeyPatch()
    module = jax_script()
    for name, value in TINY.items():
        mp.setattr(module, name, value)
    seen = {}
    stream = jax_spill.SpilledBank.retrieve_stream

    def spy(self, batches, *a, **kw):
        out = stream(self, batches, *a, **kw)
        seen.setdefault("bank", self)
        seen.setdefault("queries", np.concatenate(batches))
        seen.setdefault("results", out)
        return out
    mp.setattr(jax_spill.SpilledBank, "retrieve_stream", spy)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), highest():
            module.main()
    finally:
        mp.undo()
    seen["lines"] = [json.loads(x) for x in out.getvalue().splitlines()]
    seen["module"] = module
    return seen


@pytest.fixture(scope="module")
def port_run():
    mp = pytest.MonkeyPatch()
    mp.setattr(tspill, "CHUNK", TINY["CHUNK"])
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = tspill.run(PORT_ARGV)
            lines = tspill.main(PORT_ARGV)
    finally:
        mp.undo()
    printed = [json.loads(x) for x in out.getvalue().splitlines()]
    return res, lines, printed


def test_rows_are_the_jax_script_s():
    jmake = jax_script().chunk_factory()
    tmake = tspill.chunk_factory()
    for offset, b in ((0, 300), (2048, 2048), (6144, 17)):
        want, got = jmake(offset, b), tmake(offset, b)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_queries_and_bank_are_the_jax_script_s(jax_run, port_run):
    res = port_run[0]
    np.testing.assert_array_equal(res.queries, jax_run["queries"])
    np.testing.assert_array_equal(res.bank.host_features,
                                  np.asarray(jax_run["bank"].host_features))


def test_exact_ground_truth_is_the_jax_script_s_numpy_search(jax_run,
                                                             port_run):
    res = port_run[0]
    module = jax_run["module"]
    search = nested_function("main", "exact_ground_truth", dict(
        np=np, queries=jax_run["queries"], N_EVAL=module.N_EVAL,
        TOPK=module.TOPK, N=TINY["N"], CHUNK=TINY["CHUNK"],
        bank=jax_run["bank"]))
    want = search()
    assert res.truth.shape == want.shape == (256, 10)
    # the JAX search leaves each row's top-10 in argpartition's order
    np.testing.assert_array_equal(np.sort(res.truth, axis=1),
                                  np.sort(want, axis=1))
    # the same rows, also through the port's function at another chunk
    again = tspill.exact_ground_truth(res.bank.host_features, TINY["N"],
                                      res.queries[:256], 10, "cpu")
    np.testing.assert_array_equal(again, res.truth)


def test_retrieved_indices_equal_the_jax_bank_s(jax_run, port_run):
    (m,) = port_run[0].configs
    want = np.concatenate([r.indices for r in jax_run["results"]])
    np.testing.assert_array_equal(m.indices, want)


def test_lines_carry_the_jax_keys_and_values(jax_run, port_run):
    res, lines, printed = port_run
    want_breakdown, want = jax_run["lines"]
    assert printed == lines and len(lines) == 2
    got_breakdown, got = lines
    assert list(got) == list(want)
    assert list(got_breakdown) == list(want_breakdown)
    assert (list(got_breakdown["breakdown_per_batch_ms"])
            == list(want_breakdown["breakdown_per_batch_ms"]))
    for key in STABLE:
        assert got[key] == want[key], key
    for key in STABLE_BREAKDOWN:
        assert got_breakdown[key] == want_breakdown[key], key
    assert got["recall_at_10"] >= 0.99
    # the device bank's bytes: int8 rows, scale, strength, timestamp
    dev = res.bank.dev
    assert got["hbm_resident_gb"] == round(
        (dev.coarse.numel() + 12 * dev.coarse.shape[0]) / 2**30, 2)
    # kernel A ran once per dispatch: a warm call, the stream, the stages
    (m,) = res.configs
    assert m.dispatches == [128] * 5


def test_sweep_items_reach_the_config(monkeypatch):
    jmod = jax_script()
    for item in ("fb64r192", "fb32r96qc512", "fb16r8qc16"):
        assert tspill.parse_sweep_item(item) == jmod._parse_sweep_item(item)
    monkeypatch.setattr(tspill, "CHUNK", 1024)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lines = tspill.main(["--n=4096", "--batch=64", "--sweep=fb32r64,"
                             "fb16r32qc16", "--device", "cpu"])
    assert [json.loads(x) for x in out.getvalue().splitlines()] == lines
    assert [(x["funnel_blocks"], x["funnel_rows"], x["query_chunk"],
             x["batch"]) for x in lines] == [(32, 64, 256, 64),
                                             (16, 32, 16, 64)]
    assert all(x["recall_at_10"] >= 0.99 for x in lines)


@pytest.mark.parametrize("argv", [
    [], ["--small"], ["--n=5000", "--batch=1024"],
    ["--small", "--batch=64", "--batches=7", "--breakdown",
     "--funnel-blocks=16", "--funnel-rows=48", "--sweep=fb64r192"]])
def test_flags_match_the_jax_script_s(argv):
    jmod = jax_script(argv)
    args = tspill.parser().parse_args(argv)
    assert tspill.stream_sizes(args) == (jmod.N, jmod.QUERY_BATCH,
                                         jmod.N_QUERY_BATCHES)
    assert (args.breakdown, args.funnel_blocks, args.funnel_rows) == (
        jmod.BREAKDOWN, jmod.FUNNEL_BLOCKS, jmod.FUNNEL_ROWS)
    assert (None if args.sweep is None else args.sweep.split(",")) \
        == jmod.SWEEP
    assert (tspill.N_EVAL, tspill.N_CENTERS, tspill.CHUNK, tspill.TOPK,
            tspill.D) == (jmod.N_EVAL, jmod.N_CENTERS, jmod.CHUNK,
                          jmod.TOPK, jmod.D)


def test_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspill.run(["--n=1024"])
