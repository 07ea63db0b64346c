"""The port's sharded-scaling check
(`aura_snn_rag_tpu_torch/benchmarks/bench_sharded_scaling.py`) against the
JAX script `benchmarks/bench_sharded_scaling.py`, loaded by its path and
shrunk only through its module globals (`_n`, PER_SHARD); the port runs
its gloo ranks on the host (`--device cpu`), the JAX script its virtual
CPU mesh (the conftest's 8 devices):

- the rows and queries are the JAX script's;
- at 2 and 4 shards of 512 rows: the sharded top-k, mapped to row ids,
  equals the JAX script's, and so does `topk_agreement_vs_flat`;
- the bytes the port counts around the retrieval equal the JAX script's
  analytic all-gather count, B * k * (D + 2) * S * 4; the JAX script's
  HLO count is recorded beside them (`test_collective_bytes...` prints
  both);
- the line carries the JAX keys in order, with equal values but for the
  HLO's bytes;
- the port's `bench --sharded=N` and the CLI's `bench --sharded=N` run the
  module on their `--device`; one rank runs in this process; the device
  rule.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.memory import sharded as jsharded
from aura_snn_rag_tpu_torch import bench as tbench
from aura_snn_rag_tpu_torch import cli
from aura_snn_rag_tpu_torch.benchmarks import bench_sharded_scaling as tss
from tests.test_torch_common import highest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "benchmarks", "bench_sharded_scaling.py")
PER_SHARD = 512
# the keys whose values the port holds equal to the JAX script's
EQUAL = ("metric", "n_shards", "per_shard_rows", "total_rows",
         "topk_agreement_vs_flat", "analytic_allgather_bytes", "batch")


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_sharded_scaling", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_main(n):
    """The JAX script's `main` at n shards of PER_SHARD rows: (its line,
    the sharded result's indices mapped to row ids)."""
    mp = pytest.MonkeyPatch()
    module = jax_script()
    mp.setattr(module, "_n", n)
    mp.setattr(module, "PER_SHARD", PER_SHARD)
    seen = []
    real = jsharded.retrieve_sharded

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out
    mp.setattr(jsharded, "retrieve_sharded", spy)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), highest():
            module.main()
    finally:
        mp.undo()
    g = np.asarray(seen[0].indices)             # the eager call
    mapped = np.where(g >= 0, (g // PER_SHARD) * PER_SHARD
                      + g % PER_SHARD, -1)
    return json.loads(out.getvalue().strip().splitlines()[-1]), mapped


@pytest.fixture(scope="module", params=[2, 4])
def both(request):
    n = request.param
    line, mapped = jax_main(n)
    res = tss.run([f"--n={n}", f"--per-shard={PER_SHARD}", "--device",
                   "cpu"])
    return n, line, mapped, res


def test_rows_and_queries_are_the_jax_script_s():
    rng = np.random.RandomState(0)
    total = 3 * PER_SHARD
    feats = rng.randn(total, tss.D).astype(np.float32)
    queries = feats[rng.randint(0, total, 64)] + 0.3 * rng.randn(
        64, tss.D).astype(np.float32)
    got_f, got_q = tss.make_data(3, PER_SHARD)
    np.testing.assert_array_equal(got_f, feats)
    np.testing.assert_array_equal(got_q, queries)
    jmod = jax_script()
    assert (tss.D, tss.TOPK, tss.B) == (jmod.D, jmod.TOPK, jmod.B)
    assert tss.parser().parse_args([]).n == 8
    assert tss.parser().parse_args([]).per_shard == jmod.PER_SHARD


def test_sharded_topk_matches_the_jax_script_s(both):
    n, line, mapped, res = both
    np.testing.assert_array_equal(res.mapped, mapped)
    assert res.line["topk_agreement_vs_flat"] == \
        line["topk_agreement_vs_flat"] == 1.0
    # every shard holds its own rows: the result spans the shards
    assert len(np.unique(res.indices // PER_SHARD)) == n


def test_collective_bytes_equal_the_analytic_count(both):
    n, line, _, res = both
    analytic = 64 * 10 * (768 + 2) * n * 4
    assert line["analytic_allgather_bytes"] == analytic
    assert res.line["collective_bytes_per_batch"] == {"all-gather": analytic}
    assert res.line["collective_bytes_total"] == analytic
    assert res.line["bytes_per_query"] == round(analytic / 64, 1)
    print(f"{n} shards: port {res.line['collective_bytes_total']} bytes, "
          f"analytic {analytic}, JAX HLO {line['collective_bytes_total']} "
          f"{line['collective_bytes_per_batch']}")


def test_line_carries_the_jax_keys(both):
    _, line, _, res = both
    assert list(res.line) == list(line)
    for key in EQUAL:
        assert res.line[key] == line[key], key


def test_one_rank_runs_in_this_process():
    res = tss.run(["--n=1", f"--per-shard={PER_SHARD}", "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    assert res.line["topk_agreement_vs_flat"] == 1.0
    assert res.line["collective_bytes_total"] == 64 * 10 * 770 * 4


def test_bench_sharded_hands_off(monkeypatch):
    """`bench --sharded=N` prints the sharded check's line on N ranks of
    its `--device` (the port's bench.py and its CLI): gloo ranks with
    `--device cpu`; the default, cuda, raises without a card."""
    monkeypatch.setattr(tss, "parser", lambda real=tss.parser: _shrunk(
        real()))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = tbench.main(["--sharded=2", "--device", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == line
    assert line["n_shards"] == 2 and line["per_shard_rows"] == PER_SHARD
    assert line["topk_agreement_vs_flat"] == 1.0
    if not torch.cuda.is_available():
        for argv in (["--sharded=1"], ["--sharded=2"]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tbench.run(argv)
    handed = []
    monkeypatch.setattr(tss, "run", lambda argv: handed.append(list(argv))
                        or tss.ShardedResult({}, None, None, None))
    for device in ("cuda", "cpu"):
        tbench.run(["--sharded=3", "--device", device])
    assert handed == [["--n=3", "--device", "cuda"],
                      ["--n=3", "--device", "cpu"]]
    seen = []
    monkeypatch.setattr(tbench, "main",
                        lambda argv=None: seen.append(list(argv)) or {})
    assert cli.main(["bench", "--sharded=3"]) == 0
    assert cli.main(["bench", "--sharded=3", "--device", "cpu"]) == 0
    assert seen == [["--device", "cuda", "--sharded=3"],
                    ["--device", "cpu", "--sharded=3"]]


def _shrunk(ap):
    ap.set_defaults(per_shard=PER_SHARD)
    return ap


def test_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tss.run(["--n=1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tss.run(["--n=2"])
