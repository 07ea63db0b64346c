"""The port's flat and transfer benchmarks (`aura_snn_rag_tpu_torch/
benchmarks/bench_flat_kernel.py`, `bench_flat_batch_sweep.py`,
`bench_rescue_ab.py` and `bench_h2d_dtypes.py`) against the JAX scripts of
the same names in `benchmarks/`, loaded by their paths. The scripts read
`sys.argv` at import and size themselves from module globals, so each is
loaded under its argv, shrunk by patching those globals (`M`, `B`,
`REPS`, `N`, `BATCHES`, ...), and its `main` run on the CPU, the Pallas
kernel in interpret mode; the port's modules shrink through `sizes`.

- `bench_flat_kernel` at 4096 x 768, B = 16: the port's surfaces (kernel
  A's plain version on the CPU, and at int8 the library line) equal the
  JAX script's XLA scan, bit for bit at int8 and within 1e-6 at bf16 (f32
  sums of exact bf16 products in another order). The Pallas kernel's
  8-row blocks are strided within a tile, a partition other than the
  port's contiguous blocks, so its output is held to the port's only in
  each query's maximum over all blocks;
- `bench_flat_batch_sweep` and `bench_rescue_ab` at 4096 x 768: the rows
  carry the JAX rows' keys and variants in order (`blockmax-xla` is
  `blockmax-plain`), each row's recall@10 is at least JAX's (the port's
  funnel is exact), the funnel options give the default funnel's indices
  at the same rerank width, and nothing is written outside `tmp_path`;
- `bench_h2d_dtypes`: the keys and every payload's bytes (torch's bf16
  cast is `ml_dtypes.bfloat16`'s, bit for bit);
- the flags and the device rule.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.ops.pallas import flat_scan as jflat
from aura_snn_rag_tpu_torch.benchmarks import bench_flat_batch_sweep as tsw
from aura_snn_rag_tpu_torch.benchmarks import bench_flat_kernel as tfk
from aura_snn_rag_tpu_torch.benchmarks import bench_h2d_dtypes as th2d
from aura_snn_rag_tpu_torch.benchmarks import bench_rescue_ab as tra
from aura_snn_rag_tpu_torch.memory import retrieve_flat
from tests.test_torch_common import highest

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, B = 4096, 16
BF16_TOL = 1e-6
LINE = re.compile(r"^(.{28}) +([0-9.]+) ms/batch +([0-9.]+) GB/s eff +"
                  r"([0-9.]+) QPS\(coarse\)$")


def load(name, argv=()):
    """The JAX script, imported under `argv`."""
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.argv = saved
    return module


def printed(fn):
    """fn()'s stdout lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().strip().splitlines()


# --------------------------------------------------------------------------
# bench_flat_kernel
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["int8", "bf16"])
def flat_kernel(request):
    """(dtype, the JAX script's XLA scan and Pallas outputs and lines, the
    port's result and lines) at M x 768, B = 16."""
    dtype = request.param
    argv = ["--bf16"] if dtype == "bf16" else []
    module = load("bench_flat_kernel", argv)
    mp = pytest.MonkeyPatch()
    outs = {"pallas": []}
    real_jit = jax.jit

    def spy_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "xla_scan":
            return jitted

        def call(*args, **kw):
            out = jitted(*args, **kw)
            outs.setdefault("xla", np.asarray(out))
            return out
        return call

    def spy_pallas(*args, **kw):
        out = real_pallas(*args, **kw)
        outs["pallas"].append((kw["tile_m"], kw["int8_via_bf16"],
                               np.asarray(out)))
        return out

    real_pallas = jflat.flat_blockmax
    try:
        for attr, value in (("M", M), ("B", B), ("REPS", 1)):
            mp.setattr(module, attr, value)
        mp.setattr(jax, "jit", spy_jit)
        mp.setattr(jflat, "flat_blockmax", spy_pallas)
        with highest():
            jax_lines = printed(module.main)
    finally:
        mp.undo()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tfk, "sizes", lambda small: (M, 1))
        mp.setattr(tfk, "B", B)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = tfk.run(argv + ["--device", "cpu"])
    finally:
        mp.undo()
    return dtype, outs, jax_lines, res, buf.getvalue().strip().splitlines()


def test_flat_kernel_surfaces_equal_the_jax_xla_scan(flat_kernel):
    dtype, outs, _, res, _ = flat_kernel
    want = outs["xla"]
    kernel = res.surfaces[tfk.KERNEL[dtype]].numpy()
    assert kernel.shape == want.shape == (B, M // 8)
    if dtype == "int8":
        np.testing.assert_array_equal(kernel, want)
        # the library line's int8 product is exact too
        np.testing.assert_array_equal(
            res.surfaces[tfk.LIBRARY].numpy(), want)
    else:
        # a bf16 matmul rounds the library's product: a yardstick of time
        np.testing.assert_allclose(kernel, want, rtol=0, atol=BF16_TOL)


def test_flat_kernel_pallas_maxima_equal_the_port(flat_kernel):
    dtype, outs, _, res, _ = flat_kernel
    kernel = res.surfaces[tfk.KERNEL[dtype]].numpy()
    assert len(outs["pallas"]) == 8           # 4 lines x (1 + REPS)
    for tile_m, via_bf16, out in outs["pallas"]:
        got = out[:B].max(axis=1)
        if dtype == "int8":
            np.testing.assert_array_equal(got, kernel.max(axis=1))
        else:
            np.testing.assert_allclose(got, kernel.max(axis=1), rtol=0,
                                       atol=BF16_TOL)


def test_flat_kernel_lines_carry_the_script_s_columns(flat_kernel):
    dtype, _, jax_lines, res, port_lines = flat_kernel
    assert [LINE.match(s).group(1).strip() for s in jax_lines] == [
        "xla coarse+blockmax", "pallas s8-native tile=1024",
        "pallas s8-native tile=2048", "pallas s8->bf16 tile=1024",
        "pallas s8->bf16 tile=2048"]
    names = [LINE.match(s).group(1).strip() for s in port_lines]
    assert names == [tfk.LIBRARY, tfk.KERNEL[dtype]]
    assert [line["name"] for line in res.lines] == names
    for s, line in zip(port_lines, res.lines):
        assert s == tfk.format_line(line)
        assert line["gb_s_eff"] == pytest.approx(
            M * 768 * (1 if dtype == "int8" else 2)
            / (line["ms_per_batch"] / 1e3) / 1e9)
    assert res.calls == {tfk.LIBRARY: 2, tfk.KERNEL[dtype]: 2}


# --------------------------------------------------------------------------
# bench_flat_batch_sweep and bench_rescue_ab
# --------------------------------------------------------------------------

SWEEP = dict(N=M, BATCHES=(16,), N_BATCHES=2, N_EVAL=16)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    module = load("bench_flat_batch_sweep")
    mp = pytest.MonkeyPatch()
    try:
        for attr, value in SWEEP.items():
            mp.setattr(module, attr, value)
        mp.setattr(module, "OUT_PATH", str(tmp / "jax.json"))
        with highest():
            jax_lines = [json.loads(s) for s in printed(module.main)]
        mp.setattr(tsw, "sizes", lambda small: (
            SWEEP["N"], SWEEP["N_BATCHES"], SWEEP["N_EVAL"],
            SWEEP["BATCHES"]))
        res = tsw.run(["--device", "cpu", "--out", str(tmp / "port.json")])
        bare = tmp / "bare"
        bare.mkdir()
        with contextlib.chdir(bare):
            tsw.run(["--device", "cpu"])
    finally:
        mp.undo()
    return tmp, jax_lines, res


def test_sweep_rows_match_the_jax_rows(sweep):
    _, jax_lines, res = sweep
    jax_rows, jax_winner = jax_lines[:-1], jax_lines[-1]
    assert [tuple(r) for r in res.rows] == [tuple(r) for r in jax_rows]
    names = {"blockmax-xla": "blockmax-plain"}
    assert [(r["variant"], r["batch"]) for r in res.rows] == [
        (names.get(r["variant"], r["variant"]), r["batch"])
        for r in jax_rows]
    for got, want in zip(res.rows, jax_rows):
        assert got["recall_at_10"] >= want["recall_at_10"]
    assert list(jax_winner) == ["winner"]
    assert res.summary["winner"] in res.rows
    assert list(res.summary) == ["winner", "rows", "n_vectors"]
    assert res.calls == {(r["variant"], r["batch"]): 1 + SWEEP["N_BATCHES"]
                         for r in res.rows}


def test_sweep_writes_only_where_it_is_told(sweep):
    tmp, _, res = sweep
    assert sorted(p.name for p in tmp.iterdir()) == ["bare", "jax.json",
                                                     "port.json"]
    assert list((tmp / "bare").iterdir()) == []
    with open(tmp / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(res.summary))
    with open(tmp / "jax.json") as f:
        assert list(json.load(f)) == list(res.summary)


def test_sweep_blockmax_plain_refuses_kernel_a_for_its_rows_only(
        monkeypatch):
    from aura_snn_rag_tpu_torch.memory import engine
    calls = []
    real = engine._flat_kernel_ok
    with tsw.kernel_allowed(False):
        assert engine._flat_kernel_ok(None, None) is False
        calls.append(engine._flat_kernel_ok)
    assert engine._flat_kernel_ok is real and calls[0] is not real
    with tsw.kernel_allowed(True):
        assert engine._flat_kernel_ok is real


RESCUE = dict(N=M, QUERY_BATCH=16, N_QUERY_BATCHES=2, N_EVAL=32)


@pytest.fixture(scope="module")
def rescue():
    module = load("bench_rescue_ab")
    mp = pytest.MonkeyPatch()
    try:
        for attr, value in RESCUE.items():
            mp.setattr(module, attr, value)
        with highest():
            jax_lines = [json.loads(s) for s in printed(module.main)]
        mp.setattr(tra, "sizes", lambda small: (
            RESCUE["N"], RESCUE["QUERY_BATCH"], RESCUE["N_QUERY_BATCHES"]))
        mp.setattr(tra, "N_EVAL", RESCUE["N_EVAL"])
        res = tra.run(["--device", "cpu"])
    finally:
        mp.undo()
    return jax_lines, res


def test_rescue_rows_match_the_jax_rows(rescue):
    jax_lines, res = rescue
    assert [list(line) for line in res.lines] == [list(line)
                                                  for line in jax_lines]
    assert [line["variant"] for line in res.lines] == [
        line["variant"] for line in jax_lines]
    for got, want in zip(res.lines, jax_lines):
        assert got["recall_at_10"] >= want["recall_at_10"]
        assert (got["n_vectors"], got["batch"]) == (want["n_vectors"],
                                                    want["batch"])


def test_rescue_funnel_options_give_the_default_funnel_s_indices(rescue):
    _, res = rescue
    base = res.configs["approx95_kk128"]
    for name, cfg in res.configs.items():
        plain = dataclasses.replace(
            cfg, flat_funnel_recall=base.flat_funnel_recall,
            flat_exact_funnel=False, flat_wide_funnel=0)
        want = torch.cat([retrieve_flat(plain, res.state, b, None, 10)
                          .indices for b in res.batches]).numpy()
        np.testing.assert_array_equal(res.indices[name], want, err_msg=name)
    np.testing.assert_array_equal(res.indices["exact_kk128"],
                                  res.indices["approx95_kk128"])
    np.testing.assert_array_equal(res.indices["wide4096_kk192"],
                                  res.indices["approx95_kk192"])


def test_rescue_wide_only_runs_the_last_four():
    assert [v for v, _ in tra.VARIANTS[tra.WIDE_ONLY:]] == [
        "wide1024_kk128", "wide2048_kk160", "wide2048_kk192",
        "wide4096_kk192"]
    module = load("bench_rescue_ab", ["--wide-only"])
    assert list(module.VARIANTS) == list(tra.VARIANTS[tra.WIDE_ONLY:])
    assert list(load("bench_rescue_ab").VARIANTS) == list(tra.VARIANTS)


# --------------------------------------------------------------------------
# bench_h2d_dtypes
# --------------------------------------------------------------------------

def _jax_payloads(mb):
    """The JAX script's payloads, by its own statements."""
    base = np.random.RandomState(0).randn(mb * (1 << 20) // 4).astype(
        np.float32)
    return {"f32": base, "f16": base.astype(np.float16),
            "bf16": base.astype(ml_dtypes.bfloat16),
            "u16": base.astype(np.float16).view(np.uint16),
            "i8": np.clip(np.round(base * 64), -127, 127).astype(np.int8),
            "u8_raw": base.view(np.uint8)}


def test_h2d_payloads_equal_the_script_s_bytes():
    want = _jax_payloads(1)
    got = th2d.payloads(1)
    assert list(got) == list(want)
    for name, t in got.items():
        w = want[name]
        assert t.numel() * t.element_size() == w.nbytes, name
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        assert raw.numpy().tobytes() == w.tobytes(), name


def test_h2d_line_carries_the_script_s_keys():
    module = load("bench_h2d_dtypes", ["--mb=1"])
    (jax_line,) = [json.loads(s) for s in printed(module.main)]
    res = th2d.run(["--mb=1", "--device", "cpu"])
    assert list(res.line) == list(jax_line)
    assert res.line["payload_mb"] == jax_line["payload_mb"] == 1
    assert res.nbytes == {name: a.nbytes
                          for name, a in _jax_payloads(1).items()}


# --------------------------------------------------------------------------
# flags and the device rule
# --------------------------------------------------------------------------

MODULES = {"bench_flat_kernel": (tfk, ("--small", "--bf16")),
           "bench_flat_batch_sweep": (tsw, ("--small",)),
           "bench_rescue_ab": (tra, ("--small", "--wide-only")),
           "bench_h2d_dtypes": (th2d, ("--mb",))}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_flags_and_device_rule(name):
    module, flags = MODULES[name]
    src = open(os.path.join(ROOT, "benchmarks", f"{name}.py")).read()
    options = {o for a in module.parser()._actions for o in a.option_strings}
    for flag in flags:
        assert flag in src and flag in options, flag
    assert module.parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run([])


def test_sizes_are_the_script_s():
    assert tfk.sizes(False) == (1_000_000, 8) and tfk.sizes(True) == (
        100_000, 4)
    for small in (False, True):
        jsw = load("bench_flat_batch_sweep", ["--small"] if small else [])
        assert tsw.sizes(small) == (jsw.N, jsw.N_BATCHES, jsw.N_EVAL,
                                    jsw.BATCHES)
        jra = load("bench_rescue_ab", ["--small"] if small else [])
        assert tra.sizes(small) == (jra.N, jra.QUERY_BATCH,
                                    jra.N_QUERY_BATCHES)
        jfk = load("bench_flat_kernel", ["--small"] if small else [])
        assert tfk.sizes(small) == (jfk.M, jfk.REPS) and tfk.B == jfk.B
