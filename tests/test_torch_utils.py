"""The port's utils (`utils/`), `Synapsis` plasticity and the CLI's
`corpus` and `mnist`, against the JAX package where it has a
counterpart:
- `ArrayPool`, `get_memory_stats` and `EnergyTracker` as the JAX
  package's `tests/test_utils_and_extras.py::TestUtils` checks them, the
  tracker on the same spikes as the JAX one; `trace`, `annotate` and
  `StepTimer` on the CPU (the card's trace is `chip_smoke.py`'s);
- `Synapsis` with plasticity: outputs and traces over two chained calls,
  and `stdp_update`, against the flax module and its static method on
  the same parameters and spikes (no module calls either);
- `corpus` runs `tools/build_offline_corpus.py` with the JAX CLI's
  arguments (the subprocess is replaced, its argv checked); `mnist` runs
  the port's whitener -> Oja -> readout script on sklearn's digits, held
  to `benchmarks/bench_mnist.py` from the same initial Oja basis: the
  learned whitener and basis, the features, and the test accuracy."""

import contextlib
import glob
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.models.layers import Synapsis as JSynapsis
from aura_snn_rag_tpu.training import online as jonline
from aura_snn_rag_tpu.utils import EnergyTracker as JEnergyTracker
from aura_snn_rag_tpu_torch import bench_mnist, cli
from aura_snn_rag_tpu_torch.models.layers import Synapsis
from aura_snn_rag_tpu_torch.training import online
from aura_snn_rag_tpu_torch.utils import (
    ArrayPool, EnergyTracker, StepTimer, annotate, get_memory_stats,
    maybe_defragment, trace)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_TOL = 1e-6
MNIST_KEYS = {"metric", "value", "unit", "dataset", "epochs",
              "reference_published", "elapsed_s", "active_components"}
MNIST_EPOCHS, MNIST_HIDDEN, MNIST_BATCH, MNIST_ETA = 1, 16, 64, 0.001
# The first column Oja grows is the normalised mean of a residual that
# nearly cancels (the whitener's first batch is centred on its own mean),
# so the last-bit differences of the two packages' sums turn it by about
# 1e-3 (cosine 1 - 5e-7 on the digits); the initial columns agree to
# 4e-5 and their features, of RMS 1 and up to 53, to 2e-3.
OJA_COLUMN_TOL = 1e-4
OJA_COSINE_TOL = 1e-5
FEATURE_TOL = 1e-2
ACCURACY_POINTS = 1.0


def test_array_pool_reuse():
    pool = ArrayPool()
    a = pool.get((4, 4))
    pool.put(a)
    b = pool.get((4, 4))
    assert a is b
    assert pool.stats() == {"hits": 1, "misses": 1, "pooled": 0}


def test_memory_stats_keys_and_cpu_values():
    """The JAX package's keys; on the CPU zeros and a free ratio of 1, so
    nothing is defragmented."""
    stats = get_memory_stats("cpu")
    assert set(stats) == {"bytes_in_use", "bytes_limit",
                          "peak_bytes_in_use", "free_ratio"}
    assert stats["free_ratio"] == 1.0
    assert maybe_defragment(device="cpu") is False


def test_energy_tracker_matches_jax():
    spikes = np.zeros((2, 4, 8), np.float32)
    spikes[0, 0, 0] = 1.0
    spikes[1, 2, 5] = 2.0
    t, j = EnergyTracker(), JEnergyTracker()
    for _ in range(2):
        t.record("layer", torch.from_numpy(spikes), fan_out=16)
        j.record("layer", jnp.asarray(spikes), fan_out=16)
    assert t.energy_pj() == j.energy_pj()
    assert t.summary() == j.summary()
    e = t.energy_pj()["layer"]
    assert e["spike_events"] == 96.0
    assert e["dense_pj"] > e["spiking_pj"]


def test_trace_annotate_and_step_timer(tmp_path):
    """A trace file with the annotated range; StepTimer's summary."""
    x = torch.randn(64, 64)
    timer = StepTimer()
    assert timer.summary() == {"n": 0}
    with trace(str(tmp_path)) as log_dir:
        for _ in range(3):
            out = []
            with timer.measure(out), annotate("aura_test_scope"):
                out.append(x @ x)
    assert log_dir == str(tmp_path)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert "aura_test_scope" in f.read()
    s = timer.summary()
    assert s["n"] == 3 and 0 < s["p50_ms"] <= s["p95_ms"]


def synapsis_pair(dtype):
    rng = np.random.RandomState(4)
    spikes = [rng.randint(0, 3, (2, 5, 6)).astype(np.float32)
              for _ in range(2)]
    jm = JSynapsis(7, dtype=dtype, enable_plasticity=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(spikes[0]))
    tm = Synapsis(6, 7, dtype=torch.bfloat16 if dtype == jnp.bfloat16
                  else torch.float32, enable_plasticity=True)
    with torch.no_grad():
        tm.kernel.copy_(torch.from_numpy(np.array(
            params["params"]["kernel"])))
        tm.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
    return jm, params, tm, spikes


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_synapsis_traces_match_jax(dtype):
    """Two calls, the second fed the first's traces."""
    jm, params, tm, spikes = synapsis_pair(dtype)
    jstate = tstate = None
    for s in spikes:
        jout, jstate = jm.apply(params, jnp.asarray(s), jstate)
        tout, tstate = tm(torch.from_numpy(s), tstate)
        np.testing.assert_allclose(tout.float().detach().numpy(),
                                   np.asarray(jout, np.float32),
                                   rtol=1e-6, atol=1e-6)
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a.float().detach().numpy(),
                                       np.asarray(b, np.float32), rtol=0,
                                       atol=TRACE_TOL)
    assert tuple(tstate[0].shape) == (2, 6)
    assert tuple(tstate[1].shape) == (2, 7)
    tm.enable_plasticity = False
    assert torch.is_tensor(tm(torch.from_numpy(spikes[0])))


def test_stdp_update_matches_jax():
    rng = np.random.RandomState(5)
    kernel = (rng.randn(6, 7) * 4).astype(np.float32)   # some entries clip
    pre = rng.rand(3, 6).astype(np.float32) * 30
    post = rng.rand(3, 7).astype(np.float32) * 30
    for p, q in ((pre, post), (pre[0], post[0])):
        want = JSynapsis.stdp_update(jnp.asarray(kernel), jnp.asarray(p),
                                     jnp.asarray(q), lr=0.01)
        got = Synapsis.stdp_update(torch.from_numpy(kernel),
                                   torch.from_numpy(p), torch.from_numpy(q),
                                   lr=0.01)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert got.abs().max() <= 10.0


def test_corpus_runs_the_offline_corpus_tool(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(cli.subprocess, "run",
                        lambda args, check: calls.append((args, check)))
    assert cli.main(["corpus", "--out", str(tmp_path), "--vocab",
                     "1000"]) == 0
    cli.corpus()
    tool = os.path.join(ROOT, "tools", "build_offline_corpus.py")
    assert calls == [
        ([sys.executable, tool, "--out", str(tmp_path), "--vocab", "1000"],
         True),
        ([sys.executable, tool, "--vocab", "32000"], True)]


def test_mnist_on_digits(capsys):
    """One epoch at 16 components on the CPU: the JAX script's keys, and
    the readout learns (chance is 10%)."""
    assert cli.main(["mnist", "--device", "cpu", "--epochs", "1",
                     "--hidden", "16"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == MNIST_KEYS
    assert result["dataset"].startswith("sklearn-digits")
    assert result["epochs"] == 1 and result["value"] > 50.0


def test_mnist_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.mnist(epochs=1, hidden=8)


def jax_bench_mnist():
    """`benchmarks/bench_mnist.py`, the JAX script, as a module."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        import bench_mnist as jbench
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmarks"))
    return jbench


def test_mnist_data_matches_the_jax_script():
    """The port's copy of the digits and their split give the JAX
    script's arrays (which sklearn makes)."""
    want = jax_bench_mnist().load_data()
    got = bench_mnist.load_data()
    assert got[4] == want[4]
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_mnist():
    """The JAX script's run at 1 epoch and 16 components (its result),
    and its phase 1 (`bench_mnist.py:83-100`) from its own initial Oja
    basis: (initial basis, whitener, basis, training features)."""
    jbench = jax_bench_mnist()
    argv = ["bench_mnist.py", "--epochs", str(MNIST_EPOCHS), "--hidden",
            str(MNIST_HIDDEN), "--batch", str(MNIST_BATCH), "--oja-eta",
            str(MNIST_ETA)]
    saved, sys.argv = sys.argv, argv
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            result = jbench.main()
    finally:
        sys.argv = saved
    xtr = jbench.load_data()[0]
    D = xtr.shape[1]
    init = jonline.init_oja(jax.random.PRNGKey(0), D, MNIST_HIDDEN,
                            max_components=2 * MNIST_HIDDEN)
    whitener, oja = jonline.init_whitener(D), init
    rng = np.random.RandomState(0)
    for _ in range(MNIST_EPOCHS):
        order = rng.permutation(len(xtr))
        for i in range(0, len(xtr) - MNIST_BATCH + 1, MNIST_BATCH):
            whitener, xw = jonline.whiten_update(
                whitener, jnp.asarray(xtr[order[i:i + MNIST_BATCH]]))
            oja, _ = jonline.oja_step(oja, xw, eta=MNIST_ETA)
    feats = jonline.oja_forward(oja, jonline.whiten(whitener,
                                                    jnp.asarray(xtr)))
    return result, init, whitener, oja, np.asarray(feats)


def port_oja(state) -> online.OjaState:
    return online.OjaState(*[torch.from_numpy(np.array(a)) for a in state])


def test_mnist_basis_matches_jax(jax_mnist):
    """Phase 1 from the JAX script's initial basis, in its batch order:
    the whitener's statistics, the components Oja grew, the basis and
    the features the readout learns from."""
    _, init, jwhitener, joja, jfeats = jax_mnist
    xtr = torch.from_numpy(bench_mnist.load_data()[0])
    whitener, oja = bench_mnist.learn_basis(
        xtr, online.init_whitener(xtr.shape[1], device="cpu"),
        port_oja(init), MNIST_EPOCHS, MNIST_BATCH, MNIST_ETA,
        np.random.RandomState(0))
    for got, want in zip(whitener[:2], jwhitener[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    K = int(joja.K)
    assert int(oja.K) == K > MNIST_HIDDEN            # neurogenesis ran
    W, jW = oja.W.numpy(), np.asarray(joja.W)
    np.testing.assert_allclose(W[:, :MNIST_HIDDEN], jW[:, :MNIST_HIDDEN],
                               rtol=0, atol=OJA_COLUMN_TOL)
    cosines = (W[:, :K] * jW[:, :K]).sum(0) / (
        np.linalg.norm(W[:, :K], axis=0) * np.linalg.norm(jW[:, :K], axis=0))
    assert cosines.min() >= 1 - OJA_COSINE_TOL
    np.testing.assert_array_equal(W[:, K:], jW[:, K:])   # never active
    feats = online.oja_forward(oja, online.whiten(whitener, xtr)).numpy()
    np.testing.assert_allclose(feats[:, :MNIST_HIDDEN],
                               jfeats[:, :MNIST_HIDDEN], rtol=0,
                               atol=FEATURE_TOL)
    assert np.array_equal(feats[:, K:], jfeats[:, K:])


def test_mnist_accuracy_matches_jax(jax_mnist):
    """The whole script from the JAX script's initial basis reaches its
    test accuracy (the readout: torch's Adam against optax's)."""
    jresult, init = jax_mnist[:2]
    with contextlib.redirect_stdout(io.StringIO()):
        result = bench_mnist.run(
            epochs=MNIST_EPOCHS, hidden=MNIST_HIDDEN, batch=MNIST_BATCH,
            oja_eta=MNIST_ETA, device="cpu", oja=port_oja(init))
    assert set(result) == set(jresult) == MNIST_KEYS
    assert result["active_components"] == jresult["active_components"]
    assert abs(result["value"] - jresult["value"]) <= ACCURACY_POINTS
