"""The port's scripts (`aura_snn_rag_tpu_torch/scripts/`) against the JAX
scripts of the same names in `scripts/`, loaded by their paths and run
through their `main` under the same argv:

- `prepare_dataset` over a folder of .txt, .jsonl and .csv files: the
  saved `.npz` (sequences and sources) equal bit for bit, and the line;
- `tune_prosody_hyperparameters` over a short grid: the printed object's
  keys in order, the trial count, every trial's metrics within the
  prosody bound (gains 1e-6 where the LIF spikes agree, as
  `tests/test_torch_language_zone.py` holds them), and the order of the
  best three where no spike flips;
- `visualize_prosody`: the traces against the JAX functions on the same
  ids within that bound (winners equal where no spike flips), the PNG
  written and the line;
- the device rule.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.models import prosody as jp
from aura_snn_rag_tpu_torch.models import prosody as tp
from aura_snn_rag_tpu_torch.scripts import prepare_dataset as tpd
from aura_snn_rag_tpu_torch.scripts import tune_prosody_hyperparameters as ttu
from aura_snn_rag_tpu_torch.scripts import visualize_prosody as tvi
from tests.test_torch_common import highest

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAIN_TOL = 1e-6         # tests/test_torch_language_zone.py's prosody bound


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(name, argv):
    """The JAX script's `main` under `argv`: its stdout."""
    module = load(name)
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        with highest(), contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = saved
    return buf.getvalue()


def quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


def lif_flips(ids, decay):
    """Whether any LIF spike of the three prosody channels differs between
    the packages on `ids` [B, T] (XLA's sin and cos differ from
    PyTorch's in the last bit on a few ids)."""
    amp, pitch, bnd = jp.prosody_channels_from_tokens(jnp.asarray(ids))
    want = np.stack([np.asarray(jp._lif_chain(c, d))
                     for c, d in zip((amp, pitch, bnd), decay)])
    tamp, tpitch, tbnd = tp.prosody_channels_from_tokens(
        torch.as_tensor(ids))
    got = tp._lif_chains(torch.stack([tamp, tpitch, tbnd]),
                         torch.tensor(decay)[:, None]).numpy()
    return bool((want != got).any())


# --------------------------------------------------------------------------
# prepare_dataset
# --------------------------------------------------------------------------

def test_prepare_dataset_writes_the_script_s_npz(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.RandomState(0)
    words = ["alpha", "beta", "gamma", "delta", "épsilon", "zeta", "η"]
    (src / "a.txt").write_text(" ".join(rng.choice(words, 400)))
    (src / "sub" / "b.jsonl").write_text("\n".join(
        json.dumps({"text": " ".join(rng.choice(words, 50))})
        for _ in range(20)) + "\nnot json\n")
    (src / "c.csv").write_text("\n".join(
        ",".join(rng.choice(words, 5)) for _ in range(40)))
    argv = ["--corpus-dir", str(src), "--seq-len", "64",
            "--max-sequences", "30"]
    out = run_jax("prepare_dataset", argv + ["--out",
                                             str(tmp_path / "jax.npz")])
    res = quiet(tpd.run, argv + ["--out", str(tmp_path / "port.npz")])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files) == ["sequences", "sources"]
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert got["sequences"].shape == (30, 64)
    assert res.lines == [out.strip().replace(str(tmp_path / "jax.npz"),
                                             str(tmp_path / "port.npz"))]


# --------------------------------------------------------------------------
# tune_prosody_hyperparameters
# --------------------------------------------------------------------------

def test_prosody_tuner_matches_jax():
    argv = ["--trials", "6", "--seq-len", "48"]
    # every trial's metrics, through the JAX script's own scorer
    module = load("tune_prosody_hyperparameters")
    inner, scored = module.score_config, []

    def recording(cfg, batches):
        out = inner(cfg, batches)
        scored.append((cfg, out))
        return out
    module.score_config = recording
    buf, saved = io.StringIO(), sys.argv
    sys.argv = ["tune_prosody_hyperparameters.py", *argv]
    try:
        with highest(), contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = saved
    want = json.loads(buf.getvalue())
    res = quiet(ttu.run, argv + ["--device", "cpu"])
    assert list(res.summary) == list(want) == ["best", "trials"]
    assert res.summary["trials"] == want["trials"] == len(scored) == 6
    for got in res.summary["best"]:
        assert list(got) == list(want["best"][0])
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 32000, (4, 48)) for _ in range(4)]
    flips = {d: any(lif_flips(b, (d,) * 3) for b in batches)
             for d in (0.6, 0.7, 0.8)}
    rows = {(r["decay"], r["gain_up"], r["k_winners"], r["smoothing"]): r
            for r in res.results}
    for cfg, (score, metrics) in scored:
        row = rows[(cfg.decay[0], cfg.gain_up, cfg.k_winners,
                    cfg.smoothing)]
        if flips[cfg.decay[0]]:
            continue
        assert row["coverage"] == metrics["coverage"]
        for key in ("dynamic_range", "mean_mu"):
            assert row[key] == pytest.approx(metrics[key], rel=GAIN_TOL)
        assert row["score"] == pytest.approx(round(score, 4), abs=1e-4)
    config = ("decay", "gain_up", "k_winners", "smoothing")
    if not any(flips.values()):
        assert [[r[k] for k in config] for r in res.summary["best"]] == \
            [[r[k] for k in config] for r in want["best"]]


# --------------------------------------------------------------------------
# visualize_prosody
# --------------------------------------------------------------------------

def test_prosody_traces_match_jax():
    ids = tvi.token_ids(128)
    got = tvi.traces(ids, "cpu")
    assert list(got) == list(tvi.TRACES)
    x = jnp.asarray(ids)
    amp, pitch, bnd = jp.prosody_channels_from_tokens(x)
    gains, info = jp.prosody_attention_gains(x)
    want = dict(amplitude=amp, pitch=pitch, boundary=bnd,
                salience=info["salience"], winners=info["winners"],
                gains=gains, mu_scalar=info["mu_scalar"])
    for key in ("amplitude", "pitch", "boundary"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=GAIN_TOL)
    # no LIF spike flips on the script's ids (a flip would move the
    # salience and the winners a whole spike level apart)
    assert not lif_flips(ids, jp.ProsodyAttentionConfig().decay)
    for key in ("salience", "gains", "mu_scalar"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=GAIN_TOL)
    np.testing.assert_array_equal(got["winners"], np.asarray(want["winners"]))


def test_visualize_prosody_writes_the_png(tmp_path):
    pytest.importorskip("matplotlib")
    out = run_jax("visualize_prosody", ["--out", str(tmp_path / "jax.png"),
                                        "--seq-len", "64"])
    res = quiet(tvi.run, ["--out", str(tmp_path / "port.png"),
                          "--seq-len", "64", "--device", "cpu"])
    assert res.lines == [out.strip().replace("jax.png", "port.png")]
    assert os.path.getsize(tmp_path / "port.png") > 10_000
    assert res.traces["gains"].shape == (1, 64)


# --------------------------------------------------------------------------
# flags and the device rule
# --------------------------------------------------------------------------

MODULES = {"prepare_dataset": tpd, "tune_prosody_hyperparameters": ttu,
           "visualize_prosody": tvi}


def script_flags(path):
    """{flag: default} of a script's `add_argument` calls."""
    import ast
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            out[node.args[0].value] = kw.get("default", False if kw.get(
                "action") == "store_true" else None)
    return out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_flags_defaults_and_device_rule(name, tmp_path):
    module = MODULES[name]
    want = script_flags(os.path.join(ROOT, "scripts", f"{name}.py"))
    got = {o: a.default for a in module.parser()._actions
           for o in a.option_strings if o not in ("-h", "--help")}
    if name == "prepare_dataset":
        # host code: no device to choose
        assert got == want
        return
    assert got.pop("--device") == "cuda"
    assert got == want
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run(["--out", str(tmp_path / "x.png")]
                   if name == "visualize_prosody" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvi.traces(tvi.token_ids(8), "cuda")
