"""The port's event-pattern, formant and dual-layer SRFFN encoders and
the corpus pre-embedding pipeline against the JAX package's (mirrors of
tests/test_utils_and_extras.py's TestFrequencyEncoder, TestEventEncoder
and TestDualLayerSRFFN, and tests/test_parity_extras.py's
TestPretrainPipeline).

The event encoder is numpy in both packages: patterns, counts and
encodings are bit-equal, and either package loads the other's saved
file. The formant patterns are thresholded sinusoids from the same
numpy basis, so they are bit-equal; the SRFFN's features are f32 sums
held within 1e-6.
"""

import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.encoders import dual_layer_srffn as jsr
from aura_snn_rag_tpu.encoders import event_encoder as jev
from aura_snn_rag_tpu.encoders import frequency_encoder as jfr
from aura_snn_rag_tpu_torch.encoders import dual_layer_srffn as tsr
from aura_snn_rag_tpu_torch.encoders import event_encoder as tev
from aura_snn_rag_tpu_torch.encoders import frequency_encoder as tfr

torch.set_num_threads(1)

TOL = 1e-6
TEXTS = ("I think you should run and think", "create and build and design",
         "We LOVE to walk, then we fear to fly!", "no keywords here", "",
         "Remember: DELETE the file, then remove it and break nothing")
PHONEMES = (["h", "e", "l", "o"], ["a", "r", "t"], ["ʃ", "i", "z", "ə"],
            ["i"], [])


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


# --------------------------------------------------------------------------
# frequency encoder
# --------------------------------------------------------------------------

def test_phoneme_patterns_distinct():
    enc = tfr.FrequencyPatternEncoder(d_model=64, device="cpu")
    p = enc.init_params()
    a = enc.phoneme_pattern(p, "i")
    b = enc.phoneme_pattern(p, "s")
    assert a.shape == (enc.samples,)
    assert not torch.equal(a, b)


def test_encode_sequence():
    enc = tfr.FrequencyPatternEncoder(d_model=32, device="cpu")
    out = enc.encode(enc.init_params(), ["h", "e", "l", "o"])
    assert out.shape == (4, 32)
    assert enc.encode(enc.init_params(), []).shape == (0, 32)


def test_formant_table_vowels():
    assert tfr.IPA_FORMANTS == jfr.IPA_FORMANTS
    assert tfr.IPA_FORMANTS["i"] == (270, 2290)
    assert len(tfr.IPA_FORMANTS) >= 25


@pytest.mark.parametrize("d_model", [16, 64, 256])
def test_frequency_encoder_matches_jax(d_model):
    jenc = jfr.FrequencyPatternEncoder(d_model=d_model)
    tenc = tfr.FrequencyPatternEncoder(d_model=d_model, device="cpu")
    np.testing.assert_array_equal(_np(tenc.basis), np.asarray(jenc.basis))
    jp, tp = jenc.init_params(), tenc.init_params()
    # adapted parameters, so the amplitude, offset and weights all act
    rng = np.random.RandomState(d_model)
    n = len(tenc.phonemes)
    amp = (0.5 + rng.rand(n)).astype(np.float32)
    shift = (rng.rand(n) * 0.4 - 0.2).astype(np.float32)
    jp = jp._replace(amplitude_scale=amp, frequency_shift=shift,
                     f1_weight=np.float32(0.8), f2_weight=np.float32(0.7))
    tp = tp._replace(amplitude_scale=torch.from_numpy(amp),
                     frequency_shift=torch.from_numpy(shift),
                     f1_weight=torch.tensor(0.8), f2_weight=torch.tensor(0.7))
    for ph in tenc.phonemes + ["x"]:
        np.testing.assert_array_equal(_np(tenc.phoneme_pattern(tp, ph)),
                                      np.asarray(jenc.phoneme_pattern(jp, ph)))
    for seq in PHONEMES[:4]:
        np.testing.assert_array_equal(_np(tenc.encode(tp, seq)),
                                      np.asarray(jenc.encode(jp, seq)))


# --------------------------------------------------------------------------
# event encoder
# --------------------------------------------------------------------------

def test_keyword_extraction():
    enc = tev.FastEventPatternEncoder(d_model=32)
    counts = enc.extract_events("I think you should run and think")
    analysis = enc.get_event_analysis("I think you should run")
    assert analysis["cognition"] > 0 and analysis["motion"] > 0
    assert counts.sum() == 3             # think x 2 + run


def test_encode_normalized():
    enc = tev.FastEventPatternEncoder(d_model=32)
    v = enc.encode("create and build and design things")
    assert abs(np.linalg.norm(v) - 1.0) < 1e-5


def test_save_load_roundtrip(tmp_path):
    enc = tev.FastEventPatternEncoder(d_model=16)
    p = str(tmp_path / "patterns.npz")
    enc.save(p)
    enc2 = tev.FastEventPatternEncoder(d_model=16, pattern_file=p)
    np.testing.assert_array_equal(enc.encode("run fast"),
                                  enc2.encode("run fast"))


@pytest.mark.parametrize("seed", [0, 3])
def test_event_encoder_is_bit_equal(seed):
    jenc = jev.FastEventPatternEncoder(d_model=48, seed=seed)
    tenc = tev.FastEventPatternEncoder(d_model=48, seed=seed)
    assert tenc.event_names == jenc.event_names
    assert tenc.keyword_to_event == jenc.keyword_to_event
    assert tenc._regex.pattern == jenc._regex.pattern
    np.testing.assert_array_equal(tenc.patterns, jenc.patterns)
    for text in TEXTS:
        np.testing.assert_array_equal(tenc.extract_events(text),
                                      jenc.extract_events(text))
        np.testing.assert_array_equal(tenc.encode(text), jenc.encode(text))
        assert tenc.get_event_analysis(text) == jenc.get_event_analysis(text)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_patterns_load_across_packages(tmp_path, writer):
    src, dst = (jev, tev) if writer == "jax" else (tev, jev)
    enc = src.FastEventPatternEncoder(d_model=24, seed=5)
    enc.event_weights = enc.event_weights * 2        # not saved, as in JAX
    path = str(tmp_path / "patterns.npz")
    enc.save(path)
    back = dst.FastEventPatternEncoder(d_model=24, pattern_file=path)
    assert back.event_names == enc.event_names
    assert back.keyword_to_event == enc.keyword_to_event
    np.testing.assert_array_equal(back.patterns, enc.patterns)
    for text in TEXTS:
        np.testing.assert_array_equal(
            back.encode(text), dst.FastEventPatternEncoder(
                d_model=24, seed=5).encode(text))


# --------------------------------------------------------------------------
# dual-layer SRFFN
# --------------------------------------------------------------------------

def test_dual_stream_forward():
    srffn = tsr.DualLayerSRFFN(d_model=32, d_ff=64, device="cpu")
    out = srffn.forward("i love to create art", phonemes=["a", "r", "t"])
    assert out["features"].shape == (64,)
    assert 0 <= out["voice"]["vowel_ratio"] <= 1
    assert out["voice"]["pitch_base"] > 0


def test_topology():
    srffn = tsr.DualLayerSRFFN(d_model=16, d_ff=32, device="cpu")
    topo = srffn.get_network_topology()
    assert topo["streams"] == ["semantic", "phonetic"]
    assert topo == jsr.DualLayerSRFFN(d_model=16,
                                      d_ff=32).get_network_topology()


@pytest.mark.parametrize("dims", [(32, 64), (64, 128)])
def test_srffn_matches_jax_across_calls(dims):
    """The same texts through both, in turn: the features carry the
    previous call's state, so a drift would compound."""
    d_model, d_ff = dims
    jm = jsr.DualLayerSRFFN(d_model=d_model, d_ff=d_ff, seed=2)
    tm = tsr.DualLayerSRFFN(d_model=d_model, d_ff=d_ff, seed=2,
                            device="cpu")
    for name in ("semantic_patterns", "phonetic_patterns"):
        np.testing.assert_array_equal(_np(getattr(tm.params, name)),
                                      np.asarray(getattr(jm.params, name)))
    for i, text in enumerate(TEXTS * 2):
        ph = PHONEMES[i % len(PHONEMES)] or None
        jo, to = jm.forward(text, ph), tm.forward(text, ph)
        for key in ("features", "semantic", "phonetic"):
            np.testing.assert_allclose(_np(to[key]), np.asarray(jo[key]),
                                       rtol=0, atol=TOL, err_msg=key)
        assert to["voice"] == jo["voice"]
    np.testing.assert_allclose(_np(tm._prev_state),
                               np.asarray(jm._prev_state), rtol=0, atol=TOL)
    assert tm.read_with_voice("run")["text"] == "run"


# --------------------------------------------------------------------------
# pre-embedding pipeline
# --------------------------------------------------------------------------

def _corpus(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    (d / "a.txt").write_text("the first document")
    (d / "b.jsonl").write_text('{"text": "the second document"}\n'
                               'not json\n"a bare string"\n'
                               '{"body": "a body field"}\n')
    (d / "c.csv").write_text("one,two\nthree,,four\n")
    return d


def test_corpus_embedding(tmp_path):
    from aura_snn_rag_tpu_torch.encoders.pretrain_pipeline import (
        PretrainPipeline)
    d = tmp_path / "corpus"
    d.mkdir()
    (d / "a.txt").write_text("the first document")
    (d / "b.jsonl").write_text('{"text": "the second document"}\n')
    pipe = PretrainPipeline(dim=64, cache_dir=str(tmp_path / "cache"))
    out = pipe.run(str(d), out_path=str(tmp_path / "emb.npz"))
    assert out.shape == (2, 64)
    out2 = pipe.run(str(d))                  # from the cache
    np.testing.assert_allclose(out, out2)
    assert (tmp_path / "emb.npz").exists()


def test_pipeline_matches_jax(tmp_path):
    from aura_snn_rag_tpu.encoders import pretrain_pipeline as jpp
    from aura_snn_rag_tpu_torch.encoders import pretrain_pipeline as tpp
    d = _corpus(tmp_path)
    assert list(tpp.iter_corpus_dir(str(d))) == list(
        jpp.iter_corpus_dir(str(d)))
    jout = jpp.PretrainPipeline(dim=48).run(str(d), max_items=4)
    tout = tpp.PretrainPipeline(dim=48, cache_dir=str(tmp_path / "c"),
                                n_workers=2).run(
        str(d), out_path=str(tmp_path / "e.npz"), max_items=4)
    np.testing.assert_array_equal(tout, jout)
    saved = np.load(tmp_path / "e.npz")
    np.testing.assert_array_equal(saved["embeddings"], tout)
    assert len(saved["sources"]) == 4
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tpp.PretrainPipeline(dim=48).run(str(empty)).shape == (0, 48)
