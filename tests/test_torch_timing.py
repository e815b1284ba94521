"""Word timing and the native host libraries of the port against agacs_tpu on
the CPU: the DTW library (`native/dtw.cpp`) against its plain version
`_dtw_py` and JAX's `dtw` (identical paths), `whisper_decode`'s
cross-attention maps (within 1e-5 x max |ref|, float32),
`find_word_alignment` (words and tokens equal, start and end within 0.02
s, one timestamp step; probabilities within 1e-4), `merge_punctuations`
and the word split (equal), and the sclite aligner (`native/align.cpp`)
against `_align_py` (equal counts). A library that does not build raises.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import whisper as jw
from agacs_tpu_torch.decode import timing as tt
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.text import WhisperTokenizer

jt = importlib.import_module("agacs_tpu.decode.timing")

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=200, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=2)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (7, 30), (25, 140), (40, 40)])
def test_dtw_native_matches_plain_and_jax(shape):
    rng = np.random.RandomState(shape[0] * 100 + shape[1])
    x = rng.randn(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.2] = 0.0  # ties between the three moves
    ni, nj = tt.dtw(x)
    pi, pj = tt._dtw_py(x)
    ji, jj = jt.dtw(x)
    for a, b in ((ni, pi), (nj, pj), (ni, np.asarray(ji)), (nj, np.asarray(jj))):
        np.testing.assert_array_equal(a, b)
    assert ni[0] == nj[0] == 0 and (ni[-1], nj[-1]) == (shape[0] - 1, shape[1] - 1)


def test_median_filter_matches_jax():
    x = np.random.RandomState(0).randn(3, 5, 40).astype(np.float32)
    for width in (1, 3, 7):
        np.testing.assert_array_equal(tt.median_filter(x, width), jt.median_filter(x, width))
    np.testing.assert_array_equal(tt.median_filter(x[..., :2], 7), x[..., :2])


@pytest.fixture(scope="module")
def pair():
    params = jw.init_whisper_params(jax.random.PRNGKey(2), JCFG)
    model = tw.Whisper.from_state_dict(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, params), TCFG))
    enc = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 200, 64)), np.float32)
    return params, model, enc


def test_whisper_decode_cross_maps_match_jax(pair):
    """collect_cross_maps: (L, B, h, T, T_enc) pre-softmax cross scores as
    JAX's; the logits and the other aux keys are unchanged by it."""
    params, model, enc = pair
    toks = np.array([[50258, 50260, 50359, 220, 1000, 2000, 50257]] * 2, np.int32)
    enc2 = np.concatenate([enc, enc * 0.5])
    logits, aux = jw.whisper_decode(params, JCFG, jnp.asarray(toks), jnp.asarray(enc2),
                                    collect_cross_maps=True, collect_lang_cols=True)
    with torch.no_grad():
        tl, taux = tw.whisper_decode(model, torch.from_numpy(toks).long(),
                                     torch.from_numpy(enc2), collect_cross_maps=True,
                                     collect_lang_cols=True)
        plain, paux = tw.whisper_decode(model, torch.from_numpy(toks).long(),
                                        torch.from_numpy(enc2), collect_lang_cols=True)
    ref = np.asarray(aux["cross_maps"])
    assert taux["cross_maps"].shape == ref.shape == (2, 2, 4, 7, 200)
    assert taux["cross_maps"].dtype == torch.float32
    np.testing.assert_allclose(taux["cross_maps"].numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits),
                               atol=1e-5 * np.abs(np.asarray(logits)).max())
    assert sorted(paux) == sorted(k for k in taux if k != "cross_maps")
    np.testing.assert_allclose(plain.numpy(), tl.numpy(), atol=1e-5 * float(tl.abs().max()))
    np.testing.assert_array_equal(paux["qk_cols"].numpy(), taux["qk_cols"].numpy())


@pytest.fixture(scope="module")
def tok():
    return WhisperTokenizer()


TEXTS = ["hello world, this is a test.", "我们 去 market 吧", "(quoted) \"words\" here!"]


@pytest.mark.parametrize("text", TEXTS)
def test_split_to_word_tokens_matches_jax(tok, text):
    from agacs_tpu.text import WhisperTokenizer as JaxTokenizer

    ids = tok.encode(" " + text) + [tok.special.eot]
    assert tt._split_to_word_tokens(ids, tok) == jt._split_to_word_tokens(ids, JaxTokenizer())


def test_merge_punctuations_matches_jax():
    words = [(" \"", 0.0, 0.1), ("Hello", 0.1, 0.4), (",", 0.4, 0.5), (" (", 0.5, 0.6),
             (" world", 0.6, 0.9), (")", 0.9, 1.0), ("。", 1.0, 1.1), (" ok", 1.1, 1.3)]
    mk = [(tt.WordTiming, tt.merge_punctuations), (jt.WordTiming, jt.merge_punctuations)]
    outs = [[dataclass_tuple(w) for w in merge([cls(wd, [i], s, e, 0.5)
                                               for i, (wd, s, e) in enumerate(words)])]
            for cls, merge in mk]
    assert outs[0] == outs[1]
    assert len(outs[0]) < len(words)


def dataclass_tuple(w):
    return (w.word, w.tokens, w.start, w.end, w.probability)


@pytest.mark.parametrize("text", TEXTS)
def test_find_word_alignment_matches_jax(pair, tok, text):
    """Word timings of one utterance on the same encoder output (160 valid
    of 200 frames): the same words and tokens; start and end within one
    timestamp step."""
    from agacs_tpu.text import WhisperTokenizer as JaxTokenizer

    params, model, enc = pair
    ids = tok.encode(" " + text)
    ref = jt.find_word_alignment(params, JCFG, JaxTokenizer(), ids, jnp.asarray(enc), 160)
    out = tt.find_word_alignment(model, tok, ids, torch.from_numpy(enc), 160)
    assert [(w.word, w.tokens) for w in out] == [(w.word, w.tokens) for w in ref]
    assert len(out) >= 2
    for a, b in zip(out, ref):
        assert abs(a.start - b.start) <= 0.02 and abs(a.end - b.end) <= 0.02
        assert abs(a.probability - b.probability) <= 1e-4
        assert 0.0 <= a.start <= a.end <= 160 / tt.TOKENS_PER_SECOND
    assert tt.find_word_alignment(model, tok, [], torch.from_numpy(enc), 160) == []


def test_align_native_matches_plain():
    """The sclite aligner: equal (correct, sub, del, ins) to `_align_py` on
    random token pairs (empty sides included), and through align_counts."""
    from agacs_tpu_torch.eval import scoring

    rng = np.random.RandomState(0)
    for _ in range(200):
        ref = rng.randint(0, 6, rng.randint(0, 15)).tolist()
        hyp = rng.randint(0, 6, rng.randint(0, 15)).tolist()
        assert scoring._align_native(ref, hyp) == scoring._align_py(ref, hyp)
    assert scoring.align_counts(list("abcd"), list("abxde")) == (3, 1, 0, 1)


@pytest.mark.parametrize("lib", ["dtw", "align"])
def test_failed_native_build_raises(tmp_path, monkeypatch, lib):
    """A library that does not build raises (no fallback to Python), and a
    later call with a working compiler builds it into the hashed path."""
    from agacs_tpu_torch.eval import scoring

    native = tt.DTW if lib == "dtw" else scoring.ALIGN
    monkeypatch.setattr(native, "lib", None)
    monkeypatch.setattr(native, "build_dir", tmp_path / "build")
    monkeypatch.setattr(native, "cxx", str(tmp_path / "no-such-compiler"))

    def call():
        if lib == "dtw":
            return tt.dtw(np.zeros((2, 3), np.float32))
        return scoring.align_counts(["a"], ["b"])

    with pytest.raises(RuntimeError, match="no-such-compiler"):
        call()
    monkeypatch.setattr(native, "cxx", "g++")
    call()
    assert [p.name.split("-")[0] for p in (tmp_path / "build").glob("*.so")] == [lib]
