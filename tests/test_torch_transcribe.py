"""Long-form transcription in the port (`agacs_tpu_torch/decode/transcribe.py`,
`bin/transcribe.py`) against agacs_tpu on the CPU, float32, JAX-initialised
weights (whisper d 64, 2 + 2 layers, n_audio_ctx 1500 so 30 s windows fit,
vocabulary 51865).

Tolerances: at temperature 0 tokens, lengths, languages, segment texts and
times exact (the times are computed from the tokens); sum log-probs within
1e-5 x max(1, |x|); detect_language / no_speech probabilities within 1e-5;
word start and end within 0.02 s (one timestamp step), word probabilities
within 1e-4. Sampled rungs draw from a torch.Generator, not jax.random, so
under sampling only the timestamp rules are held.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import whisper as jw
from agacs_tpu_torch.decode import transcribe as tt
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.text.tokenizer import SpecialTokens

jt = importlib.import_module("agacs_tpu.decode.transcribe")

torch.set_num_threads(1)

SP = SpecialTokens()
DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=48, n_text_state=64,
            n_text_head=4, n_text_layer=2)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))), (a, b)


@pytest.fixture(scope="module")
def pair():
    params = jw.init_whisper_params(jax.random.PRNGKey(4), JCFG)
    model = tw.Whisper.from_state_dict(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, params), TCFG))
    mel = jax.random.normal(jax.random.PRNGKey(5), (2, 100, 80)) * 0.3
    enc = np.array(jw.whisper_encode(params, JCFG, mel))
    return params, model, enc


@pytest.mark.parametrize("prompt", [False, True])
def test_greedy_decode_timestamps_matches_jax(pair, prompt):
    """Temperature 0 on the same encoder output, B 2, 20 steps, with the
    bare [sot, lang, task] primer and with a <|startofprev|> prompt."""
    params, model, enc = pair
    base = [SP.sot, SP.lang_id("zh"), SP.transcribe]
    primer = np.array([[SP.sot_prev, 220, 1000] + base if prompt else base] * 2, np.int32)
    ref = jt.greedy_decode_timestamps(params, JCFG, jnp.asarray(enc), jnp.asarray(primer),
                                      max_steps=20)
    out = tt.greedy_decode_timestamps(model, torch.from_numpy(enc),
                                      torch.from_numpy(primer).long(), max_steps=20)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    _close(out[2].numpy(), ref[2])
    n = primer.shape[1]
    for i in range(2):
        assert tt.timestamp_rule_violations(out[0][i, n : int(out[1][i]) + 1].tolist()) == []


def test_detect_language_and_no_speech_match_jax(pair):
    params, model, enc = pair
    langs, probs = jt.detect_language(params, JCFG, jnp.asarray(enc))
    tlangs, tprobs = tt.detect_language(model, torch.from_numpy(enc))
    assert tlangs == langs
    np.testing.assert_allclose(tprobs, np.asarray(probs), atol=1e-5)
    np.testing.assert_allclose(tt.no_speech_probs(model, torch.from_numpy(enc)),
                               np.asarray(jt.no_speech_probs(params, JCFG, jnp.asarray(enc))),
                               atol=1e-5)


@pytest.mark.parametrize("temperature", [0.0, 0.6, 1.0])
def test_timestamp_rules_hold_under_sampling(pair, temperature):
    """Sampled decodes (a seeded torch.Generator) obey rules 1-4 token by
    token, and a replay of each row through the cached step finds every
    sampled token allowed by all five rules (at temperature 0: the argmax)."""
    _, model, enc = pair
    primer = torch.tensor([[SP.sot, SP.lang_id("en"), SP.transcribe]] * 2)
    gen = torch.Generator().manual_seed(int(temperature * 10))
    tokens, lengths, sum_lp = tt.greedy_decode_timestamps(
        model, torch.from_numpy(enc), primer, max_steps=40, temperature=temperature,
        generator=gen)
    assert torch.isfinite(sum_lp).all()
    for i in range(2):
        sampled = tokens[i, 3 : int(lengths[i]) + 1].tolist()
        assert sampled and tt.timestamp_rule_violations(sampled) == []
        assert tt.replay_timestamp_rules(model, torch.from_numpy(enc[i : i + 1]),
                                         primer[i].tolist(), sampled, temperature,
                                         max_steps=40) == []


def test_rule_checks_catch_violations(pair):
    """Each of rules 1-4 broken in a token sequence is reported; the replay
    reports a token the rules forbid (a text token first: rule 2) and, at
    temperature 0, one that is not the argmax."""
    ts = SP.timestamp_begin
    bad = {
        "rule 1": [ts, SP.no_timestamps],
        "rule 2": [1000, ts + 3, ts + 3],
        "rule 3": [ts, 1000, ts + 5, 1001],
        "rule 4": [ts + 5, 1000, ts + 4, ts + 4],
    }
    for rule, seq in bad.items():
        assert any(m.startswith(rule) for m in tt.timestamp_rule_violations(seq)), rule
    assert tt.timestamp_rule_violations([ts, 1000, ts + 5, ts + 5, 1001, SP.eot]) == []
    _, model, enc = pair
    primer = [SP.sot, SP.lang_id("en"), SP.transcribe]
    tok, n, _ = tt.greedy_decode_timestamps(model, torch.from_numpy(enc[:1]),
                                            torch.tensor([primer]), max_steps=10)
    good = tok[0, 3 : int(n[0]) + 1].tolist()
    first = tt.replay_timestamp_rules(model, torch.from_numpy(enc[:1]), primer,
                                      [1000] + good[1:], max_steps=10)
    assert first and "forbidden" in first[0]
    other = good[0] + 1 if good[0] + 1 <= ts + 50 else good[0] - 1
    assert any("argmax" in m for m in tt.replay_timestamp_rules(
        model, torch.from_numpy(enc[:1]), primer, [other] + good[1:], max_steps=10))


def test_rule_5_forces_a_timestamp():
    """apply_timestamp_rules on synthetic logits: with the timestamps'
    total probability above the best text token every text token is
    masked, below it nothing is; rule 2 admits only the first 51
    timestamps."""
    v = 51865
    ts = SP.timestamp_begin
    lg = torch.full((2, v), -30.0)
    lg[0, 1000] = 7.0  # one strong text token
    lg[1, 1000] = 0.0
    lg[:, ts + 10 : ts + 40] = 2.0  # 30 timestamps at 2.0: mass beats row 1's text
    # after text: no rule 3 mask, timestamps above max_ts open
    args = dict(last=torch.tensor([1000, 1000]), prev=torch.tensor([ts, ts]), n_sampled=3,
                max_ts=torch.tensor([ts, ts]), has_ts=torch.tensor([True, True]))
    out = tt.apply_timestamp_rules(lg, **args)
    assert torch.isfinite(out[0, 1000]) and torch.isinf(out[1, 1000])
    assert torch.isfinite(out[1, ts + 10 : ts + 40]).all()
    first = tt.apply_timestamp_rules(lg, **{**args, "n_sampled": 0})
    allowed = torch.isfinite(first[0]).nonzero()[:, 0]
    assert allowed.min() >= ts and allowed.max() <= ts + tt.MAX_INITIAL_TS


def test_bucket_prompt_and_compression_ratio_match_jax():
    for n in range(0, 300, 7):
        toks = list(range(n))
        assert tt._bucket_prompt(toks) == jt._bucket_prompt(toks)
    for text in ("", "hello hello hello hello hello", "我们 去 market 吧 " * 9, "abc"):
        assert tt.compression_ratio(text) == jt.compression_ratio(text)


def _audio(seconds: float, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(int(16000 * seconds)).astype(np.float32) * 0.1


def _same_result(out, ref, words: bool):
    assert out["language"] == ref["language"]
    assert out["text"] == ref["text"]
    assert len(out["segments"]) == len(ref["segments"]) > 0
    for a, b in zip(out["segments"], ref["segments"]):
        assert (a.start, a.end, a.text, a.tokens) == (b.start, b.end, b.text, b.tokens)
        assert len(a.words) == len(b.words)
        for wa, wb in zip(a.words, b.words):
            assert (wa.word, wa.tokens) == (wb.word, wb.tokens)
            assert abs(wa.start - wb.start) <= 0.02 and abs(wa.end - wb.end) <= 0.02
            assert abs(wa.probability - wb.probability) <= 1e-4
    if words:
        assert sum(len(s.words) for s in out["segments"]) > 0


@pytest.mark.parametrize("kw", [
    dict(word_timestamps=True, initial_prompt="hello there"),
    dict(language="en", condition_on_previous_text=False, word_timestamps=True),
], ids=["detect+prompt+words", "en+no_condition+words"])
def test_transcribe_matches_jax(pair, kw):
    """transcribe() on 40 s (two windows and more, seek by timestamp
    pairs) at temperature 0: JAX's language, segments, times and tokens,
    and word timings within one timestamp step."""
    params, model, _ = pair
    audio = _audio(40.0)
    ref = jt.transcribe(params, JCFG, audio, temperature=(0.0,), max_steps=40, **kw)
    out = tt.transcribe(model, audio, temperature=(0.0,), max_steps=40, **kw)
    _same_result(out, ref, words=True)
    assert len(out["windows"]) >= 2
    for w in out["windows"]:
        assert tt.timestamp_rule_violations(w["sampled"]) == []


def test_transcribe_beam_windows_match_jax(pair):
    """beam_size 3: each window through the beam with <|notimestamps|>
    (window-level times, a full-window seek), as JAX."""
    params, model, _ = pair
    audio = _audio(35.0, seed=1)
    ref = jt.transcribe(params, JCFG, audio, beam_size=3, max_steps=12, language="zh")
    out = tt.transcribe(model, audio, beam_size=3, max_steps=12, language="zh")
    _same_result(out, ref, words=False)
    assert [w["beam"] for w in out["windows"]] == [True, True]


def test_transcribe_cli_long_form(tmp_path, capsys):
    """bin.transcribe --long_form --word_timestamps on the CPU (35 s wav,
    the test-size config): the result equals transcribe() called with the
    CLI's settings (its default temperature ladder, seed 0), every window
    obeys the timestamp rules, segment and word times never decrease, and
    one line is printed per segment and per word. Without --long_form it
    prints Speech2Text's text."""
    import yaml

    from agacs_tpu_torch.bin import transcribe as cli
    from agacs_tpu_torch.data.io import write_wav
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.models.asr_model import ASRModelConfig
    from agacs_tpu_torch.models.checkpoint import numpy_from_params

    cfg = tw.make_config("test", compute_dtype=torch.float32)
    sd = tw.init_whisper_params(torch.Generator().manual_seed(2), cfg)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump({
        "encoder": "whisper", "encoder_conf": {"whisper_model": "test"},
        "decoder_conf": {"whisper_model": "test"}}))
    np.savez(tmp_path / "p.params.npz", **numpy_from_params(sd))
    audio = _audio(35.0, seed=3)
    write_wav(str(tmp_path / "a.wav"), audio)
    argv = [str(tmp_path / "config.yaml"), str(tmp_path / "p.params.npz"),
            str(tmp_path / "a.wav"), "--device", "cpu", "--compute_dtype", "float32"]
    out = cli.main(argv + ["--long_form", "--word_timestamps"])
    printed = capsys.readouterr().out.splitlines()
    model = tw.Whisper.from_state_dict(cfg, sd)
    from agacs_tpu_torch.data.io import read_wav

    ref = tt.transcribe(model, read_wav(str(tmp_path / "a.wav"))[0], word_timestamps=True)
    _same_result(out, ref, words=True)
    assert [w["sampled"] for w in out["windows"]] == [w["sampled"] for w in ref["windows"]]
    for w in out["windows"]:
        assert tt.timestamp_rule_violations(w["sampled"]) == []
    starts = [s.start for s in out["segments"]]
    words = [x for s in out["segments"] for x in s.words]
    assert starts == sorted(starts) and all(s.start <= s.end for s in out["segments"])
    assert [x.start for x in words] == sorted(x.start for x in words)
    import re

    timed = [line for line in printed if re.match(r"^ *\[ *\d+\.\d\d -> +\d+\.\d\d\] ", line)]
    assert len(timed) == len(out["segments"]) + len(words)
    assert printed[-1] == f"# language: {out['language']}"
    res = cli.main(argv + ["--max_steps", "6"])
    want = Speech2Text(model, ASRModelConfig(whisper=cfg), max_steps=6)(
        read_wav(str(tmp_path / "a.wav"))[0])[0]
    assert res["tokens"] == want.tokens
    assert capsys.readouterr().out.startswith(want.text + "\n")
