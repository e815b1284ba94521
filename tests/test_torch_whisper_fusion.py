"""The whisper family's fused beam in the port against agacs_tpu on the
CPU: CTC prefix scoring from the model's CTC head, transformer-LM shallow
fusion and the n-gram, each alone and all three, at beam 1 and beam 4,
through `beam_decode`, `Speech2Text` and the decode CLI. Same
JAX-initialised weights on both sides (whisper d 64, 2 + 2 layers,
vocabulary 51865 so the primer ids exist; a 2-block LM), float32.

Tolerances: tokens and lengths exact; scores within 1e-4 x max(1, |score|)
(float32 sums of log-probs, CTC log-add-exp in another order); hyp.trn
files identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.beam import beam_decode as jax_beam
from agacs_tpu.decode.speech2text import Speech2Text as JaxSpeech2Text
from agacs_tpu.models import lm as jlm_mod
from agacs_tpu.models import ngram as jng
from agacs_tpu.models import whisper as jw
from agacs_tpu.models.asr_model import ASRModelConfig as JaxASRConfig
from agacs_tpu.models.asr_model import init_asr_params
from agacs_tpu_torch.decode.beam import beam_decode
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.models import lm as tlm_mod
from agacs_tpu_torch.models import ngram as tng
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.checkpoint import lm_params_from_numpy, params_from_numpy

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=2)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)
LM_DIMS = dict(vocab_size=51865, d_model=64, attention_heads=2, linear_units=128,
               num_blocks=2)
WEIGHTS = {"ctc": dict(ctc_weight=0.3), "lm": dict(lm_weight=0.3),
           "ngram": dict(ngram_weight=0.5),
           "all": dict(ctc_weight=0.3, lm_weight=0.3, ngram_weight=0.5)}


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(b))), (a, b)


def _corpus() -> list[list[int]]:
    """Sequences over a few hundred ids (the n-gram's seen words) with
    repeats, so bigrams and trigrams are found during the search."""
    rng = np.random.RandomState(7)
    vocab = rng.randint(0, 50257, 300)
    return [[int(t) for t in rng.choice(vocab[: rng.randint(20, 300)], rng.randint(3, 12))]
            for _ in range(400)]


@pytest.fixture(scope="module")
def setup():
    jparams = init_asr_params(jax.random.PRNGKey(0), JaxASRConfig(
        whisper=JCFG, ctc_weight=0.3, use_specaug=False))
    # a larger eot embedding row: some hypotheses end early, most run to the cap
    emb = np.array(jparams["decoder"]["token_emb"])
    emb[50257] *= 2.0
    jparams = {**jparams, "decoder": {**jparams["decoder"], "token_emb": jnp.asarray(emb)}}
    flat = jax.tree.map(np.asarray, jparams)
    model = tw.Whisper.from_state_dict(TCFG, params_from_numpy(flat, TCFG))
    jlm_cfg = jlm_mod.TransformerLMConfig(compute_dtype=jnp.float32, **LM_DIMS)
    tlm_cfg = tlm_mod.TransformerLMConfig(compute_dtype=torch.float32, **LM_DIMS)
    jlm = jlm_mod.init_lm_params(jax.random.PRNGKey(1), jlm_cfg)
    tlm = tlm_mod.TransformerLM.from_state_dict(
        tlm_cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jlm), tlm_cfg))
    corpus = _corpus()
    return {"jparams": jparams, "model": model, "jlm": jlm, "jlm_cfg": jlm_cfg, "tlm": tlm,
            "jng": jng.train_ngram(corpus, 51865, order=3, sos=50258),
            "tng": tng.train_ngram(corpus, 51865, order=3, sos=50258), "corpus": corpus}


def _ctc_logp(jparams, enc: np.ndarray) -> np.ndarray:
    logits = enc @ np.asarray(jparams["ctc"]["w"]) + np.asarray(jparams["ctc"]["b"])
    return np.array(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32), -1))


@pytest.mark.parametrize("scorers", list(WEIGHTS))
@pytest.mark.parametrize("beam", [1, 4])
def test_beam_decode_fusion_matches_jax(setup, scorers, beam):
    """beam_decode with each scorer on the same encoder output, CTC
    log-probs and frame lengths (B 2, one utterance shorter), 10 steps."""
    s = setup
    w = WEIGHTS[scorers]
    enc = np.random.RandomState(1).randn(2, 32, 64).astype(np.float32)
    logp = _ctc_logp(s["jparams"], enc)
    lens = np.array([32, 23], np.int32)
    ref = jax_beam(s["jparams"], JCFG, jnp.asarray(enc), beam_size=beam, max_steps=10,
                   ctc_weight=w.get("ctc_weight", 0.0), ctc_logp=jnp.asarray(logp),
                   ctc_frame_lens=jnp.asarray(lens), lm_params=s["jlm"],
                   lm_cfg=s["jlm_cfg"], lm_weight=w.get("lm_weight", 0.0),
                   ngram_lm=s["jng"], ngram_weight=w.get("ngram_weight", 0.0))
    out = beam_decode(s["model"], torch.from_numpy(enc), beam_size=beam, max_steps=10,
                      ctc_weight=w.get("ctc_weight", 0.0), ctc_logp=torch.from_numpy(logp),
                      ctc_frame_lens=torch.from_numpy(lens).long(), lm=s["tlm"],
                      lm_weight=w.get("lm_weight", 0.0), ngram_lm=s["tng"],
                      ngram_weight=w.get("ngram_weight", 0.0))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    _close(out[2].numpy(), ref[2])


def test_each_scorer_moves_the_search(setup):
    """Against the plain beam, every scorer changes the scores (it is on),
    and the n-gram's seen words gain: fused with the n-gram, the search
    picks more of the corpus's ids."""
    s = setup
    enc = torch.from_numpy(np.random.RandomState(1).randn(2, 32, 64).astype(np.float32))
    logp = torch.from_numpy(_ctc_logp(s["jparams"], enc.numpy()))
    plain = beam_decode(s["model"], enc, beam_size=4, max_steps=10)
    for name, w in WEIGHTS.items():
        out = beam_decode(s["model"], enc, beam_size=4, max_steps=10, ctc_logp=logp,
                          lm=s["tlm"], ngram_lm=s["tng"], **w)
        assert not np.allclose(out[2].numpy(), plain[2].numpy()), name
    seen = {t for seq in s["corpus"] for t in seq}
    ng = beam_decode(s["model"], enc, beam_size=4, max_steps=10, ngram_lm=s["tng"],
                     ngram_weight=2.0)

    def hits(tokens, lens):
        return sum(t in seen for row, n in zip(tokens.tolist(), lens.tolist())
                   for t in row[5:n])

    assert hits(ng[0], ng[1]) > hits(plain[0], plain[1])


@pytest.mark.parametrize("scorers", list(WEIGHTS))
@pytest.mark.parametrize("beam", [1, 4])
def test_speech2text_fusion_matches_jax(setup, scorers, beam):
    """Speech2Text end to end (encode, the CTC head's log-probs over the
    encoder's output lengths, the fused beam; JAX's rule: any fusion weight
    takes the beam, at beam 1 too): texts and tokens exact, scores within
    1e-4 x max(1, |score|)."""
    s = setup
    w = WEIGHTS[scorers]
    audio = np.random.RandomState(0).randn(2, 64 * 160).astype(np.float32) * 0.1
    lengths = np.array([64 * 160, 45 * 160])
    ref = JaxSpeech2Text(s["jparams"], JaxASRConfig(whisper=JCFG, ctc_weight=0.3,
                                                    use_specaug=False),
                         beam_size=beam, max_steps=8, lm_params=s["jlm"],
                         lm_cfg=s["jlm_cfg"], ngram_lm=s["jng"], **w)(audio, lengths=lengths)
    out = Speech2Text(s["model"], ASRModelConfig(whisper=TCFG), beam_size=beam, max_steps=8,
                      lm=s["tlm"] if "lm_weight" in w else None,
                      ngram_lm=s["tng"] if "ngram_weight" in w else None,
                      **w)(audio, lengths=lengths)
    assert [r.tokens for r in out] == [r.tokens for r in ref]
    assert [r.text for r in out] == [r.text for r in ref]
    _close([r.score for r in out], [r.score for r in ref])
    assert all(r.score != 0.0 for r in out)  # the beam ran, not greedy


def test_speech2text_refuses_a_ctc_weight_without_a_head(setup):
    """As JAX: ctc_weight > 0 on a model without the CTC head raises."""
    sd = {k: v for k, v in setup["model"].state_dict().items() if not k.startswith("ctc.")}
    headless = tw.Whisper.from_state_dict(TCFG, sd)
    with pytest.raises(ValueError, match="CTC head"):
        Speech2Text(headless, ASRModelConfig(whisper=TCFG), ctc_weight=0.3)


def _exp_dir(tmp_path, setup):
    """A whisper exp dir whose checkpoint has ctc/ leaves, an LM exp dir,
    an n-gram npz from bin.ngram_train and a two-utterance data dir."""
    import yaml

    from agacs_tpu.data.io import write_scp, write_wav
    from agacs_tpu.train.checkpoint import save_pytree
    from agacs_tpu_torch.bin import ngram_train

    conf = {"encoder": "whisper", "model_conf": {"ctc_weight": 0.3},
            "encoder_conf": {"whisper_model": "test"},
            "decoder_conf": {"whisper_model": "test"}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(conf))
    from agacs_tpu.utils.config import model_config_from_dict

    jcfg = model_config_from_dict(conf, compute_dtype=jnp.float32)
    params = init_asr_params(jax.random.PRNGKey(3), jcfg)
    emb = np.array(params["decoder"]["token_emb"])
    emb[50257] *= 2.0
    params = {**params, "decoder": {**params["decoder"], "token_emb": jnp.asarray(emb)}}
    assert "ctc" in params
    save_pytree(str(tmp_path / "p.params.npz"), params)
    lm_dir = tmp_path / "lm"
    lm_dir.mkdir()
    (lm_dir / "config.yaml").write_text(yaml.safe_dump({"lm_conf": LM_DIMS}))
    save_pytree(str(lm_dir / "valid.loss.ave.params.npz"), setup["jlm"])
    rng = np.random.RandomState(5)
    wavs = {}
    for u, n in {"u1": 20000, "u2": 9000}.items():
        wavs[u] = str(tmp_path / f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(str(tmp_path / "wav.scp"), wavs)
    write_scp(str(tmp_path / "text"), {"u1": "hello 你好 world", "u2": "world 你好"})
    ngram_train.main(["--train_text", str(tmp_path / "text"),
                      "--output", str(tmp_path / "ngram.npz")])
    return ["--config", str(tmp_path / "config.yaml"),
            "--params", str(tmp_path / "p.params.npz"), "--data_dir", str(tmp_path),
            "--compute_dtype", "float32", "--max_steps", "6"]


@pytest.mark.parametrize("mode", ["fusion", "whisper_yaml"])
def test_decode_cli_ctc_head_matches_jax_cli(tmp_path, setup, monkeypatch, mode):
    """bin.decode on an exp dir whose checkpoint has a CTC head: with
    `--ctc_weight 0.3 --lm_exp L --ngram_file N` (beam 1, every scorer on:
    the beam path) and with `decode_asr_whisper.yaml` (greedy), the same
    hyp.trn as agacs_tpu.bin.decode, and the same Speech2Text settings."""
    import os

    from agacs_tpu.bin import decode as jax_cli
    from agacs_tpu.eval.scoring import read_trn
    from agacs_tpu_torch.bin import decode as cli

    common = _exp_dir(tmp_path, setup)
    if mode == "fusion":
        common += ["--ctc_weight", "0.3", "--lm_exp", str(tmp_path / "lm"),
                   "--ngram_file", str(tmp_path / "ngram.npz")]
    else:
        common += ["--decode_config", os.path.join(
            os.path.dirname(__file__), "..", "recipes", "seame", "conf",
            "decode_asr_whisper.yaml")]
    seen = {}
    for name, mod in (("jax", jax_cli), ("torch", cli)):
        base = mod.Speech2Text

        class Recording(base):
            def __call__(self, *a, _name=name, **k):
                seen[_name] = (self.beam_size, self.ctc_weight, self.lm_weight,
                               self.ngram_weight)
                return super().__call__(*a, **k)

        monkeypatch.setattr(mod, "Speech2Text", Recording)
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    cli.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    hyp = read_trn(str(tmp_path / "torch" / "hyp.trn"))
    assert hyp == read_trn(str(tmp_path / "jax" / "hyp.trn"))
    assert len(hyp) == 2
    assert seen["torch"] == seen["jax"] == ((1, 0.3, 0.3, 0.3) if mode == "fusion"
                                            else (1, 0.0, 0.0, 0.0))
