"""The port's Whisper serving path against agacs_tpu on the CPU, at f32:
the same JAX-initialized weights (through the converter) and the same
numpy-seeded inputs through both packages. Tolerance 1e-4 for encoder
outputs and logits (float32 summation order through a few layers);
greedy tokens and texts must be identical."""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.greedy import greedy_decode as jax_greedy
from agacs_tpu.decode.speech2text import Speech2Text as JaxSpeech2Text
from agacs_tpu.models import whisper as jw
from agacs_tpu.models.asr_model import ASRModelConfig as JaxASRConfig
from agacs_tpu.train.checkpoint import save_pytree
from agacs_tpu.utils.config import load_yaml
from agacs_tpu.utils.config import model_config_from_dict as jax_model_config
from agacs_tpu_torch.decode.greedy import greedy_decode
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.utils.config import model_config_from_dict

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=2, adapter=True)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)
RECIPES = os.path.join(os.path.dirname(__file__), "..", "recipes")


@pytest.fixture(scope="module")
def pair():
    params = jw.init_whisper_params(jax.random.PRNGKey(0), JCFG)
    tree = jax.tree.map(np.asarray, params)
    model = tw.Whisper.from_state_dict(TCFG, params_from_numpy(tree, TCFG))
    return params, tree, model


def _enc(seed=1, b=2, t=32, d=64):
    return np.random.RandomState(seed).randn(b, t, d).astype(np.float32)


def test_converter_from_tree_and_npz(pair, tmp_path):
    params, tree, model = pair
    sd = params_from_numpy(tree, TCFG)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_jax
    blocks = tree["decoder"]["blocks"]
    np.testing.assert_array_equal(
        sd["decoder.blocks.1.cross_attn.query.weight"].numpy(),
        blocks["cross_attn"]["query"]["w"][1].T)
    np.testing.assert_array_equal(
        sd["decoder.blocks.0.adapter_mlp.model.2.bias"].numpy(),
        blocks["adapter_mlp"]["up"]["b"][0])
    np.testing.assert_array_equal(
        sd["encoder.conv2.weight"].numpy(),
        tree["encoder"]["conv2"]["w"].transpose(2, 1, 0))
    path = str(tmp_path / "x.params.npz")
    save_pytree(path, params)
    sd_npz = params_from_numpy(np.load(path), TCFG)
    assert set(sd_npz) == set(sd)
    for k in sd:
        torch.testing.assert_close(sd_npz[k], sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("form", ["self", "cross"])
def test_mha_forms_match_jax(pair, form):
    """`mha` (:352) as MultiHeadAttention: encoder self-attention (K1's
    plain version on the CPU) and the cross-attention form."""
    params, _, model = pair
    rng = np.random.RandomState(7)
    x = rng.randn(2, 20, 64).astype(np.float32)
    xa = rng.randn(2, 32, 64).astype(np.float32) if form == "cross" else None
    part, attn = ("encoder", "attn") if form == "self" else ("decoder", "cross_attn")
    p = jax.tree.map(lambda a: a[1], params[part]["blocks"])[attn]
    ref, _ = jw.mha(p, jnp.asarray(x), None if xa is None else jnp.asarray(xa),
                    n_head=4)
    module = getattr(getattr(model, part).blocks[1], attn)
    with torch.inference_mode():
        out = module(torch.from_numpy(x), None if xa is None else torch.from_numpy(xa))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("frames", [60, 71])  # 71 -> 36 positions, cropped to 32
def test_encoder_matches_jax(pair, frames):
    params, _, model = pair
    mel = np.random.RandomState(frames).randn(2, frames, 80).astype(np.float32)
    ref = jw.whisper_encode(params, JCFG, jnp.asarray(mel))
    with torch.inference_mode():
        out = tw.whisper_encode(model, torch.from_numpy(mel))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_decode_step_logits_match_jax(pair):
    params, _, model = pair
    enc = _enc()
    tokens = [50258, 50260, 50259, 50359, 50363, 1234, 42, 50257]
    cross_j = jw.precompute_cross_kv(params, JCFG, jnp.asarray(enc))
    kv_j = jw.init_self_kv_cache(JCFG, 2, 20)
    kv_t = tw.init_self_kv_cache(TCFG, 2, 20)
    with torch.inference_mode():
        cross_t = tw.precompute_cross_kv(model, torch.from_numpy(enc))
        for pos, tok in enumerate(tokens):
            ids = np.array([tok, (tok * 7) % 50000], np.int32)
            ref, kv_j = jw.whisper_decode_step(
                params, JCFG, jnp.asarray(ids), jnp.int32(pos), kv_j, cross_j)
            out, kv_t2 = tw.whisper_decode_step(
                model, torch.from_numpy(ids).long(), pos, kv_t, cross_t)
            assert kv_t2 is kv_t  # the cache is updated in place
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_greedy_token_exact(pair):
    params, _, model = pair
    enc = _enc(seed=1)
    ref_tok, ref_len = jax_greedy(params, JCFG, jnp.asarray(enc), max_steps=10)
    tok, lens = greedy_decode(model, torch.from_numpy(enc), max_steps=10)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))


def test_greedy_context_cap_and_eot_padding(pair):
    """max_ctx < total: the step count is capped by n_text_ctx, and once a
    row emits eot the rest of it is eot, as in the JAX scan loop."""
    params, tree, _ = pair
    # a large eot embedding row makes eot win some steps, so rows finish
    emb = np.array(tree["decoder"]["token_emb"])
    emb[50257] *= 60.0
    params = {**params, "decoder": {**params["decoder"], "token_emb": jnp.asarray(emb)}}
    model = tw.Whisper.from_state_dict(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, params), TCFG))
    enc = _enc(seed=2, b=4)
    ref_tok, ref_len = jax_greedy(params, JCFG, jnp.asarray(enc), max_steps=70)
    tok, lens = greedy_decode(model, torch.from_numpy(enc), max_steps=70)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
    assert (lens < 64).any()  # some row did finish before the context cap


def test_speech2text_matches_jax(pair):
    params, _, model = pair
    audio = np.random.RandomState(0).randn(2, 64 * 160).astype(np.float32) * 0.1
    lengths = np.array([64 * 160, 50 * 160])
    ref = JaxSpeech2Text(params, JaxASRConfig(whisper=JCFG, use_specaug=False),
                         max_steps=6)(audio, lengths=lengths)
    s2t = Speech2Text(model, ASRModelConfig(whisper=TCFG), max_steps=6)
    out = s2t(audio, lengths=lengths)
    assert [r.tokens for r in out] == [r.tokens for r in ref]
    assert [r.text for r in out] == [r.text for r in ref]
    assert s2t.rtf > 0 and s2t.inverse_rtf > 0


@pytest.mark.parametrize("conf", [
    "seame/conf/train_asr_whisper_small_adapter_csloss_2stage.yaml",
    "seame/conf/train_asr_whisper_small_adapter_encoder.yaml",
    "tmecs/conf/train_asr_whisper_small_pedecoder.yaml",
    "tmecs/conf/train_asr_whisper_small_adapter_decoder.yaml",
])
def test_model_config_from_dict_matches_jax(conf):
    d = load_yaml(os.path.join(RECIPES, conf))
    ref = jax_model_config(d, compute_dtype=jnp.float32)
    out = model_config_from_dict(d, compute_dtype=torch.float32)
    assert out.ctc_weight == ref.ctc_weight
    for f in dataclasses.fields(out.whisper):
        if f.name != "compute_dtype":
            assert getattr(out.whisper, f.name) == getattr(ref.whisper, f.name), f.name
    for part in ("encoder", "decoder"):
        assert out.whisper.part(part).adapter == ref.whisper.part(part).adapter


def test_decode_cli_matches_jax_speech2text(tmp_path):
    """bin/decode on a data dir writes the .trn files agacs_tpu.bin.score
    reads, with the hypotheses JAX's Speech2Text gives on the same audio."""
    import wave

    import yaml

    from agacs_tpu.eval.scoring import read_trn, write_trn
    from agacs_tpu.models.asr_model import init_asr_params
    from agacs_tpu_torch.bin.decode import main
    from agacs_tpu_torch.data.io import read_wav

    conf = {"encoder": "whisper",
            "encoder_conf": {"whisper_model": "test", "adapter": True},
            "decoder_conf": {"whisper_model": "test", "adapter": True}}
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(conf))
    jcfg = jax_model_config(conf, compute_dtype=jnp.float32)
    params = init_asr_params(jax.random.PRNGKey(3), jcfg)
    save_pytree(str(tmp_path / "p.params.npz"), params)

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(5)
    utts = {"u1": 20000, "u2": 9000}
    for u, n in utts.items():
        with wave.open(str(data / f"{u}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.randn(n) * 3000).astype(np.int16).tobytes())
    (data / "wav.scp").write_text("".join(f"{u} {data / u}.wav\n" for u in utts))
    (data / "text").write_text("u1 hello 你好\nu2 world\n")

    out_dir = tmp_path / "out"
    main(["--config", str(cfg_path), "--params", str(tmp_path / "p.params.npz"),
          "--data_dir", str(data), "--output_dir", str(out_dir),
          "--compute_dtype", "float32", "--device", "cpu", "--max_steps", "5"])

    order = ["u2", "u1"]  # length-sorted, one padded batch of 2 s
    audio = np.zeros((2, 32000), np.float32)
    for k, u in enumerate(order):
        x, _ = read_wav(str(data / f"{u}.wav"))
        audio[k, : len(x)] = x
    ref = JaxSpeech2Text(params, jcfg, max_steps=5)(
        audio, lengths=np.array([utts[u] for u in order]))
    write_trn(str(tmp_path / "ref_hyp.trn"), {u: r.text for u, r in zip(order, ref)})
    assert read_trn(str(out_dir / "hyp.trn")) == read_trn(str(tmp_path / "ref_hyp.trn"))
    assert read_trn(str(out_dir / "ref.trn")) == {"u1": "hello 你 好", "u2": "world"}
    assert (out_dir / "rtf.json").exists()
