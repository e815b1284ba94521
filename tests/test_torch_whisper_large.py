"""Whisper at whisper-large's widths on the CPU: the port against agacs_tpu
with the same JAX-initialized weights (through the converter) and the same
numpy-seeded inputs. The dims are OpenAI large-v2's (d 1280, 20 heads of
64, h 5120, vocabulary 51865, 80 mels) on 2 + 2 layers and short contexts
(64 audio positions, 64 text positions), so each test stays within a few
seconds and ~2 GB; the card runs the full depth (`chip_smoke.py` phase 49).

Tolerances, with their reasons:
  * encoder outputs and decode-step logits 1e-4 x max |ref| (float32
    sums over 1280 and 5120 terms taken in another order, through two
    residual layers);
  * greedy tokens and lengths identical;
  * the train step's loss terms 1e-5 relative (float32 layers), the CTC
    head's gradients (K4's dw, db at K 1280) and the encoder's last layer
    norm's (reached through K4's dx) 1e-4 x max |ref| (JAX's CPU path is
    the dense product, the port's the streaming one: each rounds the
    log-probabilities once more or less, as in `test_torch_vocab_lse.py`);
  * `load_torch_whisper` tensor for tensor equal to JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.greedy import greedy_decode as jax_greedy
from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.models.checkpoint import load_torch_whisper as j_load_torch_whisper
from agacs_tpu.utils.config import load_yaml
from agacs_tpu.utils.config import model_config_from_dict as jax_model_config
from agacs_tpu_torch.decode.greedy import greedy_decode
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import (load_torch_whisper, numpy_from_params,
                                               params_from_numpy)
from agacs_tpu_torch.utils.config import model_config_from_dict

torch.set_num_threads(1)

LARGE = tw.WHISPER_PRESETS["large"]
DIMS = dict(n_mels=80, n_audio_ctx=64, n_vocab=51865, n_text_ctx=64,
            **{**LARGE, "n_audio_layer": 2, "n_text_layer": 2})
RECIPES = os.path.join(os.path.dirname(__file__), "..", "recipes")


def _close(out, ref, rtol, what):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


@pytest.mark.parametrize("size", sorted(jw.WHISPER_PRESETS))
def test_presets_equal_jax(size):
    assert tw.WHISPER_PRESETS[size] == jw.WHISPER_PRESETS[size]
    got = dataclasses.asdict(tw.make_config(size))
    ref = dataclasses.asdict(jw.make_config(size))
    assert {k: v for k, v in got.items() if k != "compute_dtype"} == {
        k: ref[k] for k in got if k != "compute_dtype"}


def test_large_recipe_config_equals_jax():
    """The stage-2 recipe with `whisper_model: large` in both parts: the same
    whisper dims as JAX's config, K4's K 1280 within its KS-128 split route."""
    from agacs_tpu_torch.ops import vocab_lse

    raw = load_yaml(os.path.join(RECIPES, "seame", "conf",
                                 "train_asr_whisper_small_adapter_csloss_2stage.yaml"))
    raw = {**raw, **{part: {**raw[part], "whisper_model": "large"}
                     for part in ("encoder_conf", "decoder_conf")}}
    got = model_config_from_dict(raw).whisper
    ref = jax_model_config(raw).whisper
    for key in ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
                "n_vocab", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer",
                "adapter", "adapter_encoder", "adapter_decoder"):
        assert getattr(got, key) == getattr(ref, key), key
    assert (got.n_audio_state, got.n_audio_head, got.n_audio_layer) == (1280, 20, 32)
    assert got.d_audio_head == 64 and got.n_audio_state <= vocab_lse.SPLIT128_K


@pytest.fixture(scope="module")
def pair():
    jcfg = jw.WhisperConfig(**DIMS, adapter=True)
    tcfg = tw.WhisperConfig(**DIMS, adapter=True)
    params = jw.init_whisper_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = tw.Whisper.from_state_dict(tcfg, params_from_numpy(tree, tcfg))
    return params, jcfg, tcfg, model


def test_encoder_matches_jax(pair):
    params, jcfg, _, model = pair
    mel = np.random.RandomState(1).randn(2, 128, 80).astype(np.float32)
    ref = jw.whisper_encode(params, jcfg, jnp.asarray(mel))
    with torch.inference_mode():
        out = tw.whisper_encode(model, torch.from_numpy(mel))
    assert out.shape == ref.shape == (2, 64, 1280)
    _close(out.numpy(), ref, 1e-4, "encoder")


def test_decode_step_logits_match_jax(pair):
    params, jcfg, tcfg, model = pair
    enc = np.random.RandomState(2).randn(2, 64, 1280).astype(np.float32)
    tokens = [50258, 50260, 50259, 50359, 50363, 1234, 42, 50257]
    cross_j = jw.precompute_cross_kv(params, jcfg, jnp.asarray(enc))
    kv_j = jw.init_self_kv_cache(jcfg, 2, 16)
    kv_t = tw.init_self_kv_cache(tcfg, 2, 16)
    with torch.inference_mode():
        cross_t = tw.precompute_cross_kv(model, torch.from_numpy(enc))
        for pos, tok in enumerate(tokens):
            ids = np.array([tok, (tok * 7) % 50000], np.int32)
            ref, kv_j = jw.whisper_decode_step(
                params, jcfg, jnp.asarray(ids), jnp.int32(pos), kv_j, cross_j)
            out, _ = tw.whisper_decode_step(
                model, torch.from_numpy(ids).long(), pos, kv_t, cross_t)
            assert out.shape == (2, 51865)
            _close(out.numpy(), ref, 1e-4, f"logits at step {pos}")


def test_greedy_token_exact(pair):
    params, jcfg, _, model = pair
    enc = np.random.RandomState(3).randn(2, 64, 1280).astype(np.float32)
    ref_tok, ref_len = jax_greedy(params, jcfg, jnp.asarray(enc), max_steps=8)
    tok, lens = greedy_decode(model, torch.from_numpy(enc), max_steps=8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))


def test_ctc_train_step_matches_jax():
    """One training forward and backward of the TMECS full fine-tune's
    model at large widths with ctc_weight 0.3 (the CTC head at K 1280, the
    port's streaming K4 on the CPU through its plain versions): every loss
    term, and the gradients of the CTC head and of the encoder's last
    layer norm (reached only through the CTC head's dx and the decoder)."""
    jcfg = jasr.ASRModelConfig(whisper=jw.WhisperConfig(**DIMS), use_specaug=False,
                               ctc_weight=0.3)
    tcfg = asr_model.ASRModelConfig(whisper=tw.WhisperConfig(**DIMS), use_specaug=False,
                                    ctc_weight=0.3)
    params = jax.tree.map(np.asarray, jasr.init_asr_params(jax.random.PRNGKey(0), jcfg))
    assert params["ctc"]["w"].shape == (1280, 51865)
    model = tw.Whisper.from_state_dict(tcfg.whisper, params_from_numpy(params, tcfg.whisper))
    trained = ("ctc.weight", "ctc.bias", "encoder.ln_post.weight", "encoder.ln_post.bias")
    for n, p in model.named_parameters():
        p.requires_grad_(n in trained)
    rng = np.random.RandomState(5)
    text = np.full((2, 6), -1, np.int32)
    text[0, :5] = [50260, 50259, 50359, 50363, 1000]
    text[1, :3] = [50260, 1200, 1200]
    batch = {"speech": (rng.randn(2, 20000) * 0.05).astype(np.float32),
             "speech_lengths": np.array([20000, 14000], np.int32), "text": text}

    def jloss(sub):
        p = {**params, "ctc": sub["ctc"],
             "encoder": {**params["encoder"], "ln_post": sub["ln_post"]}}
        return jasr.forward(jax.tree.map(jnp.asarray, p), jcfg,
                            {k: jnp.asarray(v) for k, v in batch.items()}, train=False)

    sub = {"ctc": params["ctc"], "ln_post": params["encoder"]["ln_post"]}
    (_, ref_stats), ref_g = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, sub))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["text"] = tb["text"].long()
    loss, stats = asr_model.forward(model, tcfg, tb, train=False)
    loss.backward()
    assert set(stats) == set(ref_stats) == {"loss", "loss_att", "loss_ctc", "acc"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(ref_stats[k]), rtol=1e-5,
                                   err_msg=k)
    grads = numpy_from_params({n: p.grad for n, p in model.named_parameters()
                               if n in trained})
    for key, ref in (("ctc/w", ref_g["ctc"]["w"]), ("ctc/b", ref_g["ctc"]["b"]),
                     ("encoder/ln_post/w", ref_g["ln_post"]["w"]),
                     ("encoder/ln_post/b", ref_g["ln_post"]["b"])):
        _close(grads[key], ref, 1e-4, key)


def test_load_torch_whisper_large_dims_pt(tmp_path):
    """A float16 OpenAI-layout .pt with large-v2's dims on 2 + 2 layers (its
    `dims` giving the config): the port's `load_torch_whisper` equals JAX's
    + `params_from_numpy` tensor for tensor, in the model's own names."""
    dims = {**{k: v for k, v in DIMS.items()}, "n_audio_ctx": 1500, "n_text_ctx": 448}
    cfg = tw.WhisperConfig(**dims)
    sd = {k: v.half() for k, v in
          tw.init_whisper_params(torch.Generator().manual_seed(3), cfg).items()}
    path = str(tmp_path / "large-2+2.pt")
    torch.save({"dims": dims, "model_state_dict": sd}, path)
    del sd
    got, got_cfg = load_torch_whisper(path)
    ref, _ = j_load_torch_whisper(path)
    assert got_cfg == cfg and got_cfg.d_audio_head == 64
    ref = params_from_numpy(jax.tree.map(np.asarray, ref), got_cfg)
    assert set(got) == set(ref) == set(tw.Whisper(got_cfg, device="meta").state_dict())
    for k in got:
        assert torch.equal(got[k], ref[k]), k
