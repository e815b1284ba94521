"""`decode/ctc_greedy.py` and `ops/frontend_whisper.py` of the port against
agacs_tpu on the CPU, float32, the same JAX-initialised weights and
numpy-seeded audio: CTC best paths and collapsed hypotheses equal; the
whisper frontend's features within 1e-5 x max |ref| and its lengths equal.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import whisper as jw
from agacs_tpu.models.asr_model import ASRModelConfig as JaxASRConfig
from agacs_tpu.models.asr_model import encode as jax_encode
from agacs_tpu.models.asr_model import init_asr_params
from agacs_tpu.ops.frontend_whisper import whisper_frontend as jax_frontend
from agacs_tpu_torch.decode import ctc_greedy as tc
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.ops.frontend_whisper import whisper_frontend

jc = importlib.import_module("agacs_tpu.decode.ctc_greedy")

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=100, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=32, n_text_state=64,
            n_text_head=4, n_text_layer=2)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxASRConfig(whisper=JCFG, ctc_weight=0.3, use_specaug=False)
    params = init_asr_params(jax.random.PRNGKey(6), jcfg)
    # a blank-heavy head: best paths mix blanks, repeats and tokens
    b = np.zeros(51865, np.float32)
    b[0] = 0.5
    params = {**params, "ctc": {**params["ctc"], "b": jnp.asarray(b)}}
    model = tw.Whisper.from_state_dict(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, params), TCFG))
    rng = np.random.RandomState(0)
    speech = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    lens = np.array([16000, 9000], np.int32)
    return params, jcfg, model, speech, lens


def test_collapse_and_best_path_match_jax():
    ids = np.array([[0, 3, 3, 0, 4, 4, 4, 0, 3, 0], [5, 5, 0, 0, 2, 2, 2, 2, 2, 2]])
    assert tc.collapse_ctc(ids) == jc.collapse_ctc(ids) == [[3, 4, 3], [5, 2]]
    assert tc.collapse_ctc(np.array([[0, 0, 0]])) == [[]]
    logits = np.random.RandomState(1).randn(3, 12, 40).astype(np.float32)
    lens = np.array([12, 7, 0], np.int32)
    np.testing.assert_array_equal(
        tc.ctc_best_path(torch.from_numpy(logits), torch.from_numpy(lens)).numpy(),
        np.asarray(jc.ctc_best_path(jnp.asarray(logits), jnp.asarray(lens))))


def test_ctc_greedy_decode_matches_jax(pair):
    """The pipeline on the whisper model with a CTC head: encode, the head
    in the encoder's dtype, best path over the valid frames, collapse."""
    params, jcfg, model, speech, lens = pair
    ref = jc.ctc_greedy_decode(
        params, lambda p, s, l: jax_encode(p, jcfg, s, l, train=False),
        {"speech": jnp.asarray(speech), "speech_lengths": jnp.asarray(lens)})
    cfg = ASRModelConfig(whisper=TCFG, ctc_weight=0.3)
    out = tc.ctc_greedy_decode(
        model, lambda s, l: encode(model, cfg, s, l),
        {"speech": torch.from_numpy(speech), "speech_lengths": torch.from_numpy(lens)})
    assert out == ref
    assert any(out) and 0 not in out[0]


@pytest.mark.parametrize("freeze", [True, False])
def test_whisper_frontend_matches_jax(pair, freeze):
    """Log-mel then the encoder: features within 1e-5 x max |ref|, the
    encoder's output lengths equal; freeze=True returns a tensor that takes
    no gradient, freeze=False one that reaches the encoder's weights."""
    params, _, model, speech, lens = pair
    ref, ref_lens = jax_frontend(params, JCFG, jnp.asarray(speech), jnp.asarray(lens),
                                 freeze=freeze)
    out, out_lens = whisper_frontend(model, torch.from_numpy(speech), torch.from_numpy(lens),
                                     freeze=freeze)
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 50, 64)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    assert out.requires_grad == (not freeze)
    if not freeze:
        out.sum().backward()
        assert model.encoder.conv1.weight.grad is not None
        model.zero_grad(set_to_none=True)
