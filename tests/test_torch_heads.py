"""The port's head-counting path against agacs_tpu on the CPU, at f32:
`streaming_lse`, the decoder's probability columns and full score maps,
both head counters, and the `count_heads` and `dump_attention` CLIs on a
generated data dir and the same checkpoint.

Tolerances: lse, p_cols and maps 1e-5 (float32 summation order; masked
entries are -inf on both sides); counts, masks and token ids exact."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.adapt import head_selection as jhs
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops.attention import streaming_lse as jax_streaming_lse
from agacs_tpu_torch.adapt import head_selection as ths
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.ops.attention import streaming_lse

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=3, adapter=True)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)


@pytest.mark.parametrize("causal,tq,tk,block", [
    (False, 37, 37, 8), (True, 37, 37, 8), (False, 20, 45, 16), (False, 9, 9, 512),
    (True, 9, 9, 512)])
def test_streaming_lse_matches_jax(causal, tq, tk, block):
    rng = np.random.RandomState(tq + tk)
    q = rng.randn(2, 3, tq, 16).astype(np.float32)
    k = rng.randn(2, 3, tk, 16).astype(np.float32)
    ref = jax_streaming_lse(jnp.asarray(q), jnp.asarray(k), causal=causal, block=block)
    out = streaming_lse(torch.from_numpy(q), torch.from_numpy(k), causal=causal, block=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def decoded():
    """JAX's and the port's teacher-forced decoder aux on the same weights,
    encoder output and ids (an eos-padded tail, as count_heads feeds it)."""
    params = jw.init_whisper_params(jax.random.PRNGKey(2), JCFG)
    model = tw.Whisper.from_state_dict(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, params), TCFG))
    rng = np.random.RandomState(4)
    enc = rng.randn(2, 32, 64).astype(np.float32)
    ids = rng.randint(0, 50000, (2, 11))
    ids[:, :5] = [50258, 50260, 50259, 50359, 50363]
    ids[1, 8:] = 50257
    out = {}
    for kw in (dict(collect_lang_cols=True, need_probs=True),
               dict(collect_full_maps=True)):
        _, ref = jw.whisper_decode(params, JCFG, jnp.asarray(ids), jnp.asarray(enc),
                                   src_layer=1, **kw)
        with torch.inference_mode():
            _, aux = tw.whisper_decode(model, torch.from_numpy(ids), torch.from_numpy(enc),
                                       src_layer=1, **kw)
        out.update({k: (np.asarray(ref[k]), aux[k].numpy()) for k in aux})
        assert set(aux) == set(ref)
    return out


@pytest.mark.parametrize("key", ["qk_cols", "p_cols", "maps"])
def test_decoder_probs_and_maps_match_jax(decoded, key):
    ref, out = decoded[key]
    assert out.shape == ref.shape and out.shape[0] == DIMS["n_text_layer"] - 1
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_count_language_heads_matches_jax(decoded):
    _, p_cols = decoded["p_cols"]
    n_rows = np.array([11, 9])
    for rows in (None, n_rows):
        ref = jhs.count_language_heads(jnp.asarray(p_cols),
                                       None if rows is None else jnp.asarray(rows))
        out = ths.count_language_heads(torch.from_numpy(p_cols),
                                       None if rows is None else torch.from_numpy(rows))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_count_language_heads_topk_matches_jax(decoded):
    """On the decoder's causal maps (row 0: one finite entry, T - 1 of
    -inf, so its top-2 rests on the tie rule) and on maps whose columns
    1 and 2 dominate, so that heads qualify."""
    _, maps = decoded["maps"]
    boosted = maps.copy()
    boosted[:, :, :2, :, 1:3] += 50.0
    for m in (maps, boosted):
        ref = jhs.count_language_heads_topk(jnp.asarray(m))
        out = ths.count_language_heads_topk(torch.from_numpy(m))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out.sum()) > 0


def test_select_and_save_counts_match_jax(tmp_path):
    counts = np.random.RandomState(0).randint(0, 4, (3, 4))
    for pct in (100.0, 50.0, 10.0):
        np.testing.assert_array_equal(ths.select_heads(counts, pct),
                                      jhs.select_heads(counts, pct))
    ths.save_counts(str(tmp_path / "t.json"), counts)
    jhs.save_counts(str(tmp_path / "j.json"), counts)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    np.testing.assert_array_equal(ths.load_counts(str(tmp_path / "t.json")), counts)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A data dir of three utterances, a whisper-"test" config (adapters in
    both stacks) and a JAX-written checkpoint."""
    import yaml

    from agacs_tpu.data.io import write_scp, write_wav
    from agacs_tpu.models.asr_model import init_asr_params
    from agacs_tpu.train.checkpoint import save_pytree
    from agacs_tpu.utils.config import model_config_from_dict as jax_model_config

    tmp = tmp_path_factory.mktemp("heads")
    conf = {"encoder": "whisper",
            "encoder_conf": {"whisper_model": "test", "adapter": True},
            "decoder_conf": {"whisper_model": "test", "adapter": True}}
    (tmp / "config.yaml").write_text(yaml.safe_dump(conf))
    save_pytree(str(tmp / "p.params.npz"),
                init_asr_params(jax.random.PRNGKey(7),
                                jax_model_config(conf, compute_dtype=jnp.float32)))
    rng = np.random.RandomState(6)
    wavs = {}
    for u, n in {"u1": 20000, "u2": 9000, "u3": 15000}.items():
        wavs[u] = str(tmp / f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(str(tmp / "wav.scp"), wavs)
    write_scp(str(tmp / "text"), {"u1": "我们 go 你好", "u2": "hello", "u3": "一 two 三"})
    return tmp


def _jax_margins(tmp) -> np.ndarray:
    """|2 sum p - n| per (layer, utterance, head) in JAX's own numbers, on
    the batch count_heads forms (one batch at the default batch_bins)."""
    from agacs_tpu.data import ASRDataset, collate_batch
    from agacs_tpu.models.asr_model import encode, init_asr_params
    from agacs_tpu.train.checkpoint import load_pytree_like
    from agacs_tpu.train.losses import add_sos_eos
    from agacs_tpu.utils.config import load_yaml, model_config_from_dict

    cfg = model_config_from_dict(load_yaml(str(tmp / "config.yaml")),
                                 compute_dtype=jnp.float32)
    params = load_pytree_like(str(tmp / "p.params.npz"),
                              init_asr_params(jax.random.PRNGKey(0), cfg))
    ds = ASRDataset(str(tmp), with_cs_labels=False)
    batch = collate_batch([ds[u] for u in ds.utt_ids])
    enc, _ = encode(params, cfg, jnp.asarray(batch["speech"]),
                    jnp.asarray(batch["speech_lengths"]), train=False)
    ys_in, _ = add_sos_eos(jnp.asarray(batch["text"]), cfg.sos, cfg.eos, cfg.ignore_id)
    _, aux = jw.whisper_decode(params, cfg.whisper, ys_in, enc, collect_lang_cols=True,
                               need_probs=True)
    p = np.asarray(aux["p_cols"])
    return np.abs(2 * p.sum(axis=(-1, -2)) - p.shape[3])


@pytest.mark.parametrize("criterion", ["mass", "topk_old"])
def test_count_heads_cli_matches_jax(data_dir, criterion, tmp_path):
    from agacs_tpu.bin.count_heads import main as jax_main
    from agacs_tpu_torch.bin.count_heads import main

    common = ["--config", str(data_dir / "config.yaml"), "--data_dir", str(data_dir),
              "--params", str(data_dir / "p.params.npz"), "--compute_dtype", "float32",
              "--criterion", criterion]
    jax_main(common + ["--output", str(tmp_path / "jax.json")])
    main(common + ["--output", str(tmp_path / "torch.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    out = json.loads((tmp_path / "torch.json").read_text())
    diff = np.asarray(out["counts"]) != np.asarray(ref["counts"])
    if criterion == "mass":
        near = _jax_margins(data_dir) < 1e-4  # heads that may flip on rounding
        print(f"heads within 1e-4 of the threshold in JAX's numbers: {int(near.sum())}")
        assert not near.any()
    assert not diff.any(), (out, ref)
    assert (json.loads((tmp_path / "torch.mask.json").read_text())
            == json.loads((tmp_path / "jax.mask.json").read_text()))


@pytest.mark.parametrize("from_hyp", [False, True])
def test_dump_attention_cli_matches_jax(data_dir, from_hyp, tmp_path):
    from agacs_tpu.bin.dump_attention import main as jax_main
    from agacs_tpu_torch.bin.dump_attention import main

    common = ["--config", str(data_dir / "config.yaml"), "--data_dir", str(data_dir),
              "--params", str(data_dir / "p.params.npz"), "--utts", "u1", "u2"]
    common += ["--from_hyp"] if from_hyp else []
    jax_main(common + ["--output_dir", str(tmp_path / "jax")])
    main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    for u in ("u1", "u2"):
        ref, out = np.load(tmp_path / "jax" / f"{u}.npz"), np.load(tmp_path / "torch" / f"{u}.npz")
        np.testing.assert_array_equal(out["token_ids"], ref["token_ids"])
        np.testing.assert_array_equal(np.isneginf(out["maps"]), np.isneginf(ref["maps"]))
        np.testing.assert_allclose(out["maps"], ref["maps"], atol=1e-5)
        assert ((tmp_path / "torch" / f"{u}.json").read_text()
                == (tmp_path / "jax" / f"{u}.json").read_text())
