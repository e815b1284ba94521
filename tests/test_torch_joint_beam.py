"""The port's conformer serving path end to end against agacs_tpu on the
CPU: the joint CTC/attention beam search with transformer-LM shallow
fusion (`decode/joint_beam.py`), the decode CLI on a conformer checkpoint
written by JAX's save_pytree with an LM experiment dir (float32, and bf16
with JAX on its Pallas kernels interpreted), and the scoring CLI.

Tolerances: tokens and lengths exact; beam scores within 1e-4 absolute
(float32 sums over ~10 steps of log-softmax values, LM log-probs and CTC
prefix increments, each ~1e-6 apart between the frameworks); the CLIs'
hyp.trn files and the scoring JSON identical."""

import json
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.joint_beam import joint_beam_decode as jax_joint_beam
from agacs_tpu.models import conformer as jconf
from agacs_tpu.models import lm as jlm
from agacs_tpu_torch.decode.joint_beam import joint_beam_decode
from agacs_tpu_torch.models import conformer as tconf
from agacs_tpu_torch.models import lm as tlm
from agacs_tpu_torch.models.checkpoint import lm_params_from_numpy

torch.set_num_threads(1)

V, SOS, EOS = 300, 298, 299
DEC = dict(vocab_size=V, attention_heads=2, linear_units=256, num_blocks=2, d_model=128)
LM_CONF = dict(vocab_size=V, d_model=128, attention_heads=2, linear_units=256,
               num_blocks=2, sos=SOS, eos=EOS)


def _decoder_pair():
    jcfg = jconf.TransformerDecoderConfig(**DEC)
    tcfg = tconf.TransformerDecoderConfig(**DEC)
    tree = jax.tree.map(np.asarray, jconf.init_transformer_decoder_params(
        jax.random.PRNGKey(11), jcfg))
    # the decoder's tree alone, through the converters' common core
    from agacs_tpu_torch.models.checkpoint import _from_numpy

    dec = tconf.TransformerDecoder(tcfg, device="meta").to_empty(device="cpu")
    dec.load_state_dict(_from_numpy(tree, tconf.TransformerDecoder(tcfg, device="meta")))
    return jcfg, tree, dec.eval()


def _lm_pair():
    jcfg = jlm.TransformerLMConfig(**LM_CONF)
    tcfg = tlm.TransformerLMConfig(**LM_CONF)
    tree = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(12), jcfg))
    return jcfg, tree, tlm.TransformerLM.from_state_dict(tcfg, lm_params_from_numpy(tree, tcfg))


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_joint_beam_matches_jax(loop):
    """Beam 4, ctc 0.4, lm 0.2, pre-beam 8, 10 steps, ragged memory and
    frame lengths: the same tokens, lengths, and scores within 1e-4."""
    jcfg, dtree, dec = _decoder_pair()
    lcfg, ltree, lm = _lm_pair()
    rng = np.random.RandomState(0)
    mem = rng.randn(2, 30, 128).astype(np.float32)
    mlens = np.array([30, 22])
    logits = rng.randn(2, 30, V).astype(np.float32) * 3
    ctc_logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    kw = dict(beam_size=4, pre_beam=8, max_steps=10, sos=SOS, eos=EOS, ctc_weight=0.4,
              lm_weight=0.2, loop=loop)
    t_ref, l_ref, s_ref = jax_joint_beam(
        jax.tree.map(jnp.asarray, dtree), jcfg, jnp.asarray(mem), jnp.asarray(mlens),
        ctc_logp=jnp.asarray(ctc_logp), ctc_frame_lens=jnp.asarray(mlens),
        lm_params=jax.tree.map(jnp.asarray, ltree), lm_cfg=lcfg, **kw)
    tokens, lens, scores = joint_beam_decode(
        dec, torch.from_numpy(mem), torch.from_numpy(mlens),
        ctc_logp=torch.from_numpy(ctc_logp), ctc_frame_lens=torch.from_numpy(mlens),
        lm=lm, **kw)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(l_ref))
    for i, n in enumerate(lens.tolist()):
        np.testing.assert_array_equal(tokens[i, :n].numpy(), np.asarray(t_ref)[i, :n])
    np.testing.assert_allclose(scores.numpy(), np.asarray(s_ref), atol=1e-4)
    assert lens.min() > 3  # searched tokens, not an immediate eos


def _write_wavs(root, rng):
    from agacs_tpu.data.io import write_scp, write_wav

    wavs = {}
    for u, n in {"u1": 44000, "u2": 40000, "u3": 47000}.items():
        wavs[u] = os.path.join(root, f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(os.path.join(root, "wav.scp"), wavs)
    write_scp(os.path.join(root, "text"), {"u1": "hello 你好", "u2": "world 世界",
                                           "u3": "我们 go"})


def _cli_setup(tmp_path):
    """A conformer config.yaml (d 128, 2 heads, 2 blocks, the Whisper
    vocabulary for the CLI's sos/eos, global MVN), its npz from JAX's
    init with random MVN statistics, an LM exp dir and 3 wavs of 2.5-3 s
    (77-91 encoder frames: inside K5's envelope)."""
    from agacs_tpu.models.conformer_asr import init_conformer_asr_params
    from agacs_tpu.train.checkpoint import save_pytree
    from agacs_tpu.utils.config import task_from_dict as jax_task

    conf = {"encoder": "conformer",
            "encoder_conf": {"output_size": 128, "attention_heads": 2,
                             "linear_units": 256, "num_blocks": 2},
            "decoder": "transformer",
            "decoder_conf": {"attention_heads": 2, "linear_units": 256, "num_blocks": 2},
            "normalize": "global_mvn"}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(conf))
    params = init_conformer_asr_params(jax.random.PRNGKey(4),
                                       jax_task(conf, compute_dtype=jnp.float32).cfg)
    rng = np.random.RandomState(6)
    params["mvn"] = {"mean": jnp.asarray(rng.randn(80).astype(np.float32) - 10.0),
                     "std": jnp.asarray(2.0 + rng.rand(80).astype(np.float32))}
    save_pytree(str(tmp_path / "p.params.npz"), params)
    lm_dir = tmp_path / "lm"
    lm_dir.mkdir()
    lm_conf = {"d_model": 128, "attention_heads": 2, "linear_units": 256, "num_blocks": 2}
    (lm_dir / "config.yaml").write_text(yaml.safe_dump({"lm_conf": lm_conf}))
    save_pytree(str(lm_dir / "valid.loss.ave.params.npz"),
                jlm.init_lm_params(jax.random.PRNGKey(5), jlm.TransformerLMConfig(**lm_conf)))
    (tmp_path / "decode.yaml").write_text(
        open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "recipes", "seame", "conf", "decode_asr.yaml")).read())
    _write_wavs(str(tmp_path), rng)
    return ["--config", str(tmp_path / "config.yaml"), "--params",
            str(tmp_path / "p.params.npz"), "--data_dir", str(tmp_path), "--decode_config",
            str(tmp_path / "decode.yaml"), "--lm_exp", str(lm_dir), "--max_steps", "5"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cli_conformer_with_lm_matches_jax_cli(dtype, tmp_path, monkeypatch):
    """bin.decode on the recipe's decode_asr.yaml (beam 10, ctc 0.4, lm 0.2)
    with --lm_exp against agacs_tpu.bin.decode: float32, the same hyp.trn.
    bf16: JAX runs its K5 and K3 Pallas kernels interpreted, the port their
    plain versions (K5 in both encoder blocks); XLA on the CPU rounds bf16
    at other places than PyTorch (its depthwise conv and attention sums:
    60% of the encoder's bf16 outputs sit an ulp or more apart, within
    1e-2 x max), which is enough to reorder a beam of 10 over 51865
    near-flat random-weight candidates after a few tokens. So in bf16
    every utterance is decoded and each hypothesis starts with JAX's
    first token."""
    from agacs_tpu.bin import decode as jax_cli
    from agacs_tpu.eval.scoring import read_trn
    from agacs_tpu_torch.bin import decode as cli
    from agacs_tpu_torch.ops import relpos_flash

    if dtype == "bfloat16":
        monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret")
        monkeypatch.setenv("AGACS_DECODE_KERNEL", "pallas")
    common = _cli_setup(tmp_path) + ["--compute_dtype", dtype]
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    calls = []
    real = relpos_flash.relpos_mha
    monkeypatch.setattr(relpos_flash, "relpos_mha", lambda *a: calls.append(1) or real(*a))
    res = cli.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert len(calls) == (2 if dtype == "bfloat16" else 0)  # 2 blocks, one chunk
    hyp = read_trn(str(tmp_path / "torch" / "hyp.trn"))
    ref = read_trn(str(tmp_path / "jax" / "hyp.trn"))
    if dtype == "float32":
        assert hyp == ref
    else:
        assert {u: h.split()[:1] for u, h in hyp.items()} == \
            {u: h.split()[:1] for u, h in ref.items()}
    assert set(hyp) == {"u1", "u2", "u3"} and all(hyp.values())
    assert (read_trn(str(tmp_path / "torch" / "ref.trn"))
            == read_trn(str(tmp_path / "jax" / "ref.trn")))
    assert res["rtf"]["n_utts"] == 3


def test_score_cli_matches_jax(tmp_path):
    """bin.score --per_bucket on the same .trn files: the same result.json."""
    from agacs_tpu.bin import score as jax_score
    from agacs_tpu_torch.bin import score
    from agacs_tpu_torch.eval.scoring import write_trn

    refs = {"a": "我们 go to school", "b": "hello world", "c": "你好 吗", "d": "ok 去 shop lah",
            "e": "that 是 right", "f": "嗯"}
    hyps = {"a": "我 go to the school", "b": "hello word", "c": "你好", "d": "ok 去 shop",
            "e": "that 不 是 right ok"}
    write_trn(str(tmp_path / "ref.trn"), refs)
    write_trn(str(tmp_path / "hyp.trn"), hyps)
    args = ["--ref", str(tmp_path / "ref.trn"), "--hyp", str(tmp_path / "hyp.trn"),
            "--per_bucket"]
    jax_score.main(args + ["--output_dir", str(tmp_path / "jax")])
    out = score.main(args + ["--output_dir", str(tmp_path / "torch")])
    assert json.load(open(tmp_path / "torch" / "result.json")) == \
        json.load(open(tmp_path / "jax" / "result.json")) == out
    assert (open(tmp_path / "torch" / "result.txt").read()
            == open(tmp_path / "jax" / "result.txt").read())
    assert out["mer"]["err"] > 0 and out["bucket_cs"]["utts"] == 3
