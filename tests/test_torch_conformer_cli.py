"""The conformer recipe's stages 1-3 on the CPU, through the port's CLIs
(`recipes/seame/run_conformer.sh`): `bin.collect_stats` against JAX's
CLI (the same shape files and feats_stats.npz), `bin.lm_train`
against JAX's CLI from the same initial weights (the loss history within
1e-5 relative; its npz loads in both packages), and `bin.train` on
train_asr_conformer.yaml at a small width for one epoch, whose
valid.acc.ave.params.npz both packages' `bin.decode` (stage 4) decode with
the LM. Data: generated wavs of 2.5-3 s.

Tolerances: the feature mean 1e-6 x max |ref| (float32 sums of the same
features, computed by two frontends that agree to float32 rounding); the
std 2e-5 x max |ref| (it is sqrt(E[x^2] - mean^2), the difference of two
sums ~100 times the variance, so the frontends' ~1e-7 relative agreement
grows a hundredfold); the LM's losses 1e-5 relative (float32 training, summation order). The train
CLI's trajectory is not compared with JAX's: JAX's CLI packs batches on a
B grid and ignores accum_grad, the port's does neither.
"""

import os

import numpy as np
import yaml

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.bin import collect_stats as jax_collect_stats
from agacs_tpu.bin import decode as jax_decode
from agacs_tpu.bin import lm_train as jax_lm_train
from agacs_tpu.data.io import write_scp, write_wav
from agacs_tpu.models import lm as jlm
from agacs_tpu.train.checkpoint import load_pytree_like
from agacs_tpu_torch.bin import collect_stats, decode, lm_train, train
from agacs_tpu_torch.eval.scoring import read_trn
from agacs_tpu_torch.models import lm as tlm
from agacs_tpu_torch.models.checkpoint import lm_params_from_numpy, numpy_from_lm_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "recipes", "seame", "conf")
TEXTS = {"u1": "hello 你好", "u2": "world 世界", "u3": "我们 go", "u4": "好 ok lah"}
LENS = {"u1": 44000, "u2": 40000, "u3": 47000, "u4": 42000}
SMALL = ["encoder_conf.output_size=128", "encoder_conf.attention_heads=2",
         "encoder_conf.linear_units=256", "encoder_conf.num_blocks=2",
         "decoder_conf.attention_heads=2", "decoder_conf.linear_units=256",
         "decoder_conf.num_blocks=1", "keep_nbest_models=1"]
LM_ARGS = ["--d_model", "64", "--attention_heads", "2", "--linear_units", "128",
           "--num_blocks", "2", "--compute_dtype", "float32"]


def _data(root: str, seed: int = 0) -> str:
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    wavs = {}
    for u, n in LENS.items():
        wavs[u] = os.path.join(root, f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(os.path.join(root, "wav.scp"), wavs)
    write_scp(os.path.join(root, "text"), TEXTS)
    return root


def test_collect_stats_matches_jax_cli(tmp_path):
    data = _data(str(tmp_path / "data"))
    ref = jax_collect_stats.main(["--data_dir", data, "--output_dir", str(tmp_path / "jax")])
    out = collect_stats.main(["--data_dir", data, "--output_dir", str(tmp_path / "torch"),
                              "--device", "cpu"])
    assert out["n_frames"] == ref["n_frames"] == sum(n // 128 + 1 for n in LENS.values())
    for name in ("speech_shape", "text_shape"):
        assert (tmp_path / "torch" / name).read_text() == (tmp_path / "jax" / name).read_text()
    with np.load(tmp_path / "torch" / "feats_stats.npz") as got, \
            np.load(tmp_path / "jax" / "feats_stats.npz") as want:
        assert set(got.files) == set(want.files) == {"mean", "std", "count"}
        assert int(got["count"]) == int(want["count"])
        for k, rtol in (("mean", 1e-6), ("std", 2e-5)):
            assert got[k].dtype == np.float32 and got[k].shape == (80,)
            np.testing.assert_allclose(got[k], want[k], atol=rtol * np.abs(want[k]).max())


def test_lm_train_matches_jax_cli(tmp_path, monkeypatch):
    """Two epochs of a tiny LM from the same initial weights (JAX's init,
    handed to the port) against JAX's CLI, both in float32."""
    data = _data(str(tmp_path / "data"))
    cfg = jlm.TransformerLMConfig(d_model=64, attention_heads=2, linear_units=128,
                                  num_blocks=2)
    init = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(3), cfg))
    monkeypatch.setattr(jax_lm_train, "init_lm_params",
                        lambda rng, c: jax.tree.map(jnp.asarray, init))
    monkeypatch.setattr(lm_train, "init_lm_params",
                        lambda gen, c: lm_params_from_numpy(init, c))
    common = ["--train_text", os.path.join(data, "text"), "--valid_text",
              os.path.join(data, "text"), "--max_epoch", "2", "--batch_tokens", "24",
              "--warmup_steps", "4", *LM_ARGS]
    ref = jax_lm_train.main(common + ["--exp_dir", str(tmp_path / "jax")])
    out = lm_train.main(common + ["--exp_dir", str(tmp_path / "torch"), "--device", "cpu"])
    for ep in (1, 2):
        for phase in ("train", "valid"):
            np.testing.assert_allclose(out["history"][ep][phase]["loss"],
                                       ref["history"][ep][phase]["loss"], rtol=1e-5,
                                       err_msg=f"epoch {ep} {phase}")
    assert out["history"][2]["train"]["loss"] < out["history"][1]["train"]["loss"]
    assert yaml.safe_load((tmp_path / "torch" / "config.yaml").read_text()) == \
        yaml.safe_load((tmp_path / "jax" / "config.yaml").read_text())
    ave = str(tmp_path / "torch" / "valid.loss.ave.params.npz")
    assert out["ave"] == ave
    template = jlm.init_lm_params(jax.random.PRNGKey(0), cfg)
    loaded = load_pytree_like(ave, template)
    tcfg = tlm.TransformerLMConfig(d_model=64, attention_heads=2, linear_units=128,
                                   num_blocks=2)
    with np.load(ave) as npz:
        sd = lm_params_from_numpy(dict(npz), tcfg)
    back = numpy_from_lm_params(sd, tcfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        key = "/".join(str(k.key) for k in path)
        np.testing.assert_array_equal(back[key], np.asarray(leaf), err_msg=key)


def test_conformer_train_cli_checkpoint_decodes_in_both_packages(tmp_path):
    """Stages 1-4 on the port: stats, a one-epoch train of
    train_asr_conformer.yaml at d 128 / 2 blocks (global MVN from stage 1,
    SpecAug, dropout 0.1, Adam, WarmupLR, accum_grad 2), then both
    packages' bin.decode of its n-best average with decode_asr.yaml and an
    LM exp dir."""
    data = _data(str(tmp_path / "data"), seed=1)
    collect_stats.main(["--data_dir", data, "--output_dir", str(tmp_path / "stats"),
                        "--device", "cpu"])
    lm_dir = tmp_path / "lm"
    lm_dir.mkdir()
    lcfg = tlm.TransformerLMConfig(d_model=64, attention_heads=2, linear_units=128,
                                   num_blocks=2)
    (lm_dir / "config.yaml").write_text(yaml.safe_dump({"lm_conf": {
        "d_model": 64, "attention_heads": 2, "linear_units": 128, "num_blocks": 2}}))
    np.savez(lm_dir / "valid.loss.ave.params.npz", **numpy_from_lm_params(
        tlm.init_lm_params(torch.Generator().manual_seed(0), lcfg), lcfg))
    exp = tmp_path / "exp"
    out = train.main(["--config", os.path.join(CONF, "train_asr_conformer.yaml"),
                      "--train_dir", data, "--valid_dir", data, "--exp_dir", str(exp),
                      "--max_epoch", "1", "--batch_bins", "90000", "--device", "cpu",
                      "--override", *SMALL,
                      f"normalize_conf.stats_file={tmp_path / 'stats' / 'feats_stats.npz'}"])
    hist = out["history"][1]
    assert np.isfinite(hist["train"]["loss"]) and hist["train"]["loss_ctc"] > 0
    assert {"loss", "loss_att", "loss_ctc", "acc", "cer", "wer"} <= set(hist["valid"])
    with np.load(out["ave"]) as ave, np.load(tmp_path / "stats" / "feats_stats.npz") as st:
        np.testing.assert_array_equal(ave["mvn/mean"], st["mean"])
        assert ave["encoder/blocks/attn/q/w"].shape == (2, 128, 128)
        assert ave["ctc/w"].shape == (128, 51865)
    common = ["--config", str(exp / "config.yaml"), "--params", out["ave"], "--data_dir", data,
              "--decode_config", os.path.join(CONF, "decode_asr.yaml"), "--lm_exp",
              str(lm_dir), "--beam_size", "2", "--max_steps", "3", "--compute_dtype",
              "float32"]
    jax_decode.main(common + ["--output_dir", str(tmp_path / "jax")])
    res = decode.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert set(res["hyps"]) == set(TEXTS)
    hyp = read_trn(str(tmp_path / "torch" / "hyp.trn"))
    assert hyp == read_trn(str(tmp_path / "jax" / "hyp.trn"))
