"""The port's transducer searches against agacs_tpu's on the CPU: greedy
(the while form, both frame rules, and the frame-loop form), the default
beam with and without LM fusion, the batched TSD and ALSD beams, NSC and
mAES, token for token with scores within 1e-4; then `bin.train` on
train_asr_transducer.yaml scaled down for one epoch, whose n-best average
both packages' `bin.decode` decode with every `--transducer_search` to
identical hyp.trn files; and `bin.lm_calc_perplexity` against JAX's CLI.
JAX-initialised weights and numpy-seeded encoder outputs go to both.

Tolerances: scores 1e-4 absolute (float32 sums of ~30 log-probs of ~-4,
each within a few ulp of JAX's); the perplexity report 1e-5 relative
(float32 token means, summed in another order).
"""

import dataclasses
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.bin import decode as jax_decode
from agacs_tpu.bin import lm_calc_perplexity as jax_ppl
from agacs_tpu.data.io import write_scp, write_wav
from agacs_tpu.decode import transducer_nsc as jnsc
from agacs_tpu.decode import transducer_tsd as jtsd
from agacs_tpu.models import lm as jlm
from agacs_tpu.models import transducer as jtr
from agacs_tpu.models.transducer_asr import TransducerASRConfig as JASRConfig
from agacs_tpu_torch.bin import decode, lm_calc_perplexity, train
from agacs_tpu_torch.decode import transducer_nsc, transducer_tsd
from agacs_tpu_torch.eval.scoring import read_trn
from agacs_tpu_torch.models import lm as tlm
from agacs_tpu_torch.models import transducer as ttr
from agacs_tpu_torch.models.checkpoint import (
    lm_params_from_numpy,
    numpy_from_lm_params,
    transducer_params_from_numpy,
)
from agacs_tpu_torch.models.transducer_asr import TransducerASRConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "recipes", "seame", "conf")
V, D, T = 40, 24, 14
ENC_LENS = np.array([14, 10])
SCORE_ATOL = 1e-4


def _setup(rnn="lstm", seed=0, blank_bias=0.4):
    """(JAX cfg, JAX params, port Transducer, enc (2, T, D), lens): LSTM or
    GRU 2 x 32, joint 48, V 40, a blank bias that makes blanks and symbols
    both likely."""
    jcfg = jtr.TransducerConfig(vocab_size=V, rnn_type=rnn, num_layers=2, hidden_size=32,
                                joint_space_size=48)
    params = jax.tree.map(lambda a: np.array(a), jtr.init_transducer_params(
        jax.random.PRNGKey(seed), jcfg, encoder_size=D))
    params["joint"]["lin_out"]["b"][0] = blank_bias
    tcfg = ttr.TransducerConfig(**dataclasses.asdict(jcfg))
    acfg = TransducerASRConfig(decoder=tcfg, encoder=dataclasses.replace(
        TransducerASRConfig().encoder, output_size=D))
    sd = transducer_params_from_numpy({"transducer": params}, acfg, strict=False)
    model = ttr.Transducer(tcfg, D)
    model.load_state_dict({k[len("transducer."):]: v for k, v in sd.items()})
    enc = np.random.RandomState(seed + 7).randn(2, T, D).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, params), model, enc, ENC_LENS


@pytest.mark.parametrize("form", ["while", "while_advance", "scan"])
@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_greedy_matches_jax(form, rnn):
    jcfg, params, model, enc, lens = _setup(rnn)
    je, jl = jnp.asarray(enc), jnp.asarray(lens)
    te, tl = torch.tensor(enc), torch.tensor(lens)
    if form == "scan":
        want = jtr.greedy_search_scan(params, jcfg, je, jl, max_symbols=20)
        got = ttr.greedy_search_scan(model, te, tl, max_symbols=20)
    else:
        adv = form == "while_advance"
        want = jtr.greedy_search(params, jcfg, je, jl, max_symbols=20, advance_on_emit=adv)
        got = ttr.greedy_search(model, te, tl, max_symbols=20, advance_on_emit=adv)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0 < int(got[1].min()) and int(got[1].max()) <= 20


def test_greedy_scan_caps_symbols_like_jax():
    """A cap of 3 symbols, reached: the rows stop emitting where JAX's do."""
    jcfg, params, model, enc, lens = _setup(blank_bias=-1.0)
    want = jtr.greedy_search_scan(params, jcfg, jnp.asarray(enc), jnp.asarray(lens),
                                  max_symbols=3)
    got = ttr.greedy_search_scan(model, torch.tensor(enc), torch.tensor(lens), max_symbols=3)
    assert got[1].tolist() == [3, 3]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def _lm_pair(seed=9):
    jcfg = jlm.TransformerLMConfig(vocab_size=V, d_model=16, attention_heads=2,
                                   linear_units=32, num_blocks=1, compute_dtype=jnp.float32,
                                   sos=V - 1, eos=V - 1)
    tree = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(seed), jcfg))
    tcfg = tlm.TransformerLMConfig(vocab_size=V, d_model=16, attention_heads=2,
                                   linear_units=32, num_blocks=1, compute_dtype=torch.float32,
                                   sos=V - 1, eos=V - 1)
    lm = tlm.TransformerLM.from_state_dict(tcfg, lm_params_from_numpy(tree, tcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), lm


def _same_nbest(got, want):
    assert [toks for _, toks in got] == [list(toks) for _, toks in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], atol=SCORE_ATOL)


@pytest.mark.parametrize("lm_weight", [0.0, 0.3])
def test_default_beam_matches_jax(lm_weight):
    """The reference's default beam (beam 3) on each utterance, without and
    with LM shallow fusion: the n-best lists token for token."""
    jcfg, params, model, enc, lens = _setup()
    ljcfg, lparams, lm = _lm_pair()
    for k in range(2):
        e = enc[k, :lens[k]]
        want = jtr.default_beam_search(params, jcfg, e, beam_size=3, lm_params=lparams,
                                       lm_cfg=ljcfg, lm_weight=lm_weight, lm_sos=V - 1)
        got = ttr.default_beam_search(model, torch.tensor(e), beam_size=3, lm=lm,
                                      lm_weight=lm_weight, lm_sos=V - 1)
        _same_nbest(got, want)
        assert len(got) == 3 and any(toks for _, toks in got)


def _live(tokens, n, scores):
    """Per utterance the (tokens, score) of the live hypotheses."""
    out = []
    for tk, nk, sk in zip(np.asarray(tokens), np.asarray(n), np.asarray(scores)):
        out.append([(tk[i, :nk[i]].tolist(), float(sk[i])) for i in range(len(sk))
                    if sk[i] > jtsd.NEG_INF / 2])
    return out


@pytest.mark.parametrize("search", ["tsd", "alsd"])
@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_batched_beams_match_jax(search, rnn):
    """TSD (beam 3, 3 symbol expansions) and ALSD (beam 3, u_max 8) over a
    batch of 2 with different lengths: the live hypotheses of each
    utterance token for token, best first, and their scores."""
    jcfg, params, model, enc, lens = _setup(rnn)
    je, jl = jnp.asarray(enc), jnp.asarray(lens)
    te, tl = torch.tensor(enc), torch.tensor(lens)
    if search == "tsd":
        want = jtsd.tsd_beam_search(params, jcfg, je, jl, beam=3, max_sym_exp=3)
        got = transducer_tsd.tsd_beam_search(model, te, tl, beam=3, max_sym_exp=3)
    else:
        want = jtsd.alsd_beam_search(params, jcfg, je, jl, beam=3, u_max=8)
        got = transducer_tsd.alsd_beam_search(model, te, tl, beam=3, u_max=8)
    assert got[0].shape == tuple(np.asarray(want[0]).shape)
    g, w = _live(*got), _live(*want)
    for gk, wk in zip(g, w):
        assert [t for t, _ in gk] == [t for t, _ in wk]
        np.testing.assert_allclose([s for _, s in gk], [s for _, s in wk], atol=SCORE_ATOL)
        assert gk and any(t for t, _ in gk)


@pytest.mark.parametrize("search,kw", [("nsc", {}), ("nsc", {"nstep": 2}),
                                       ("maes", {}), ("maes", {"expansion_gamma": 1.0})],
                         ids=str)
def test_nsc_maes_match_jax(search, kw):
    """NSC (nstep 1 and 2) and mAES (gamma 2.3 and 1.0) at beam 3 on each
    utterance: the n-best lists token for token."""
    jcfg, params, model, enc, lens = _setup()
    jfn = {"nsc": jnsc.nsc_beam_search, "maes": jnsc.maes_beam_search}[search]
    tfn = {"nsc": transducer_nsc.nsc_beam_search, "maes": transducer_nsc.maes_beam_search}[search]
    for k in range(2):
        e = enc[k, :lens[k]]
        _same_nbest(tfn(model, torch.tensor(e), beam_size=3, **kw),
                    jfn(params, jcfg, e, beam_size=3, **kw))


# ------------------------------------------------------------- the CLIs

TEXTS = {"u1": "hello 你好", "u2": "world 世界", "u3": "我们 go", "u4": "好 ok lah"}
LENS = {"u1": 28000, "u2": 24000, "u3": 30000, "u4": 26000}
SMALL = ["encoder_conf.output_size=64", "encoder_conf.attention_heads=2",
         "encoder_conf.linear_units=128", "encoder_conf.num_blocks=2",
         "decoder_conf.hidden_size=32", "joint_net_conf.joint_space_size=48",
         "keep_nbest_models=1"]
LM_CONF = {"d_model": 32, "attention_heads": 2, "linear_units": 64, "num_blocks": 1}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A data dir, one epoch of `bin.train` on the transducer recipe scaled
    down (its ctc_weight 0.3, SpecAug, dropout 0.1, Adam, accum_grad 2) and
    an LM exp dir of the port's init."""
    root = tmp_path_factory.mktemp("transducer_cli")
    rng = np.random.RandomState(4)
    data = root / "data"
    data.mkdir()
    wavs = {}
    for u, n in LENS.items():
        wavs[u] = str(data / f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(str(data / "wav.scp"), wavs)
    write_scp(str(data / "text"), TEXTS)
    exp = root / "exp"
    out = train.main(["--config", os.path.join(CONF, "train_asr_transducer.yaml"),
                      "--train_dir", str(data), "--valid_dir", str(data), "--exp_dir",
                      str(exp), "--max_epoch", "1", "--batch_bins", "60000", "--device",
                      "cpu", "--compute_dtype", "float32", "--override", *SMALL])
    # the average with lin_out's bias raised on the blank and on 5 ids, so
    # that every search emits symbols and blanks (one epoch leaves the
    # joint near uniform over 51865 ids, where the beams keep the empty
    # hypothesis)
    biased = str(root / "biased.params.npz")
    with np.load(out["ave"]) as ave:
        tree = dict(ave)
    bias = tree["transducer/joint/lin_out/b"].copy()
    bias[0] += 8.0
    bias[np.random.RandomState(5).choice(np.arange(1, 50000), 5, replace=False)] += 8.5
    tree["transducer/joint/lin_out/b"] = bias
    np.savez(biased, **tree)
    lm_dir = root / "lm"
    lm_dir.mkdir()
    lcfg = tlm.TransformerLMConfig(**LM_CONF)
    (lm_dir / "config.yaml").write_text(yaml.safe_dump({"lm_conf": LM_CONF}))
    np.savez(lm_dir / "valid.loss.ave.params.npz", **numpy_from_lm_params(
        tlm.init_lm_params(torch.Generator().manual_seed(0), lcfg), lcfg))
    return {"root": root, "data": str(data), "exp": exp, "out": out, "lm": str(lm_dir),
            "biased": biased}


def test_train_cli_epoch(trained):
    """The epoch's losses and the eval's greedy CER/WER; the average holds
    JAX's transducer tree."""
    hist = trained["out"]["history"][1]
    assert np.isfinite(hist["train"]["loss"]) and hist["train"]["loss_ctc"] > 0
    assert {"loss", "loss_transducer", "loss_ctc", "cer", "wer"} <= set(hist["valid"])
    with np.load(trained["out"]["ave"]) as ave:
        assert ave["transducer/layers/w_ih"].shape == (1, 32, 128)
        assert ave["transducer/joint/lin_out/w"].shape == (48, 51865)
        assert ave["ctc/w"].shape == (64, 51865)
    cfg = yaml.safe_load((trained["exp"] / "config.yaml").read_text())
    assert cfg["decoder"] == "transducer"


@pytest.mark.parametrize("search", ["greedy", "default", "default_lm", "tsd", "alsd", "nsc",
                                    "maes"])
def test_decode_cli_matches_jax(trained, search):
    """Both packages' `bin.decode` on the trained average with its output
    bias raised, float32: greedy (`--beam_size 1`) and every
    `--transducer_search` at beam 2 (the default beam also with the LM of an
    exp dir at lm_weight 0.3), the same hyp.trn, symbols emitted by all but
    the default beam."""
    root = trained["root"]
    args = ["--config", str(trained["exp"] / "config.yaml"), "--params", trained["biased"],
            "--data_dir", trained["data"], "--compute_dtype", "float32"]
    if search == "greedy":
        args += ["--beam_size", "1"]
    else:
        args += ["--beam_size", "2", "--transducer_search", search.split("_")[0],
                 "--transducer_u_max", "12"]
    if search == "default_lm":
        args += ["--lm_exp", trained["lm"], "--lm_weight", "0.3"]
    jax_decode.main(args + ["--output_dir", str(root / f"jax_{search}")])
    res = decode.main(args + ["--output_dir", str(root / f"torch_{search}"), "--device", "cpu"])
    assert set(res["hyps"]) == set(TEXTS)
    got = read_trn(str(root / f"torch_{search}" / "hyp.trn"))
    assert got == read_trn(str(root / f"jax_{search}" / "hyp.trn"))
    # the default beam keeps the empty hypothesis here: with a joint that
    # hardly depends on the decoder state, a symbol and a blank always cost
    # more than the blank alone (its search is held token for token on a
    # model where symbols win, test_default_beam_matches_jax)
    assert search.startswith("default") or all(got.values()), got
    assert read_trn(str(root / f"torch_{search}" / "ref.trn")) == read_trn(
        str(root / f"jax_{search}" / "ref.trn"))


def test_decode_cli_ignores_lm_with_a_warning(trained, caplog):
    """--lm_exp with greedy decoding, and with the TSD search, is ignored
    with JAX's warning."""
    base = ["--config", str(trained["exp"] / "config.yaml"), "--params",
            trained["biased"], "--data_dir", trained["data"], "--compute_dtype", "float32",
            "--device", "cpu", "--lm_exp", trained["lm"]]
    root = trained["root"]
    greedy = decode.main(base + ["--output_dir", str(root / "lm_greedy")])
    assert "no effect with greedy decoding" in caplog.text
    plain = read_trn(str(root / "torch_greedy" / "hyp.trn")) if (
        root / "torch_greedy").exists() else None
    assert plain is None or read_trn(str(root / "lm_greedy" / "hyp.trn")) == plain
    assert set(greedy["hyps"]) == set(TEXTS)
    decode.main(base + ["--beam_size", "2", "--transducer_search", "tsd", "--output_dir",
                        str(root / "lm_tsd")])
    assert "not supported by the tsd search" in caplog.text


def test_lm_calc_perplexity_matches_jax(trained):
    data_text = os.path.join(trained["data"], "text")
    args = ["--lm_exp", trained["lm"], "--text", data_text, "--batch_tokens", "16"]
    want = jax_ppl.main(args)
    got = lm_calc_perplexity.main(args + ["--device", "cpu", "--output",
                                          str(trained["root"] / "ppl.json")])
    assert got["n_tokens"] == want["n_tokens"] and got["n_batches"] == want["n_batches"]
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)
    np.testing.assert_allclose(got["nll_per_token"], want["nll_per_token"], rtol=1e-5)
    assert (trained["root"] / "ppl.json").exists()


def test_jax_config_defaults_agree():
    """The port's TransducerASRConfig defaults are JAX's."""
    j, t = JASRConfig(), TransducerASRConfig()
    for f in ("ctc_weight", "fastemit_lambda", "use_specaug", "ignore_id", "joint_chunk_t",
              "mvn_stats_path"):
        assert getattr(j, f) == getattr(t, f), f
    assert dataclasses.asdict(j.decoder) == dataclasses.asdict(t.decoder)
