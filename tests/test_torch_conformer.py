"""The port's conformer serving modules (agacs_tpu_torch) against agacs_tpu
on the CPU: the DefaultFrontend with global MVN, K5's plain version
against the Pallas kernel interpreted, the rel-pos attention in both of
its paths, the encoder (layer and batch conv norms), the transformer
decoder (teacher-forced and cached step), the transformer LM (forward and
cached step, JAX on its Pallas kernel and on XLA), CTC prefix scoring, and
the weight converters both ways. Inputs are made with numpy from a seed
and JAX-initialized weights are handed to both packages.

Tolerances, each with its reason:
  * frontend + global MVN 1e-5 x max |ref|: float32 DFT and mel products
    summed in another order;
  * K5's plain version vs `_fwd_pallas` interpreted: float32 inputs 1e-5
    x max |ref| (summation order), bf16 inputs 1e-2 (both round p to bf16,
    at different places: the Pallas kernel after its own f32 products);
  * the rel-pos attention in bf16 (K5's path; JAX's kernel interpreted)
    1e-2 x max |ref|: the bf16 projections and output round on each side;
    in float32 (the einsum path on both) 1e-5;
  * the encoder, the decoder (forward and step) and the LM (forward and
    step), float32: 1e-5 x max |ref| (float32 summation order through the
    layers);
  * CTC prefix scores 1e-5 absolute (log-add-exp of float32 sums of a few
    dozen log-probs, |values| < 100).
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode import ctc_prefix as jctc
from agacs_tpu.models import conformer as jconf
from agacs_tpu.models import conformer_asr as jasr
from agacs_tpu.models import lm as jlm
from agacs_tpu.ops import frontend_default as jfe
from agacs_tpu.ops import relpos_flash as jrf
from agacs_tpu.train.checkpoint import load_pytree_like, save_pytree
from agacs_tpu.utils.config import task_from_dict as jax_task_from_dict
from agacs_tpu_torch.decode import ctc_prefix
from agacs_tpu_torch.models import conformer as tconf
from agacs_tpu_torch.models import lm as tlm
from agacs_tpu_torch.models.checkpoint import (
    conformer_params_from_numpy,
    lm_params_from_numpy,
    numpy_from_conformer_params,
    numpy_from_lm_params,
)
from agacs_tpu_torch.models.conformer_asr import ConformerASR, encode
from agacs_tpu_torch.ops import frontend_default as tfe
from agacs_tpu_torch.ops import relpos_flash
from agacs_tpu_torch.utils.config import task_from_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2 blocks, d 128, 2 heads (d_head 64: K5's envelope holds), a small
# vocabulary with sos/eos inside it
RAW = {
    "encoder": "conformer",
    "encoder_conf": {"output_size": 128, "attention_heads": 2, "linear_units": 256,
                     "num_blocks": 2, "cnn_module_kernel": 15, "unroll_layers": True},
    "decoder": "transformer",
    "decoder_conf": {"attention_heads": 2, "linear_units": 256, "num_blocks": 2},
    "normalize": "global_mvn",
    "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
}
V, SOS, EOS = 300, 298, 299
LM_CONF = dict(vocab_size=300, d_model=128, attention_heads=2, linear_units=256,
               num_blocks=2, sos=SOS, eos=EOS)
# 3 s and 2.5 s: 93 and 77 encoder frames
LENS = np.array([48000, 40000])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, rtol, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    bound = rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref|"


def _cfgs(conv_norm="layer", dtype="float32"):
    raw = {**RAW, "encoder_conf": {**RAW["encoder_conf"], "conv_norm": conv_norm}}
    jcfg = jax_task_from_dict(raw, compute_dtype=getattr(jnp, dtype)).cfg
    tcfg = task_from_dict(raw, compute_dtype=getattr(torch, dtype)).cfg
    return tuple(dataclasses.replace(c, decoder=dataclasses.replace(c.decoder, vocab_size=V),
                                     sos=SOS, eos=EOS) for c in (jcfg, tcfg))


def _params(jcfg, seed=0):
    """JAX params as numpy, with non-trivial MVN and batch-norm statistics."""
    tree = jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 1)
    tree["mvn"] = {"mean": rng.randn(80).astype(np.float32),
                   "std": (0.5 + rng.rand(80)).astype(np.float32)}
    conv = tree["encoder"]["blocks"]["conv"]
    if "running_mean" in conv:
        conv["running_mean"] = rng.randn(*conv["running_mean"].shape).astype(np.float32) * 0.1
        conv["running_var"] = (0.5 + rng.rand(*conv["running_var"].shape)).astype(np.float32)
    return tree


def _audio(seed=0):
    rng = np.random.RandomState(seed)
    audio = (rng.randn(2, int(LENS.max())) * 0.1).astype(np.float32)
    audio[1, LENS[1]:] = 0.0
    return audio


def _model(tree, tcfg):
    return ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg))


@pytest.fixture(scope="module")
def f32():
    jcfg, tcfg = _cfgs()
    tree = _params(jcfg)
    return jcfg, tcfg, tree, _model(tree, tcfg)


def test_frontend_and_global_mvn_match_jax():
    audio = _audio()
    cfg = jfe.DefaultFrontendConfig(normalize=None)
    ref, ref_lens = jfe.default_frontend(jnp.asarray(audio), jnp.asarray(LENS), cfg)
    out, lens = tfe.default_frontend(torch.from_numpy(audio), torch.from_numpy(LENS),
                                     tfe.DefaultFrontendConfig(normalize=None))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert out.shape == (2, 48000 // 128 + 1, 80)
    _close(out, ref, 1e-5, "frontend")
    rng = np.random.RandomState(3)
    mean, std = rng.randn(80).astype(np.float32), (0.5 + rng.rand(80)).astype(np.float32)
    _close(tfe.global_mvn(out, lens, torch.from_numpy(mean), torch.from_numpy(std)),
           jfe.global_mvn(ref, ref_lens, jnp.asarray(mean), jnp.asarray(std)), 1e-5,
           "global_mvn")
    _close(tfe.utterance_mvn(out, lens), jfe.utterance_mvn(ref, ref_lens), 1e-5,
           "utterance_mvn")
    ref_u, _ = jfe.default_frontend(jnp.asarray(audio), jnp.asarray(LENS))
    out_u, _ = tfe.default_frontend(torch.from_numpy(audio), torch.from_numpy(LENS))
    _close(out_u, ref_u, 1e-5, "default_frontend with utterance_mvn")


def _k5_inputs(t, dtype, seed=0):
    rng = np.random.RandomState(seed)
    d = 128
    qu, qv, k, v = (rng.randn(2, t, d).astype(np.float32) * 0.5 for _ in range(4))
    pe = rng.randn(2 * t - 1, d).astype(np.float32) * 0.5
    lens = np.array([t, t - 20])
    mask = np.where(np.arange(t)[None, :] < lens[:, None], 0.0, jrf.NEG_MASK).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(x, jd) for x in (qu, qv, k, v)] + [jrf.pad_pe(jnp.asarray(pe, jd), t),
                                                        jnp.asarray(mask)]
    tt = [torch.from_numpy(x).to(td) for x in (qu, qv, k, v)] + [
        relpos_flash.pad_pe(torch.from_numpy(pe).to(td), t), torch.from_numpy(mask)]
    return j, tt


@pytest.mark.parametrize("t", [64, 67, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_pallas_interpreted(t, dtype):
    """T 67 and 130: (T-1) % 8 != 0 (the Mosaic roll's offset c0); the second
    utterance's last 20 keys masked."""
    j, tt = _k5_inputs(t, dtype)
    ref = jrf._fwd_pallas(*j, 2, True)
    out = relpos_flash.relpos_mha(*tt, 2)
    assert out.dtype == tt[0].dtype
    _close(out, ref, 1e-2 if dtype == "bfloat16" else 1e-5, f"K5 plain T={t} {dtype}")


def test_k5_envelope_is_jax_supports(monkeypatch):
    monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret")
    for t, d, h, dt in [(64, 128, 2, "bfloat16"), (63, 128, 2, "bfloat16"),
                        (640, 256, 4, "bfloat16"), (641, 256, 4, "bfloat16"),
                        (468, 256, 4, "float32"), (468, 192, 4, "bfloat16"),
                        (100, 128, 32, "bfloat16"), (100, 256, 8, "bfloat16")]:
        assert relpos_flash.supports(t, d, h, getattr(torch, dt)) == \
            jrf.supports(t, d, h, getattr(jnp, dt)), (t, d, h, dt)


def _attn_inputs(tcfg, dtype, t=93):
    rng = np.random.RandomState(5)
    x = rng.randn(2, t, 128).astype(np.float32)
    valid = np.arange(t)[None, :] < np.array([t, t - 16])[:, None]
    pos = jconf.rel_positional_encoding(t, 128)
    return x, valid, pos


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rel_attn_matches_jax(dtype, monkeypatch):
    """bf16: K5's path (the plain version here) against JAX's kernel
    interpreted; float32: the einsum path on both sides."""
    monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret" if dtype == "bfloat16" else "0")
    jcfg, tcfg = _cfgs(dtype=dtype)
    tree = _params(jcfg)
    model = _model(tree, tcfg)
    x, valid, pos = _attn_inputs(tcfg, dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["encoder"]["blocks"]["attn"])
    ref = jconf._rel_attn(p0, jnp.asarray(x, jd), jnp.asarray(pos, jd), jnp.asarray(valid), 2)
    calls = []
    real = relpos_flash.relpos_mha
    relpos_flash.relpos_mha = lambda *a: calls.append(1) or real(*a)
    try:
        with torch.no_grad():
            out = model.encoder.blocks[0].attn(torch.from_numpy(x).to(td),
                                               torch.from_numpy(pos).to(td),
                                               torch.from_numpy(valid))
    finally:
        relpos_flash.relpos_mha = real
    assert len(calls) == (dtype == "bfloat16")
    _close(out, ref, 1e-2 if dtype == "bfloat16" else 1e-5, f"_rel_attn {dtype}")


@pytest.mark.parametrize("conv_norm", ["layer", "batch"])
def test_encoder_matches_jax(conv_norm):
    jcfg, tcfg = _cfgs(conv_norm)
    tree = _params(jcfg)
    model = _model(tree, tcfg)
    audio = _audio()
    ref, ref_lens = jasr.encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(audio),
                                jnp.asarray(LENS))
    with torch.no_grad():
        out, lens = encode(model, torch.from_numpy(audio), torch.from_numpy(LENS))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert out.shape == (2, 93, 128) and tuple(lens.tolist()) == (93, 77)
    _close(out, ref, 1e-5, f"encoder conv_norm={conv_norm}")


def test_decoder_forward_and_step_match_jax(f32):
    jcfg, tcfg, tree, model = f32
    rng = np.random.RandomState(7)
    mem = rng.randn(2, 40, 128).astype(np.float32)
    mlens = np.array([40, 31])
    tokens = rng.randint(0, 300, (2, 9))
    tlens = np.array([9, 6])
    jdec = jax.tree.map(jnp.asarray, tree["decoder"])
    ref = jconf.transformer_decode(jdec, jcfg.decoder, jnp.asarray(tokens), jnp.asarray(mem),
                                   jnp.asarray(mlens), jnp.asarray(tlens))
    with torch.no_grad():
        out = tconf.transformer_decode(model.decoder, torch.from_numpy(tokens),
                                       torch.from_numpy(mem), torch.from_numpy(mlens),
                                       torch.from_numpy(tlens))
    _close(out, ref, 1e-5, "transformer_decode")

    jkv = jconf.init_decoder_kv_cache(jcfg.decoder, 2, 12)
    jcross = jconf.precompute_decoder_cross_kv(jdec, jcfg.decoder, jnp.asarray(mem))
    kv = tconf.init_decoder_kv_cache(tcfg.decoder, 2, 12)
    with torch.no_grad():
        cross = tconf.precompute_decoder_cross_kv(model.decoder, torch.from_numpy(mem))
        for pos in range(5):
            ref_l, jkv = jconf.transformer_decode_step(
                jdec, jcfg.decoder, jnp.asarray(tokens[:, pos]), jnp.int32(pos), jkv, jcross,
                jnp.asarray(mlens))
            out_l, kv = tconf.transformer_decode_step(
                model.decoder, torch.from_numpy(tokens[:, pos]), pos, kv, cross,
                torch.from_numpy(mlens))
            _close(out_l, ref_l, 1e-5, f"transformer_decode_step pos={pos}")
    _close(kv["k"][1], jkv["k"][1], 1e-5, "decoder self-attention cache")


@pytest.fixture(scope="module")
def lm_pair():
    jcfg = jlm.TransformerLMConfig(**LM_CONF)
    tcfg = tlm.TransformerLMConfig(**LM_CONF)
    tree = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(3), jcfg))
    lm = tlm.TransformerLM.from_state_dict(tcfg, lm_params_from_numpy(tree, tcfg))
    return jcfg, tcfg, tree, lm


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_lm_forward_and_cached_step_match_jax(kernel, lm_pair, monkeypatch):
    """The step against JAX on its Pallas kernel (interpreted, float32
    caches) and on its XLA path."""
    monkeypatch.setenv("AGACS_DECODE_KERNEL", kernel)
    jcfg, tcfg, tree, lm = lm_pair
    tokens = np.random.RandomState(8).randint(0, 300, (3, 7))
    jp = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        _close(tlm.lm_forward(lm, torch.from_numpy(tokens)),
               jlm.lm_forward(jp, jcfg, jnp.asarray(tokens)), 1e-5, "lm_forward")
        jkv = jlm.init_lm_kv_cache(jcfg, 3, 10)
        kv = tlm.init_lm_kv_cache(tcfg, 3, 10)
        assert kv["k"][0].dtype == torch.float32 and kv["k"][0].shape == (3, 16, 128)
        for pos in range(7):
            ref, jkv = jlm.lm_score_step_cached(jp, jcfg, jnp.asarray(tokens[:, pos]),
                                                jnp.int32(pos), jkv)
            out, kv = tlm.lm_score_step_cached(lm, torch.from_numpy(tokens[:, pos]), pos, kv)
            _close(out, ref, 1e-5, f"lm_score_step_cached pos={pos} ({kernel})")


def _ctc_case(seed=0, n=3, t=20, v=12):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, t, v).astype(np.float32) * 2
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return logp.astype(np.float32), np.array([t, 15, 9])


def test_ctc_prefix_scores_match_jax():
    """Two steps from the empty prefix (the second from selected,
    non-empty prefixes, one candidate equal to its prefix's last token),
    ragged frame lengths, and the eos score."""
    logp, lens = _ctc_case()
    c1 = np.array([[1, 2, 3, 4], [5, 1, 7, 0], [2, 2, 9, 11]])
    js = jctc.ctc_prefix_init(jnp.asarray(logp))
    ts = ctc_prefix.ctc_prefix_init(torch.from_numpy(logp))
    np.testing.assert_allclose(_np(ts.r_b), _np(js.r_b), atol=1e-5)
    for step, cands in enumerate((c1, np.array([[1, 3, 5, 6], [1, 1, 2, 3], [9, 8, 7, 2]]))):
        psi_r, ns_r = jctc.ctc_prefix_score(jnp.asarray(logp), js, jnp.asarray(cands),
                                           frame_lens=jnp.asarray(lens))
        psi, ns = ctc_prefix.ctc_prefix_score(torch.from_numpy(logp), ts,
                                              torch.from_numpy(cands),
                                              frame_lens=torch.from_numpy(lens))
        np.testing.assert_allclose(_np(psi), _np(psi_r), atol=1e-5, err_msg=f"psi {step}")
        np.testing.assert_allclose(_np(ns.r_nb), _np(ns_r.r_nb), atol=1e-5)
        np.testing.assert_allclose(_np(ns.r_b), _np(ns_r.r_b), atol=1e-5)
        idx = np.array([1, 3, 0])
        js = jctc.ctc_prefix_select(ns_r, jnp.asarray(idx))
        ts = ctc_prefix.ctc_prefix_select(ns, torch.from_numpy(idx))
        np.testing.assert_array_equal(ts.last.numpy(), np.asarray(js.last))
        np.testing.assert_allclose(_np(ctc_prefix.ctc_eos_score(ts, torch.from_numpy(lens))),
                                   _np(jctc.ctc_eos_score(js, jnp.asarray(lens))), atol=1e-5)
        np.testing.assert_allclose(_np(ctc_prefix.ctc_eos_score(ts)),
                                   _np(jctc.ctc_eos_score(js)), atol=1e-5)


def test_ctc_prefix_rows_share_frames():
    """`rows` reads each state row's frames from its utterance's logp row:
    the same scores as repeating logp per row (what JAX does)."""
    logp, _ = _ctc_case(seed=1, n=2)
    rows = np.array([0, 0, 1, 1, 1])
    cands = np.random.RandomState(2).randint(0, 12, (5, 4))
    lens = np.array([20, 20, 13, 13, 13])
    rep = jnp.asarray(logp[rows])
    psi_r, _ = jctc.ctc_prefix_score(rep, jctc.ctc_prefix_init(rep), jnp.asarray(cands),
                                     frame_lens=jnp.asarray(lens))
    s0 = ctc_prefix.ctc_prefix_init(torch.from_numpy(logp[rows]))
    psi, _ = ctc_prefix.ctc_prefix_score(torch.from_numpy(logp), s0, torch.from_numpy(cands),
                                         frame_lens=torch.from_numpy(lens),
                                         rows=torch.from_numpy(rows))
    np.testing.assert_allclose(_np(psi), _np(psi_r), atol=1e-5)


def test_converters_round_trip_exactly(f32, lm_pair, tmp_path):
    """JAX tree -> state dict -> the npz layout is the JAX tree, leaf for
    leaf; JAX's load_pytree_like reads the port's npz; and the port reads
    JAX's save_pytree npz to the same state dict."""
    jcfg, tcfg, tree, model = f32
    sd = conformer_params_from_numpy(tree, tcfg)
    flat = numpy_from_conformer_params(sd, tcfg)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
             for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert set(flat) == set(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)
    np.savez(tmp_path / "port.npz", **flat)
    back = load_pytree_like(str(tmp_path / "port.npz"), jax.tree.map(jnp.asarray, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    save_pytree(str(tmp_path / "jax.npz"), tree)
    sd2 = conformer_params_from_numpy(np.load(tmp_path / "jax.npz"), tcfg)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd) and set(sd) == set(sd2)
    assert sd["encoder.blocks.1.attn.qkv.weight"].shape == (384, 128)
    np.testing.assert_array_equal(sd["encoder.blocks.1.attn.qkv.weight"][128:256].numpy(),
                                  tree["encoder"]["blocks"]["attn"]["k"]["w"][1].T)
    jlcfg, tlcfg, ltree, _ = lm_pair
    lsd = lm_params_from_numpy(ltree, tlcfg)
    lflat = numpy_from_lm_params(lsd, tlcfg)
    ljflat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
              for kp, v in jax.tree_util.tree_flatten_with_path(ltree)[0]}
    assert set(lflat) == set(ljflat)
    for k in lflat:
        np.testing.assert_array_equal(lflat[k], ljflat[k], err_msg=k)


def test_config_resolves_like_jax():
    """The recipe's config gives JAX's values (unroll_layers accepted)."""
    from agacs_tpu_torch.utils.config import load_yaml

    raw = load_yaml(os.path.join(REPO, "recipes", "seame", "conf",
                                 "train_asr_conformer.yaml"))
    jt, tt = jax_task_from_dict(raw), task_from_dict(raw)
    assert tt.kind == jt.kind == "conformer"
    for f in dataclasses.fields(tt.cfg.encoder):
        if f.name != "compute_dtype":
            assert getattr(tt.cfg.encoder, f.name) == getattr(jt.cfg.encoder, f.name), f.name
    for part in ("decoder", "frontend", "specaug"):
        a, b = getattr(tt.cfg, part), getattr(jt.cfg, part)
        for f in dataclasses.fields(a):
            if f.name != "compute_dtype":
                assert getattr(a, f.name) == getattr(b, f.name), (part, f.name)
    for name in ("ctc_weight", "lsm_weight", "use_specaug", "mvn_stats_path", "sos", "eos",
                 "interctc_weight", "length_normalized_loss"):
        assert getattr(tt.cfg, name) == getattr(jt.cfg, name), name


@pytest.mark.cuda
def test_conformer_kernels_match_plain_on_card():
    """K5 and K3-f32 against their plain versions on the card, with
    chip_smoke.py's inputs (keys past each length poisoned) and bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    chip_smoke.check_k5(torch.device("cuda"), g, timed=False)
    chip_smoke.check_k3f32(torch.device("cuda"), g, timed=False)
