"""The port's int8 cross-KV (`cross_kv_int8`, JAX `--cross_kv_int8`) against
agacs_tpu on the CPU: `quantize_kv` and `precompute_cross_kv`'s int8
buffers and scales bit for bit, the K3-int8 / K3a-int8 / K3s-int8 plain
versions against the Pallas kernels interpreted, and greedy, beam and the
decode CLI token-exact with JAX's.

JAX's CPU decode step reads the int8 buffers only on its kernel path: off
it (the default on a CPU) the cross-attention reads the unquantised
head-split k/v (`whisper.py:1330-1337`) and `cross_kv_int8` changes
nothing. So every JAX side here runs with AGACS_DECODE_KERNEL=pallas (the
kernels interpreted), and the port's CPU path runs its int8 plain
versions, which compute what its kernels compute on the card.

Tolerances: quantisation bit for bit; the attention's plain versions
within 1e-5 x max |JAX| (both round q·s_k and p to bf16 the same way, so
what remains is float32 summation order); JAX's dequantising oracle 1e-6;
tokens exact, beam scores 1e-5 relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.beam import beam_decode as jax_beam
from agacs_tpu.decode.greedy import greedy_decode as jax_greedy
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops import decode_attn as jda
from agacs_tpu_torch.decode.beam import beam_decode
from agacs_tpu_torch.decode.greedy import greedy_decode
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.ops import decode_attn

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=40, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=2, adapter=True, cross_kv_int8=True)
H = 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture
def kernel_path(monkeypatch):
    """JAX's decode step on its (interpreted) Pallas kernel path, freshly
    traced."""
    monkeypatch.setenv("AGACS_DECODE_KERNEL", "pallas")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("shape", [(2, 32, 64), (3, 64, 128), (1, 768, 64)])
def test_quantize_kv_matches_jax(shape):
    """One scale per channel over the batch and every time row, a zero
    channel floored at 1e-8, round half to even."""
    rng = np.random.RandomState(shape[1])
    x = (rng.randn(*shape) * rng.rand(shape[-1]) * 3).astype(np.float32)
    x[..., 1] = 0.0
    x[0, 0, 2] = 2.5 * x[..., 2].max() / 127  # exact halves round to even
    q, s = jw._quantize_kv(jnp.asarray(x))
    tq, ts = tw.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


def _int8_caches(rng, n, tp, d):
    k = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    v = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    (k8, ks), (v8, vs) = jw._quantize_kv(jnp.asarray(k)), jw._quantize_kv(jnp.asarray(v))
    return [np.asarray(a) for a in (k8, ks, v8, vs)]


@pytest.mark.parametrize("kind, pos", [("rows", 0), ("rows", 13), ("rows", 31),
                                       ("anc", 9), ("anc", 31), ("shared", 0),
                                       ("shared", 31)])
def test_int8_decode_attention_plain_matches_jax_kernel(kind, pos):
    """K3-int8 (rows), K3a-int8 (ancestry, beam 4) and K3s-int8 (shared,
    beam 4) plain versions against the Pallas kernels interpreted, float32
    queries."""
    rng = np.random.RandomState(pos + len(kind))
    n, tp, d, j = 8, 32, 64, 4
    groups = n // j if kind == "shared" else n
    q = (rng.randn(n, d) * 0.3).astype(np.float32)
    k8, ks, v8, vs = _int8_caches(rng, groups, tp, d)
    if kind == "shared":
        ref = jda.decode_shared_cache_attention(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), pos, H, j,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
        out = decode_attn.decode_shared_cache_attention(
            _t(q), _t(k8), _t(v8), pos, H, j, k_scale=_t(ks), v_scale=_t(vs))
    else:
        anc = rng.randint(0, j, (n, tp)).astype(np.int32) if kind == "anc" else None
        ref = jda.decode_cache_attention(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), pos, H,
            anc_local=None if anc is None else jnp.asarray(anc), beam=j,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
        out = decode_attn.decode_cache_attention(
            _t(q), _t(k8), _t(v8), pos, H, anc_local=None if anc is None else _t(anc),
            beam=j, k_scale=_t(ks), v_scale=_t(vs))
    ref = np.asarray(ref)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shared", [False, True])
def test_dequantising_oracle_matches_jax(shared):
    """JAX's oracle form (int8 caches dequantised to q's dtype, then the
    plain attention) against JAX's `*_ref` with scales."""
    rng = np.random.RandomState(3)
    q = (rng.randn(8, 64) * 0.3).astype(np.float32)
    k8, ks, v8, vs = _int8_caches(rng, 2 if shared else 8, 32, 64)
    if shared:
        ref = jda.decode_shared_cache_attention_ref(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), 20, H, 4,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        out = decode_attn.decode_shared_cache_attention_ref(
            _t(q), _t(k8), _t(v8), 20, H, 4, k_scale=_t(ks), v_scale=_t(vs))
    else:
        ref = jda.decode_cache_attention_ref(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), 20, H,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        out = decode_attn.decode_cache_attention_ref(
            _t(q), _t(k8), _t(v8), 20, H, k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """JAX params and the port's model (cross_kv_int8) on the same weights,
    the cross-attention key/value weights and biases multiples of 1/16 with
    small numerators, so that their products with integer features are
    exact in float32 on both sides."""
    jcfg = jw.WhisperConfig(**DIMS)
    params = jw.init_whisper_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.RandomState(4)
    cross = params["decoder"]["blocks"]["cross_attn"]
    for name in ("key", "value"):
        lin = dict(cross[name])
        lin["w"] = jnp.asarray(rng.randint(-4, 5, lin["w"].shape) / 16.0, jnp.float32)
        if "b" in lin:
            lin["b"] = jnp.asarray(rng.randint(-4, 5, lin["b"].shape) / 16.0, jnp.float32)
        cross[name] = lin
    tcfg = tw.WhisperConfig(**DIMS)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    return params, jcfg, model


def test_precompute_cross_kv_int8_matches_jax_bit_for_bit(pair):
    """750 -> 768-style padding to TIME_ALIGN_I8 (here 40 -> 64), int8
    buffers and per-layer scales identical to JAX's."""
    params, jcfg, model = pair
    feats = np.random.RandomState(5).randint(-3, 4, (3, 40, 64)).astype(np.float32)
    ref = jw.precompute_cross_kv(params, jcfg, jnp.asarray(feats))
    with torch.no_grad():
        out = tw.precompute_cross_kv(model, torch.from_numpy(feats))
    assert out["t_audio"] == 40
    for key in ("k_packed", "v_packed", "k_scale", "v_scale"):
        assert len(out[key]) == len(ref[key]) == 2
        for a, b in zip(out[key], ref[key]):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a.numpy(), b, err_msg=key)
    assert out["k_packed"][0].shape == (3, 64, 64)
    assert out["k_packed"][0].dtype == torch.int8


def test_int8_greedy_token_exact_with_jax_kernel_path(pair, kernel_path):
    """Greedy tokens exact; beside them the first step's logits, within
    1e-5 of JAX's and further than that from the unquantised cross-KV's
    (so the int8 buffers are what both sides read)."""
    params, jcfg, model = pair
    enc = np.random.RandomState(6).randn(2, 40, 64).astype(np.float32)
    first = np.array([50258, 50258], np.int32)
    ref = jw.whisper_decode_step(
        params, jcfg, jnp.asarray(first), jnp.int32(0), jw.init_self_kv_cache(jcfg, 2, 16),
        jw.precompute_cross_kv(params, jcfg, jnp.asarray(enc)))[0]
    plain_model = tw.Whisper.from_state_dict(
        tw.WhisperConfig(**{**DIMS, "cross_kv_int8": False}), model.state_dict())
    logits = []
    with torch.no_grad():
        for m in (model, plain_model):
            kv = tw.precompute_cross_kv(m, torch.from_numpy(enc))
            logits.append(tw.whisper_decode_step(
                m, torch.from_numpy(first).long(), 0, tw.init_self_kv_cache(m.cfg, 2, 16),
                kv)[0].numpy())
    np.testing.assert_allclose(logits[0], np.asarray(ref), atol=1e-5)
    assert np.abs(logits[1] - np.asarray(ref)).max() > 1e-4
    ref_tok, ref_len = jax_greedy(params, jcfg, jnp.asarray(enc), max_steps=8)
    tok, lens = greedy_decode(model, torch.from_numpy(enc), max_steps=8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))


def test_int8_beam_matches_jax_kernel_path(pair, kernel_path):
    """Beam 3 (K3s-int8 for the cross-attention on the card): tokens and
    lengths exact, scores within 1e-5, ancestry map and physical gather."""
    params, jcfg, model = pair
    enc = np.random.RandomState(7).randn(2, 40, 64).astype(np.float32)
    ref = jax_beam(params, jcfg, jnp.asarray(enc), beam_size=3, max_steps=6,
                   length_bonus=0.1)
    for ancestry in (True, False):
        tok, lens, scores = beam_decode(model, torch.from_numpy(enc), beam_size=3,
                                        max_steps=6, length_bonus=0.1, ancestry=ancestry)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref[2]), rtol=1e-5)


def test_decode_cli_cross_kv_int8_matches_jax_cli(tmp_path, kernel_path):
    """bin.decode --cross_kv_int8 against agacs_tpu.bin.decode
    --cross_kv_int8 (its kernel path) on the same checkpoint and data dir."""
    import yaml

    from agacs_tpu.bin import decode as jax_cli
    from agacs_tpu.data.io import write_scp, write_wav
    from agacs_tpu.eval.scoring import read_trn
    from agacs_tpu.models.asr_model import init_asr_params
    from agacs_tpu.train.checkpoint import save_pytree
    from agacs_tpu.utils.config import model_config_from_dict as jax_model_config
    from agacs_tpu_torch.bin import decode as cli

    conf = {"encoder": "whisper",
            "encoder_conf": {"whisper_model": "test", "adapter": True},
            "decoder_conf": {"whisper_model": "test", "adapter": True}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(conf))
    params = init_asr_params(jax.random.PRNGKey(8),
                             jax_model_config(conf, compute_dtype=jnp.float32))
    save_pytree(str(tmp_path / "p.params.npz"), params)
    rng = np.random.RandomState(9)
    wavs = {}
    for u, n in {"u1": 20000, "u2": 9000}.items():
        wavs[u] = str(tmp_path / f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(str(tmp_path / "wav.scp"), wavs)
    write_scp(str(tmp_path / "text"), {"u1": "hello 你好", "u2": "world"})
    common = ["--config", str(tmp_path / "config.yaml"),
              "--params", str(tmp_path / "p.params.npz"), "--data_dir", str(tmp_path),
              "--compute_dtype", "float32", "--max_steps", "6", "--cross_kv_int8"]
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    res = cli.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert set(res["hyps"]) == {"u1", "u2"}
    assert (read_trn(str(tmp_path / "torch" / "hyp.trn"))
            == read_trn(str(tmp_path / "jax" / "hyp.trn")))


@pytest.mark.cuda
def test_int8_kernels_match_plain_on_card():
    """K3-int8, K3s-int8 and K3a-int8 against their plain versions on the
    card, with chip_smoke.py's inputs and bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    chip_smoke.check_k3i8(torch.device("cuda"), torch.Generator().manual_seed(0),
                          timed=False)
