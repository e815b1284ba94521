"""The port's W8A16 thin-row matmul (kernel K6's plain version,
`agacs_tpu_torch/ops/int8_serve.py`) and its two serving paths against
agacs_tpu on the CPU: the int8 trunk under AGACS_W8A16 and a
serving-quantised model (`quantize_for_serving`: int8 trunk, int8 token
table and logits head). Inputs are made with numpy from a seed and handed
to both packages.

JAX's CPU backend takes K6 only under AGACS_W8A16=interpret (its Pallas
kernel interpreted), and its logits head runs the Pallas kernel whenever a
model carries one, so every JAX side that reaches K6 runs under that
value; the port then runs K6's plain version, which computes what the
kernel computes on the card.

Tolerances: K6's plain version against the interpreted kernel: the same
dequantised weight (bit for bit) and exact products, summed in another
order: 1e-5 x max |y| in float32; in bf16 the output's own rounding
(2^-9 relative) shows where the two sums straddle a rounding boundary:
1e-2 x max |y|, and the same for the VJP's dx. Quantisation bit for bit;
decoded tokens exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.beam import beam_decode as jax_beam
from agacs_tpu.decode.greedy import greedy_decode as jax_greedy
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops import int8_linear as ji8
from agacs_tpu.ops import int8_serve as jserve
from agacs_tpu.train.freeze import trainable_mask
from agacs_tpu.train.trainer import quantize_frozen_linears as jax_quantize
from agacs_tpu_torch.decode.beam import beam_decode
from agacs_tpu_torch.decode.greedy import greedy_decode
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import numpy_from_params, params_from_numpy
from agacs_tpu_torch.ops import int8_linear, int8_serve

from test_torch_train import RECIPE, _write_data_dir

torch.set_num_threads(1)

RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
DIMS = dict(n_mels=80, n_audio_ctx=40, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=2, adapter=True)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(out, ref, rtol, what):
    err = np.abs(out - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: {err} vs {rtol} x {np.abs(ref).max()}"


@pytest.fixture
def w8a16(monkeypatch):
    """AGACS_W8A16=interpret for both packages, JAX freshly traced."""
    monkeypatch.setenv("AGACS_W8A16", "interpret")
    jax.clear_caches()
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# K6's plain version and its VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1024, 768], ids=["tiled", "whole"])
@pytest.mark.parametrize("rows", [1, 5, 8, 32])
def test_w8a16_plain_matches_pallas_interpreted(rows, n, dtype):
    """K 256; N 1024 takes JAX's 512-column tiles, 768 one whole block;
    rows 1 and 5 are ragged against JAX's pad to 8."""
    rng = np.random.RandomState(rows + n)
    k = 256
    w_q, w_s = ji8.quantize_weight(jnp.asarray(rng.randn(k, n).astype(np.float32) / 16))
    x = jnp.asarray(rng.randn(rows, k).astype(np.float32), getattr(jnp, dtype))
    g = jnp.asarray(rng.randn(rows, n).astype(np.float32), getattr(jnp, dtype))
    y_ref, vjp = jax.vjp(lambda a: jserve.w8a16_matmul(a, w_q, w_s, True), x)
    (dx_ref,) = vjp(g)
    tq, ts = torch.from_numpy(np.asarray(w_q)), torch.from_numpy(np.asarray(w_s))
    xt = torch.from_numpy(_np(x)).to(getattr(torch, dtype)).requires_grad_()
    y = int8_serve.w8a16_matmul(xt, tq, ts)
    y.backward(torch.from_numpy(_np(g)).to(y.dtype))
    assert y.dtype == xt.dtype and y.shape == (rows, n) and xt.grad.dtype == xt.dtype
    _close(y.detach().float().numpy(), _np(y_ref), RTOL[dtype], f"K6 y {dtype}")
    _close(xt.grad.float().numpy(), _np(dx_ref), RTOL[dtype], f"K6 dx {dtype}")
    np.testing.assert_array_equal(
        int8_serve.dequant_bf(tq, ts, torch.bfloat16).float().numpy(),
        _np((w_q.astype(jnp.float32) * w_s[None, :]).astype(jnp.bfloat16)))


@pytest.mark.parametrize("env, rows, want", [
    ("interpret", 32, "K6"), ("interpret", 33, "K8"), ("1", 8, "K8"), ("0", 8, "K8"),
    ("", 8, "K8")])
def test_dispatch_follows_jax(monkeypatch, env, rows, want):
    """`int8_linear` on a CPU tensor: K6's plain version only under
    "interpret" (JAX's CPU backend answers False to any other value) and
    for at most MAX_ROWS rows; `fits` is JAX's shape rule."""
    monkeypatch.setenv("AGACS_W8A16", env)
    w_q = torch.zeros(64, 96, dtype=torch.int8)
    calls = []
    real = int8_serve.w8a16_matmul
    monkeypatch.setattr(int8_serve, "w8a16_matmul", lambda *a: calls.append(1) or real(*a))
    y = int8_linear.int8_linear(torch.randn(rows, 64), w_q, torch.ones(96))
    assert y.shape == (rows, 96) and bool(calls) == (want == "K6")
    assert int8_serve.thin_rows(torch.zeros(1, rows, 64)) == (want == "K6")
    for shape in ((768, 52224), (768, 3072), (3072, 768), (4096, 3000)):
        w = jnp.zeros(shape, jnp.int8)
        assert int8_serve.fits(torch.zeros(shape, dtype=torch.int8)) == jserve.fits(w)


def test_splits_cover_the_card():
    """K6's grid (`thin_tiling`): a block for each of the H100's 132 SMs at
    every decode-step shape (and every block the rule can make where K
    has fewer stages), K split into whole 64-row stages over at most 8
    blocks of a cluster with none empty, no split for the logits head."""
    for m, k, n in ((8, 768, 768), (8, 768, 3072), (8, 3072, 768), (8, 768, 52224),
                    (40, 768, 52224), (1, 256, 1024)):
        bn, s = int8_serve.thin_tiling(m, n, k, int8_serve.K6_KR)
        chunks = -(-k // int8_serve.K6_KR)
        assert 1 <= s <= min(chunks, int8_serve.MAX_SPLITS)
        assert (s - 1) * -(-chunks // s) < chunks  # no empty rank
        tiles = -(-n // bn) * -(-m // int8_serve.THIN_MR)
        assert tiles * s >= min(132, -(-n // 32) * min(chunks, int8_serve.MAX_SPLITS))
    assert int8_serve.thin_tiling(8, 52224, 768, int8_serve.K6_KR) == (128, 1)


# ---------------------------------------------------------------------------
# quantize_for_serving
# ---------------------------------------------------------------------------


def _serving_pair(seed=0):
    jcfg, tcfg = jw.WhisperConfig(**DIMS), tw.WhisperConfig(**DIMS)
    params = jw.init_whisper_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, tcfg


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_quantize_for_serving_bit_identical_to_jax():
    """Every trunk linear's codes and scales, the token table's and the
    logits head's, bit for bit; the adapters, layer norms and the float
    token table untouched; logits_w_q[:, :V] == token_emb_q^T with zero
    padding to 52224 columns."""
    jcfg, params, tcfg = _serving_pair()
    ref = _flat(jserve.quantize_for_serving(params))
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    int8_serve.quantize_for_serving(model)
    out = numpy_from_params(model.state_dict())
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert out[k].dtype == (np.int8 if k.endswith("_q") else np.float32), k
        np.testing.assert_array_equal(out[k], v.astype(out[k].dtype), err_msg=k)
    q, s = out["decoder/token_emb_q"], out["decoder/token_emb_s"]
    assert out["decoder/logits_w_q"].shape == (64, 52224) and q.shape == (51865, 64)
    np.testing.assert_array_equal(out["decoder/logits_w_q"][:, :51865], q.T)
    assert not out["decoder/logits_w_q"][:, 51865:].any()
    np.testing.assert_array_equal(out["decoder/logits_w_s"][:51865], s)
    assert sum(k.endswith("/w_q") for k in out) == 6 + 10  # stacked over layers
    assert isinstance(model.encoder.blocks[0].adapter_mlp.model[0], tw.Linear)


def test_serving_npz_both_ways(tmp_path):
    """The port's serving-quantised state dict -> the flat npz that JAX's
    `load_pytree_like` reads into quantize_for_serving's tree, and JAX's
    npz -> the same state dict."""
    from agacs_tpu.train.checkpoint import load_pytree_like, save_pytree

    jcfg, params, tcfg = _serving_pair(1)
    qtree = jserve.quantize_for_serving(params)
    save_pytree(str(tmp_path / "jax.params.npz"), qtree)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(np.load(str(tmp_path / "jax.params.npz")), tcfg))
    assert model.decoder.logits_w_q.dtype == torch.int8
    path = str(tmp_path / "port.params.npz")
    np.savez(path, **numpy_from_params(model.state_dict()))
    loaded = load_pytree_like(path, qtree)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(qtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# decoding on the two paths
# ---------------------------------------------------------------------------


def _int8_trunk(seed=0):
    """JAX's int8 trunk (adapter preset) and the port's model from it."""
    jcfg, params, tcfg = _serving_pair(seed)
    qparams = jax_quantize(params, trainable_mask(params, "adapter"))
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, qparams), tcfg))
    return jcfg, qparams, model


def _serving_quantised(seed=0):
    """JAX's quantize_for_serving tree and the port's model from it."""
    jcfg, params, tcfg = _serving_pair(seed)
    qtree = jserve.quantize_for_serving(params)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, qtree), tcfg))
    return jcfg, qtree, model


@pytest.mark.parametrize("which", ["int8_trunk", "serving_quantised"])
def test_greedy_and_beam_match_jax(which, w8a16, monkeypatch):
    """Greedy (8 steps) and beam 3 (6 steps, both cache modes): tokens and
    lengths exact, beam scores within 1e-5; the first step's logits within
    1e-5 x max. Every decode-step product has 2 or 6 rows, so each takes
    K6's plain version (the serving-quantised model's logits head too)."""
    jcfg, params, model = (_int8_trunk if which == "int8_trunk" else _serving_quantised)(2)
    calls = []
    real = int8_serve.w8a16_matmul_ref
    monkeypatch.setattr(int8_serve, "w8a16_matmul_ref",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    enc = np.random.RandomState(3).randn(2, 40, 64).astype(np.float32)
    first = np.array([50258, 50258], np.int32)
    ref = jw.whisper_decode_step(
        params, jcfg, jnp.asarray(first), jnp.int32(0), jw.init_self_kv_cache(jcfg, 2, 16),
        jw.precompute_cross_kv(params, jcfg, jnp.asarray(enc)))[0]
    with torch.no_grad():
        logits = tw.whisper_decode_step(
            model, torch.from_numpy(first).long(), 0, tw.init_self_kv_cache(model.cfg, 2, 16),
            tw.precompute_cross_kv(model, torch.from_numpy(enc)))[0]
    _close(logits.numpy(), np.asarray(ref), 1e-5, f"{which} first-step logits")
    per_step = 8 * 2 + (which == "serving_quantised")
    assert len(calls) == per_step
    if which == "serving_quantised":
        assert calls[-1] == (64, 52224) and logits.shape == (2, 51865)
    ref_tok, ref_len = jax_greedy(params, jcfg, jnp.asarray(enc), max_steps=8)
    tok, lens = greedy_decode(model, torch.from_numpy(enc), max_steps=8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
    ref = jax_beam(params, jcfg, jnp.asarray(enc), beam_size=3, max_steps=6,
                   length_bonus=0.1)
    for ancestry in (True, False):
        tok, lens, scores = beam_decode(model, torch.from_numpy(enc), beam_size=3,
                                        max_steps=6, length_bonus=0.1, ancestry=ancestry)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref[2]), rtol=1e-5)


def test_int8_head_runs_without_the_variable(monkeypatch):
    """A serving-quantised model's logits head takes K6 (its plain version
    on a CPU tensor) whatever AGACS_W8A16 says, the trunk then K8; the
    embedding reads the int8 table."""
    monkeypatch.delenv("AGACS_W8A16", raising=False)
    _, _, model = _serving_quantised(4)
    calls = []
    real = int8_serve.w8a16_matmul_ref
    monkeypatch.setattr(int8_serve, "w8a16_matmul_ref",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    tokens = torch.tensor([50258, 1000])
    with torch.no_grad():
        enc = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(0))
        logits, _ = tw.whisper_decode_step(model, tokens, 0,
                                           tw.init_self_kv_cache(model.cfg, 2, 16),
                                           tw.precompute_cross_kv(model, enc))
        emb = model.decoder.embed(tokens, 0, int8_head=True)
    assert calls == [(64, 52224)] and logits.shape == (2, 51865)
    dec = model.decoder
    want = dec.token_emb_q[tokens].float() * dec.token_emb_s[tokens][:, None] \
        + dec.positional_embedding[0]
    torch.testing.assert_close(emb, want, rtol=0, atol=0)
    assert not torch.equal(emb, model.decoder.embed(tokens, 0))


def test_int8_train_cli_then_w8a16_decode_cli_matches_jax_cli(tmp_path, w8a16, monkeypatch):
    """bin.train --override freeze_quant=int8 (whisper `test` dims, CPU,
    float32), then bin.decode under AGACS_W8A16=interpret against JAX's
    decode CLI under the same variable: token-exact hypotheses, and every
    decode-step product of the port on K6's plain version."""
    from agacs_tpu.bin import decode as jax_cli
    from agacs_tpu.eval.scoring import read_trn
    from agacs_tpu_torch.bin import decode, train

    _write_data_dir(tmp_path / "train", {f"t{i}": (8000 + 1000 * i, "我们 go")
                                         for i in range(4)}, seed=0)
    _write_data_dir(tmp_path / "valid", {"v0": (9000, "hello 你好"), "v1": (7000, "ok")},
                    seed=1)
    exp = tmp_path / "exp"
    monkeypatch.delenv("AGACS_W8A16")
    out = train.main([
        "--config", RECIPE, "--train_dir", str(tmp_path / "train"),
        "--valid_dir", str(tmp_path / "valid"), "--exp_dir", str(exp),
        "--max_epoch", "1", "--batch_bins", "40000", "--compute_dtype", "float32",
        "--device", "cpu", "--override", "encoder_conf.whisper_model=test",
        "decoder_conf.whisper_model=test", "freeze_quant=int8", "keep_nbest_models=1"])
    monkeypatch.setenv("AGACS_W8A16", "interpret")
    calls = []
    real = int8_serve.w8a16_matmul_ref
    monkeypatch.setattr(int8_serve, "w8a16_matmul_ref",
                        lambda *a: calls.append(1) or real(*a))
    common = ["--config", str(exp / "config.yaml"), "--params", out["ave"],
              "--data_dir", str(tmp_path / "valid"), "--compute_dtype", "float32",
              "--max_steps", "6"]
    res = decode.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    assert set(res["hyps"]) == {"v0", "v1"} and len(calls) >= 8 * 2 * 10
    assert (read_trn(str(tmp_path / "torch" / "hyp.trn"))
            == read_trn(str(tmp_path / "jax" / "hyp.trn")))


# ---------------------------------------------------------------------------
# the kernel, on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_w8a16_kernel_matches_plain_on_card():
    """K6 against its plain version on the card, with chip_smoke.py's
    shapes and bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    chip_smoke.check_k6(torch.device("cuda"), torch.Generator().manual_seed(0), timed=False)
