"""The port's int8 frozen trunk (agacs_tpu_torch) against agacs_tpu on the
CPU: quantisation, the W8A8 linear (K8's plain version) and the fused MLP
(K2's plain versions) against the JAX functions and the Pallas kernels
interpreted, the quantised encoder and decoder, a training trajectory, the
npz both ways and the train -> decode CLIs. Inputs are made with numpy
from a seed and handed to both packages.

Tolerances, each with its reason:
  * quantisation (weights, rows) is bit-identical: the same float32
    division and round-half-even;
  * `int8_matmul` forward and dgrad are bit-identical: exact int32 sums,
    then the same float32 products in the same order and one cast;
  * K2's plain versions vs the Pallas kernels: the same operations, but
    XLA's and PyTorch's exp differ in the last bit, which moves a row's
    hidden max (so its scale) by an ulp and a hidden value across a
    quantisation boundary now and then (one int8 step of one hidden
    value moves its whole output row): 2e-3 x max |ref| in float32 (read
    7.9e-4 forward, 1.5e-7 backward); in bf16 the outputs' own rounding
    turns such moves into one-ulp flips (2^-8 to 2^-7 of the largest
    value): 1e-2 (read 5.8e-3 and 6.3e-3, on 2% of the elements);
  * the quantised encoder: the dense path already differs from JAX by
    float32 summation order (~1e-7, the conv stem and the attention), and
    each int8 projection row-quantises its input, so a value that sits on
    a rounding boundary moves by a whole int8 step: 5e-3 x max |ref| (read
    1.6e-3, the same with both sides unfused); the decoder logits 1e-3
    (read 6.6e-7);
  * the 3-step trajectory: step 0 within 1e-5 relative (read: loss 0,
    loss_cs 1.4e-7, grad norm 2.5e-6: the fused q/k/v dgrad, as JAX's);
    after the first update the float32 adapters differ from JAX's by
    ~1e-7 (AdamW's rounding order) and the int8 rounding flips that this
    moves grow with each step: loss 1e-4, loss_cs 5e-3, grad norm 1e-3
    (read at step 2: 4.4e-5, 2.3e-3, 2.1e-4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops import int8_linear as ji8
from agacs_tpu.ops import int8_mlp as jmlp
from agacs_tpu.text import WhisperTokenizer
from agacs_tpu.train.checkpoint import load_pytree_like, save_pytree
from agacs_tpu.train.freeze import trainable_mask
from agacs_tpu.train.optim import OptimConfig as JOptimConfig
from agacs_tpu.train.trainer import build_tx, create_train_state
from agacs_tpu.train.trainer import make_train_step as jax_make_train_step
from agacs_tpu.train.trainer import quantize_frozen_linears as jax_quantize
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import numpy_from_params, params_from_numpy
from agacs_tpu_torch.ops import int8_linear, int8_mlp
from agacs_tpu_torch.train.checkpoint import CheckpointManager
from agacs_tpu_torch.train.freeze import apply_freeze
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import dequantize_params, make_train_step

from test_torch_train import (  # pytest puts tests/ (no __init__.py) on sys.path
    RECIPE,
    _batch,
    _cfgs,
    _torch_batch,
    _write_data_dir,
)

torch.set_num_threads(1)

K2_RTOL = {"float32": 2e-3, "bfloat16": 1e-2}
ENC_RTOL, LOGITS_RTOL = 5e-3, 1e-3
TRAJ_RTOL = [dict(loss=1e-5, loss_cs=1e-5, grad_norm=1e-5)] + [
    dict(loss=1e-4, loss_cs=5e-3, grad_norm=1e-3)] * 2


@pytest.fixture(scope="module")
def tok():
    return WhisperTokenizer()


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _qparams(rng, d_in, d_out, bias=True):
    w = rng.randn(d_in, d_out).astype(np.float32) / np.sqrt(d_in)
    q, s = ji8.quantize_weight(jnp.asarray(w))
    p = {"w_q": q, "w_s": s}
    if bias:
        p["b"] = jnp.asarray(rng.randn(d_out).astype(np.float32) * 0.1)
    return p


def _t(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


# ---------------------------------------------------------------------------
# quantisation and the W8A8 linear (K8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(96, 48), (3, 64, 32)], ids=["2d", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_identical_to_jax(shape, dtype):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w[..., 3, :] = 0.0  # a zero row
    if len(shape) == 2:
        w[:, 5] = 0.0   # a zero channel: scale 1e-12 / 127
    jw_ = jnp.asarray(w, getattr(jnp, dtype))
    q_ref, s_ref = ji8.quantize_weight(jw_)
    q, s = int8_linear.quantize_weight(torch.from_numpy(_np(jw_)).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(int8_linear.dequantize_weight(q, s).numpy(),
                                  np.asarray(ji8.dequantize_weight(q_ref, s_ref)))


@pytest.mark.parametrize("rows", [1, 8, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_and_dgrad_match_jax(rows, dtype):
    rng = np.random.RandomState(rows)
    p = _qparams(rng, 128, 96)
    x = jnp.asarray(rng.randn(rows, 128).astype(np.float32), getattr(jnp, dtype))
    g = jnp.asarray(rng.randn(rows, 96).astype(np.float32), getattr(jnp, dtype))
    y_ref, vjp = jax.vjp(lambda a: ji8.int8_matmul(a, p["w_q"], p["w_s"]), x)
    (dx_ref,) = vjp(g)
    tp = _t(p)
    xt = torch.from_numpy(_np(x)).to(getattr(torch, dtype)).requires_grad_()
    y = int8_linear.int8_matmul(xt, tp["w_q"], tp["w_s"])
    y.backward(torch.from_numpy(_np(g)).to(y.dtype))
    assert y.dtype == xt.dtype and xt.grad.dtype == xt.dtype
    np.testing.assert_array_equal(y.detach().float().numpy(), _np(y_ref))
    np.testing.assert_array_equal(xt.grad.float().numpy(), _np(dx_ref))
    yb = int8_linear.int8_linear(xt.detach(), tp["w_q"], tp["w_s"], tp["b"])
    np.testing.assert_array_equal(
        yb.float().numpy(), _np(jw.linear(x, p)))


def test_int8_matmul_skips_dgrad_without_input_grad():
    """No dgrad runs for an input that needs none, and a 3-D x keeps its shape."""
    rng = np.random.RandomState(0)
    tp = _t(_qparams(rng, 64, 32))
    x = torch.randn(2, 5, 64)
    w = torch.randn(64, requires_grad=True)
    y = int8_linear.int8_matmul(x, tp["w_q"], tp["w_s"])
    assert y.shape == (2, 5, 32) and not y.requires_grad
    calls = []
    real = int8_linear._dgrad
    int8_linear._dgrad = lambda *a: calls.append(1) or real(*a)
    try:
        (int8_linear.int8_matmul(x * w, tp["w_q"], tp["w_s"]).sum()).backward()
        assert len(calls) == 1 and w.grad is not None
        y = int8_linear.Int8Matmul.apply(x.reshape(-1, 64), tp["w_q"], tp["w_s"])
        assert not y.requires_grad and len(calls) == 1
    finally:
        int8_linear._dgrad = real


# ---------------------------------------------------------------------------
# the fused MLP (K2)
# ---------------------------------------------------------------------------


def _mlp_inputs(dtype, n=300, d=256, h=1024, seed=0):
    rng = np.random.RandomState(seed)
    p1, p2 = _qparams(rng, d, h), _qparams(rng, h, d)
    x = jnp.asarray(rng.randn(n, d).astype(np.float32), getattr(jnp, dtype))
    dy = jnp.asarray(rng.randn(n, d).astype(np.float32), getattr(jnp, dtype))
    return p1, p2, x, dy


def _targs(p1, p2):
    t1, t2 = _t(p1), _t(p2)
    return t1["w_q"], t1["w_s"], t1["b"], t2["w_q"], t2["w_s"], t2["b"]


def _close(out, ref, rtol, what):
    err = np.abs(out - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: {err} vs {rtol} x {np.abs(ref).max()}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_int8_mlp_plain_matches_pallas_interpreted(which, dtype):
    """n = 300 is ragged against the forward's 256-row and the backward's
    128-row blocks."""
    p1, p2, x, dy = _mlp_inputs(dtype)
    w1q, s1, b1, w2q, s2, b2 = _targs(p1, p2)
    xt = torch.from_numpy(_np(x)).to(getattr(torch, dtype))
    if which == "fwd":
        ref = jmlp._fwd_pallas(x, p1, p2, interpret=True)
        out = int8_mlp.int8_mlp_fwd_ref(xt, w1q, s1, b1, w2q, s2, b2)
    else:
        ref = jmlp._bwd_pallas(x, p1, p2, dy, interpret=True)
        dyt = torch.from_numpy(_np(dy)).to(xt.dtype)
        out = int8_mlp.int8_mlp_bwd_ref(xt, w1q, s1, b1, w2q, s2, dyt)
    assert out.dtype == xt.dtype and out.shape == (300, 256)
    _close(out.float().numpy(), _np(ref), K2_RTOL[dtype], f"K2 {which} {dtype}")


def test_unfused_composition_matches_jax_ref():
    """`unfused` (int8_linear . exact GELU . int8_linear, what the model runs
    below 256 rows) against JAX's `_ref`, in float32: the GELUs (PyTorch's
    and XLA's erf) differ in the last bit, which can move a hidden value
    across a rounding boundary: K2_RTOL."""
    p1, p2, x, _ = _mlp_inputs("float32", n=40)
    ref = jmlp._ref(x, p1, p2)
    out = int8_mlp.unfused(torch.from_numpy(_np(x)), *_targs(p1, p2))
    _close(out.numpy(), _np(ref), K2_RTOL["float32"], "unfused int8 MLP")


@pytest.mark.parametrize("d, h", [(384, 1536), (512, 2048), (768, 3072), (1024, 4096),
                                  (1280, 5120), (256, 1024), (1024, 2048), (96, 384)])
def test_fused_mlp_shape_rule_is_jax_budget(d, h, monkeypatch):
    """`supports` decides as JAX's does (its backend switch set to fuse):
    d, h multiples of 128 within the 13 MiB budget. whisper-medium and
    -large fall outside it."""
    monkeypatch.setenv("AGACS_INT8_MLP", "interpret")
    assert int8_mlp.supports(d, h) == jmlp.supports(d, h)
    assert int8_mlp.supports(d, h) == (d % 128 == 0 and h % 128 == 0 and d * h < 3e6)


def test_mlp_outside_the_budget_is_unfused_like_jax():
    """whisper-medium's MLP (d 1024, h 4096) on 256 rows, float32: JAX's
    `mlp_fwd` runs it unfused (outside the budget), so must the port. The
    port's output is `unfused`'s, bit for bit, and it is within
    1e-5 x max |y| of JAX's on every row whose int8 hidden codes agree
    with JAX's. XLA's and PyTorch's erf differ in the last bit on about half
    of all values, which now and then moves a hidden value across an int8
    rounding boundary; such a row moves by one int8 step of one hidden
    value (read: 1 row of 256, 4.3e-4 x max |y|), still within K2_RTOL."""
    rng = np.random.RandomState(0)
    d, h, n = 1024, 4096, 256
    p = {"fc1": _qparams(rng, d, h), "fc2": _qparams(rng, h, d)}
    x = rng.randn(n, d).astype(np.float32)
    ref = _np(jw.mlp_fwd(p, jnp.asarray(x)[None]))[0]
    mlp = tw.MLP(tw.Int8Linear(d, h), torch.nn.GELU(), tw.Int8Linear(h, d))
    for lin, name in ((mlp[0], "fc1"), (mlp[2], "fc2")):
        tp = _t(p[name])
        lin.weight_q, lin.weight_s = tp["w_q"], tp["w_s"]
        lin.bias = torch.nn.Parameter(tp["b"], requires_grad=False)
    with torch.no_grad():
        out = mlp(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(out, int8_mlp.unfused(torch.from_numpy(x),
                                                            *_targs(p["fc1"], p["fc2"])).numpy())
        hid = torch.nn.functional.gelu(int8_linear.int8_linear(
            torch.from_numpy(x), mlp[0].weight_q, mlp[0].weight_s, mlp[0].bias))
        codes = int8_linear.row_quant_ref(hid)[0].numpy()
    codes_ref = np.asarray(ji8._row_quant_xla(jw.gelu(jw.linear(jnp.asarray(x), p["fc1"])))[0])
    same = (codes == codes_ref).all(1)
    err = np.abs(out - ref).max(1)
    bound = np.abs(ref).max()
    assert same.sum() >= n - 2
    assert (err[same] <= 1e-5 * bound).all(), err[same].max() / bound
    assert err.max() <= K2_RTOL["float32"] * bound


def test_gradients_through_both_functions_use_the_plain_backward():
    p1, p2, x, dy = _mlp_inputs("float32", n=40, d=128, h=256, seed=1)
    args = _targs(p1, p2)
    xt = torch.from_numpy(_np(x)).requires_grad_()
    dyt = torch.from_numpy(_np(dy))
    y = int8_mlp.int8_mlp(xt.reshape(2, 20, 128), *args)
    assert y.shape == (2, 20, 128)
    torch.testing.assert_close(y.reshape(40, 128).detach(),
                               int8_mlp.int8_mlp_fwd_ref(xt.detach(), *args),
                               rtol=0, atol=0)
    y.reshape(40, 128).backward(dyt)
    torch.testing.assert_close(
        xt.grad, int8_mlp.int8_mlp_bwd_ref(xt.detach(), *args[:5], dyt), rtol=0, atol=0)
    xt.grad = None
    w_q, w_s = args[0], args[1]
    y = int8_linear.Int8Matmul.apply(xt, w_q, w_s)
    y.backward(torch.ones_like(y))
    torch.testing.assert_close(
        xt.grad, int8_linear.int8_matmul_dgrad_ref(torch.ones_like(y), w_q, w_s,
                                                   torch.float32), rtol=0, atol=0)


@pytest.mark.parametrize("which", ["fc1", "fc2"])
def test_int8_mlp_raises_on_a_trainable_bias(which):
    p1, p2, x, _ = _mlp_inputs("float32", n=16, d=128, h=256)
    args = list(_targs(p1, p2))
    args[2 if which == "fc1" else 5].requires_grad_()
    with pytest.raises(ValueError, match=which):
        int8_mlp.int8_mlp(torch.from_numpy(_np(x)), *args)


# ---------------------------------------------------------------------------
# the quantised model
# ---------------------------------------------------------------------------

D128 = dict(n_mels=80, n_audio_ctx=150, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=128,
            n_text_head=2, n_text_layer=2, adapter=True)


def _int8_pair(dims, preset="adapter", seed=0):
    """JAX params with the frozen linears quantised, and the port's model
    loaded from them (through the npz converter)."""
    jcfg = jw.WhisperConfig(**dims)
    params = jw.init_whisper_params(jax.random.PRNGKey(seed), jcfg)
    qparams = jax_quantize(params, trainable_mask(params, preset))
    tcfg = tw.WhisperConfig(**dims)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, qparams), tcfg))
    return jcfg, qparams, tcfg, model


def test_quantize_frozen_matches_jax_quantize_frozen_linears():
    """The port quantising its own frozen (bf16-stored) linears gives JAX's
    int8 leaves, scales and biases exactly, and the same state-dict names."""
    dims = dict(D128, n_audio_ctx=16)
    jcfg = jw.WhisperConfig(**dims)
    params = jw.init_whisper_params(jax.random.PRNGKey(3), jcfg)
    mask = trainable_mask(params, "adapter")
    from agacs_tpu.train.trainer import cast_frozen_params

    ref = jax_quantize(cast_frozen_params(params, mask), mask)
    tcfg = tw.WhisperConfig(**dims)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg),
        param_dtype=torch.float32)
    apply_freeze(model, "adapter")
    model.cast_frozen_(torch.bfloat16).quantize_frozen_()
    out = numpy_from_params(model.state_dict())
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert set(out) == set(flat)
    quant = {k[: -len("w_q")] for k in flat if k.endswith("/w_q")}
    for k, v in flat.items():
        if k[: k.rindex("/") + 1] not in quant:
            continue  # JAX's cast_frozen_params also casts LNs and embeddings
        assert out[k].dtype == (np.int8 if k.endswith("/w_q") else np.float32), k
        np.testing.assert_array_equal(out[k], v.astype(out[k].dtype), err_msg=k)
    assert sum(k.endswith("/w_q") for k in out) == 4 + 8 + 4  # enc qkvo+mlp, dec
    assert isinstance(model.encoder.blocks[0].mlp[0], tw.Int8Linear)
    assert isinstance(model.encoder.blocks[0].adapter_mlp.model[0], tw.Linear)


def test_fused_projection_follows_a_load_in_place():
    """The concatenated q/k/v weights `fused_linears` keeps are rebuilt when
    a state-dict load writes the int8 buffers in place."""
    cfg = tw.make_config("test", adapter=True)
    model = tw.Whisper.from_state_dict(
        cfg, tw.init_whisper_params(torch.Generator().manual_seed(0), cfg))
    apply_freeze(model, "adapter")
    model.quantize_frozen_()
    x = torch.randn(1, 20, 64, generator=torch.Generator().manual_seed(1))
    attn = model.encoder.blocks[0].attn
    with torch.no_grad():
        before = attn(x)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        sd["encoder.blocks.0.attn.query.weight_q"].fill_(1)
        model.load_state_dict(sd)
        after = attn(x)
        q_fused, q_alone = attn._project(x)[0], attn.query(x)
    assert not torch.equal(before, after)
    torch.testing.assert_close(q_fused, q_alone, rtol=0, atol=0)


def test_int8_encoder_and_decoder_match_jax(monkeypatch):
    """d = 128 so that JAX's `supports` holds: 2 x 150 = 300 encoder rows
    take K2 (JAX interpreting the Pallas kernel, the port its plain
    version), 2 x 9 = 18 decoder rows the unfused int8 linears."""
    monkeypatch.setenv("AGACS_INT8_MLP", "interpret")
    jcfg, qparams, _, model = _int8_pair(D128)
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 300, 80).astype(np.float32)
    calls = []
    real = int8_mlp.int8_mlp
    monkeypatch.setattr(int8_mlp, "int8_mlp", lambda *a: calls.append(a[0].shape) or real(*a))
    ref = jw.whisper_encode(qparams, jcfg, jnp.asarray(mel))
    with torch.no_grad():
        out = tw.whisper_encode(model, torch.from_numpy(mel))
    assert calls == [(2, 150, 128)] * 2
    _close(out.numpy(), _np(ref), ENC_RTOL, "int8 encoder")
    tokens = np.concatenate([np.full((2, 1), 50258), rng.randint(0, 51865, (2, 8))], 1)
    enc = rng.randn(2, 150, 128).astype(np.float32)
    ref, _ = jw.whisper_decode(qparams, jcfg, jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(enc))
    with torch.no_grad():
        out, _ = tw.whisper_decode(model, torch.from_numpy(tokens), torch.from_numpy(enc))
    assert len(calls) == 2  # 18 decoder rows: unfused
    _close(out.numpy(), _np(ref), LOGITS_RTOL, "int8 decoder logits")


def test_int8_trajectory_matches_jax(tok):
    """3 adapter steps of accum 2 with the int8 trunk (CS loss, clip 1.0,
    WarmupLR 4), set up as test_torch_train's trajectory test; JAX quantises
    after build_tx and rebuilds it, as its train CLI does."""
    jcfg, tcfg = _cfgs(cs_weight=0.5)
    params = jasr.init_asr_params(jax.random.PRNGKey(7), jcfg)
    _, mask = build_tx(params, JOptimConfig(warmup_steps=4), freeze_preset="adapter")
    qparams = jax_quantize(params, mask)
    tx, mask = build_tx(qparams, JOptimConfig(warmup_steps=4), freeze_preset="adapter")
    jstep = jax_make_train_step(jcfg, tx, accum_grad=2, trainable_mask=mask, donate=False)
    state = create_train_state(qparams, tx, jax.random.PRNGKey(1))

    model = tw.Whisper.from_state_dict(
        tcfg.whisper, params_from_numpy(jax.tree.map(np.asarray, params), tcfg.whisper))
    trainable = apply_freeze(model, "adapter")
    model.quantize_frozen_()
    opt, sched = build_optimizer(trainable, OptimConfig(warmup_steps=4))
    step = make_train_step(model, tcfg, opt, sched, grad_clip=1.0)
    frozen = {n: t.clone() for n, t in model.state_dict().items()
              if "adapter" not in n}
    for i in range(3):
        micro = [_batch(tok, seed=2 * i + a) for a in range(2)]
        stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]}
        state, ref = jstep(state, stacked)
        stats = step([_torch_batch(m) for m in micro])
        for k, rtol in TRAJ_RTOL[i].items():
            np.testing.assert_allclose(float(stats[k]), float(ref[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    for n, t in model.state_dict().items():
        if n in frozen:
            assert torch.equal(t, frozen[n]), n
    assert model.state_dict()["encoder.blocks.0.attn.query.weight_q"].dtype == torch.int8


# ---------------------------------------------------------------------------
# checkpoints and the CLIs
# ---------------------------------------------------------------------------


def test_int8_npz_both_ways_and_average(tmp_path):
    jcfg, qparams, tcfg, model = _int8_pair(dict(D128, n_audio_ctx=16))
    flat = numpy_from_params(model.state_dict())
    assert flat["encoder/blocks/mlp/fc1/w_q"].dtype == np.int8
    assert flat["encoder/blocks/mlp/fc1/w_q"].shape == (2, 128, 512)
    path = str(tmp_path / "port.params.npz")
    np.savez(path, **flat)
    loaded = load_pytree_like(path, qparams)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(qparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    save_pytree(str(tmp_path / "jax.params.npz"), qparams)
    back = params_from_numpy(np.load(str(tmp_path / "jax.params.npz")), tcfg)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == (torch.int8 if k.endswith("weight_q") else torch.float32)
        torch.testing.assert_close(back[k], sd[k].to(back[k].dtype), rtol=0, atol=0)
    dense = dequantize_params(sd)
    assert "encoder.blocks.0.mlp.0.weight" in dense
    assert dense["encoder.blocks.0.mlp.0.weight"].shape == (512, 128)

    mgr = CheckpointManager(str(tmp_path / "exp"), keep_nbest=2)
    history = {}
    for ep in (1, 2):
        with torch.no_grad():
            model.encoder.blocks[0].adapter_mlp.model[0].weight.add_(1.0)
        history[ep] = {"valid": {"acc": float(ep)}}
        mgr.save_epoch(ep, model, history)
    with np.load(mgr.average_nbest(history)) as ave:
        assert ave["encoder/blocks/attn/query/w_q"].dtype == np.int8
        np.testing.assert_array_equal(ave["encoder/blocks/attn/query/w_q"],
                                      flat["encoder/blocks/attn/query/w_q"])
        np.testing.assert_allclose(ave["encoder/blocks/adapter_mlp/down/w"][0],
                                   numpy_from_params(model.state_dict())[
                                       "encoder/blocks/adapter_mlp/down/w"][0] - 0.5,
                                   rtol=1e-6)


def test_int8_train_cli_then_decode_cli_matches_jax_cli(tmp_path):
    """bin.train --override freeze_quant=int8 (whisper `test` dims, CPU,
    float32) -> bin.decode on its n-best average, against JAX's decode CLI
    on the same checkpoint: token-exact hypotheses."""
    from agacs_tpu.bin import decode as jax_cli
    from agacs_tpu.eval.scoring import read_trn
    from agacs_tpu_torch.bin import decode, train

    _write_data_dir(tmp_path / "train", {f"t{i}": (8000 + 1000 * i, "我们 go")
                                         for i in range(4)}, seed=0)
    _write_data_dir(tmp_path / "valid", {"v0": (9000, "hello 你好"), "v1": (7000, "ok")},
                    seed=1)
    exp = tmp_path / "exp"
    out = train.main([
        "--config", RECIPE, "--train_dir", str(tmp_path / "train"),
        "--valid_dir", str(tmp_path / "valid"), "--exp_dir", str(exp),
        "--max_epoch", "2", "--batch_bins", "40000", "--compute_dtype", "float32",
        "--device", "cpu", "--override", "encoder_conf.whisper_model=test",
        "decoder_conf.whisper_model=test", "freeze_quant=int8", "keep_nbest_models=2"])
    assert all(np.isfinite(ep["train"]["loss"]) for ep in out["history"].values())
    with np.load(out["ave"]) as ave:
        assert ave["encoder/blocks/mlp/fc1/w_q"].dtype == np.int8
    common = ["--config", str(exp / "config.yaml"), "--params", out["ave"],
              "--data_dir", str(tmp_path / "valid"), "--compute_dtype", "float32",
              "--max_steps", "6"]
    res = decode.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    assert set(res["hyps"]) == {"v0", "v1"}
    assert (read_trn(str(tmp_path / "torch" / "hyp.trn"))
            == read_trn(str(tmp_path / "jax" / "hyp.trn")))
    assert "freeze_quant: int8" in (exp / "config.yaml").read_text()


# ---------------------------------------------------------------------------
# the kernels, on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K8", "K2"])
def test_int8_kernels_match_plain_on_card(kernel):
    """K8q/K8g (forward and dgrad) or K2f/K2b against their plain versions
    on the card, with chip_smoke.py's shapes and bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    check = chip_smoke.check_k8 if kernel == "K8" else chip_smoke.check_k2
    check(torch.device("cuda"), torch.Generator().manual_seed(0), timed=False)
