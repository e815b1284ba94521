"""K4 and the CTC losses on the CPU: the port's plain versions of the
streaming vocabulary log-sum-exp (`ops/vocab_lse.lse_plain`,
`lse_bwd_plain`) against agacs_tpu's Pallas kernels `_fwd_pallas` /
`_bwd_pallas` in interpret mode; `ctc_loss_streaming` (value and gradients
in the encoder output, the head's weight and bias) against JAX's; the
streaming loss against the dense `ctc_loss` oracle; and the whisper
family's CTC head (`asr_model.forward` with ctc_weight 0.3) against JAX's.
Inputs are made with numpy from a seed.

Tolerances, with their reasons:
  * lse 1e-5 relative (float32 sums of exp in another order);
  * dx and dW, bf16 outputs, 1e-2 x max |ref| (both round dz to bf16 and
    the results to bf16, after float32 sums in another order); db 1e-5 x
    max |ref| (float32 sums);
  * the CTC losses in float32, value and gradients, 1e-5 x max |ref|
    (float32 log-add-exp recursions of a few hundred terms); against the
    dense oracle the gradients 1e-4 x max |ref| (the oracle rounds each
    log-probability once, from one product; the streaming loss twice,
    from its lse and from the gathered label product); bf16
    encoder output 1e-2 x max |ref| (the bf16 head product rounds z
    differently on each side);
  * the whisper CTC head's loss terms 1e-5 relative (float32 layers), its
    gradients 1e-4 x max |ref| (JAX's CPU path is the dense one, see the
    oracle).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops import vocab_lse as jvl
from agacs_tpu.train import losses as jlosses
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import numpy_from_params, params_from_numpy
from agacs_tpu_torch.ops import vocab_lse
from agacs_tpu_torch.train import losses

torch.set_num_threads(1)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, rtol, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


@pytest.fixture(scope="module")
def k4_case():
    """N 700 (not a multiple of the 512-row block), K 128, V 5000 (not a
    multiple of any V tile): bf16 x and W, float32 b and g."""
    rng = np.random.RandomState(0)
    n, k, v = 700, 128, 5000
    x = jnp.asarray(rng.randn(n, k), jnp.bfloat16)
    w = jnp.asarray(rng.randn(k, v) * 3 / np.sqrt(k), jnp.bfloat16)
    b = jnp.asarray(rng.randn(v), jnp.float32)
    g = jnp.asarray(rng.randn(n), jnp.float32)
    lse = jvl._fwd_pallas(x, w, b, interpret=True)
    return (x, w, b, g), lse, jvl._bwd_pallas(x, w, b, lse, g, interpret=True)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t.to(dtype) if dtype is not None else t


def test_plain_lse_matches_pallas_forward(k4_case):
    (x, w, b, _), ref, _ = k4_case
    out = vocab_lse.lse_plain(_t(x, torch.bfloat16), _t(w, torch.bfloat16), _t(b))
    assert out.dtype == torch.float32 and out.shape == (700,)
    rel = np.abs(_np(out) - _np(ref)) / np.abs(_np(ref))
    assert rel.max() <= 1e-5, rel.max()


@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_plain_backward_matches_pallas_backward(k4_case, part):
    (x, w, b, g), lse, ref = k4_case
    out = vocab_lse.lse_bwd_plain(_t(x, torch.bfloat16), _t(w, torch.bfloat16), _t(b),
                                  _t(lse), _t(g))
    i = ("dx", "dw", "db").index(part)
    want = {"dx": torch.bfloat16, "dw": torch.bfloat16, "db": torch.float32}[part]
    assert out[i].dtype == want
    _close(out[i], ref[i], 1e-2 if part != "db" else 1e-5, part)


def test_streaming_lse_autograd_is_the_plain_backward(k4_case):
    (x, w, b, g), _, _ = k4_case
    xs = [_t(x, torch.bfloat16).requires_grad_(), _t(w, torch.bfloat16).requires_grad_(),
          _t(b).requires_grad_()]
    lse = vocab_lse.streaming_lse(*xs)
    lse.backward(_t(g))
    want = vocab_lse.lse_bwd_plain(*(t.detach() for t in xs), lse.detach(), _t(g))
    for t, r in zip(xs, want):
        assert torch.equal(t.grad, r)
    assert vocab_lse.FWD_LAUNCHES == vocab_lse.DX_LAUNCHES == vocab_lse.DW_LAUNCHES == 0


def _ctc_case(seed=0):
    """B 3, T 40, d 128, V 300: row 0 with repeated labels, row 1
    infeasible (8 labels, 5 frames), row 2 with no labels."""
    rng = np.random.RandomState(seed)
    b, t, d, v = 3, 40, 128, 300
    enc = rng.randn(b, t, d).astype(np.float32)
    w = (rng.randn(d, v) / np.sqrt(d)).astype(np.float32)
    bias = (rng.randn(v) * 0.1).astype(np.float32)
    labels = np.full((b, 8), -1, np.int32)
    labels[0, :6] = [5, 5, 7, 9, 9, 9]
    labels[1, :8] = rng.randint(1, v, 8)
    logit_lens = np.array([40, 5, 33], np.int32)
    label_lens = (labels != -1).sum(1).astype(np.int32)
    return enc, w, bias, logit_lens, labels, label_lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ctc_loss_streaming_matches_jax(dtype):
    enc, w, bias, ll, labels, lab_lens = _ctc_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(e, w_, b_):
        return jlosses.ctc_loss_streaming(e, w_, b_, jnp.asarray(ll), jnp.asarray(labels),
                                          jnp.asarray(lab_lens))

    ref, ref_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(enc).astype(jdt), jnp.asarray(w), jnp.asarray(bias))
    xs = [torch.from_numpy(enc).to(tdt).requires_grad_(), torch.from_numpy(w).requires_grad_(),
          torch.from_numpy(bias).requires_grad_()]
    loss = losses.ctc_loss_streaming(*xs, torch.from_numpy(ll).long(),
                                     torch.from_numpy(labels).long(),
                                     torch.from_numpy(lab_lens).long())
    loss.backward()
    rtol = 1e-5 if dtype == "float32" else 1e-2
    assert np.isfinite(loss.item()) and loss.item() > 0
    np.testing.assert_allclose(loss.item(), float(ref), rtol=rtol)
    for name, t, r in zip(("enc", "w", "b"), xs, ref_g):
        _close(t.grad, r, rtol, f"d{name} {dtype}")
    # the infeasible row and the empty one get no gradient
    assert float(xs[0].grad[1].abs().max()) == 0.0


def test_ctc_loss_streaming_matches_the_dense_oracle():
    """The streaming loss (unnormalised planes, the port's recursion) and
    the dense log_softmax + F.ctc_loss path: values and gradients."""
    enc, w, bias, ll, labels, lab_lens = _ctc_case(seed=1)
    args = [torch.from_numpy(x).long() for x in (ll, labels, lab_lens)]
    a = [torch.from_numpy(x).requires_grad_() for x in (enc, w, bias)]
    b = [torch.from_numpy(x).requires_grad_() for x in (enc, w, bias)]
    streaming = losses.ctc_loss_streaming(*a, *args)
    dense = losses.ctc_loss(b[0] @ b[1] + b[2], *args)
    streaming.backward()
    dense.backward()
    np.testing.assert_allclose(float(streaming), float(dense), rtol=1e-5)
    for name, x, y in zip(("enc", "w", "b"), a, b):
        _close(x.grad, y.grad, 1e-4, f"d{name}")


def test_ctc_loss_matches_jax_dense():
    enc, w, bias, ll, labels, lab_lens = _ctc_case(seed=2)
    logits = enc @ w + bias
    ref = jlosses.ctc_loss(jnp.asarray(logits), jnp.asarray(ll),
                           jnp.asarray(np.where(labels == -1, 0, labels)), jnp.asarray(lab_lens))
    out = losses.ctc_loss(torch.from_numpy(logits), *(torch.from_numpy(x).long()
                                                      for x in (ll, labels, lab_lens)))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


# the whisper family's CTC head (JAX asr_model.py:133-137, :199-218)
DIMS = dict(n_mels=80, n_audio_ctx=20, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=16, n_text_state=128, n_text_head=2, n_text_layer=2)


def test_whisper_ctc_head_matches_jax(tmp_path):
    jcfg = jasr.ASRModelConfig(whisper=jw.WhisperConfig(**DIMS), use_specaug=False,
                               ctc_weight=0.3)
    tcfg = asr_model.ASRModelConfig(whisper=tw.WhisperConfig(**DIMS), use_specaug=False,
                                    ctc_weight=0.3)
    params = jax.tree.map(np.asarray, jasr.init_asr_params(jax.random.PRNGKey(0), jcfg))
    assert params["ctc"]["w"].shape == (128, 51865)
    sd = params_from_numpy(params, tcfg.whisper)
    assert sd["ctc.weight"].shape == (51865, 128)
    model = tw.Whisper.from_state_dict(tcfg.whisper, sd)
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.RandomState(3)
    text = np.full((2, 6), -1, np.int32)
    text[0, :5] = [50260, 50259, 50359, 50363, 1000]
    text[1, :3] = [50260, 1200, 1200]
    batch = {"speech": (rng.randn(2, 6400) * 0.05).astype(np.float32),
             "speech_lengths": np.array([6400, 4000], np.int32), "text": text}

    def jloss(p):
        return jasr.forward(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                            train=False)

    (ref, ref_stats), ref_g = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["text"] = tb["text"].long()
    loss, stats = asr_model.forward(model, tcfg, tb, train=False)
    loss.backward()
    assert set(stats) == set(ref_stats) == {"loss", "loss_att", "loss_ctc", "acc"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(ref_stats[k]), rtol=1e-5, err_msg=k)
    grads = numpy_from_params({n: p.grad for n, p in model.named_parameters()
                               if n.startswith("ctc.")})
    for key in ("ctc/w", "ctc/b"):  # JAX on the CPU: the dense path, as the oracle above
        _close(grads[key], ref_g["ctc"][key[-1]], 1e-4, key)
    # the npz round trip keeps the head
    out = numpy_from_params(model.state_dict())
    np.testing.assert_array_equal(out["ctc/w"], params["ctc"]["w"])
