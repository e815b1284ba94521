"""A conformer at USM-2B's width on the CPU: encoder d 1536 with 16 heads
(d_head 96; the CTC head K4's K 1536, above the KS-128 split's 1280), cut
to 1 encoder and 1 decoder block, feed-forward 256, V 1001, ~64 encoder
frames. The CTC loss through `ctc_loss_streaming` (the port's and JAX's,
JAX's K4 interpreted in bf16) with its gradients, and one train
micro-step's losses and every parameter's gradient (`conformer_asr.forward`)
against JAX's on the same JAX-initialised weights, carried across by
`conformer_params_from_numpy` as `test_torch_conformer_train.py` does.
Inputs are made with numpy from a seed.

Tolerances, `test_torch_conformer_train.py`'s: float32 losses 1e-5
relative and gradients 1e-4 x max |grad| (float32 sums in another order;
the key biases, zero in exact arithmetic, 5e-6 x the largest gradient),
except the two stride-2 subsampling convolutions' weights and biases: each
of their gradients sums products over every frame and frequency bin behind
the 1536-wide projection, and those float32 sums cancel to a small
remainder (JAX's and the port's float32 gradients there differ by up to
2.7e-3 of max |grad| at d 1536, under 1e-4 at the recipe's d 128), so
each is held to a float64 reference, the port's autograd in float64 on
the same weights with its float32 casts kept in float64: the port's
error within twice JAX's own (JAX reads up to 2.7e-3 of max |grad| from
float64 there, the port 1.2e-3: both float32 sums lose that much);
bf16 CTC loss 1e-3 relative and gradients 1e-2 x max |grad| (the same bf16
values on both sides, float32 sums in another order; dx and dW rounded to
bf16 as K4 returns them)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import conformer_asr as jasr
from agacs_tpu.train import losses as jlosses
from agacs_tpu.utils.config import task_from_dict as jax_task_from_dict
from agacs_tpu_torch.models import conformer_asr as tasr
from agacs_tpu_torch.models.checkpoint import (conformer_params_from_numpy,
                                               numpy_from_conformer_params)
from agacs_tpu_torch.ops import vocab_lse
from agacs_tpu_torch.train import losses as tlosses
from agacs_tpu_torch.utils.config import task_from_dict

torch.set_num_threads(1)

D, HEADS = 1536, 16
RAW = {
    "encoder": "conformer",
    "encoder_conf": {"output_size": D, "attention_heads": HEADS, "linear_units": 256,
                     "num_blocks": 1, "cnn_module_kernel": 15},
    "decoder": "transformer",
    "decoder_conf": {"attention_heads": HEADS, "linear_units": 256, "num_blocks": 1},
    "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1},
    "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
}
V, SOS, EOS = 1001, 999, 1000
# 64 and 54 encoder frames
LENS = np.array([33280, 28000])
ZERO_GRAD = ("attn/k/b", "src_attn/k/b", "self_attn/k/b")
# the subsampling convolutions' gradients, held to float64: see the module docstring
SUBSAMPLE = "encoder/subsample/conv"


def _cfgs(torch_dtype=torch.float32):
    out = []
    for task, dt in ((jax_task_from_dict, jnp.float32), (task_from_dict, torch_dtype)):
        c = task(RAW, compute_dtype=dt).cfg
        out.append(dataclasses.replace(
            c, decoder=dataclasses.replace(c.decoder, vocab_size=V), sos=SOS, eos=EOS,
            use_specaug=False, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0)))
    return tuple(out)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    speech = (rng.randn(2, int(LENS.max())) * 0.1).astype(np.float32)
    speech[1, LENS[1]:] = 0.0
    text = np.full((2, 9), -1, np.int64)
    text[0, :7] = rng.randint(1, 990, 7)
    text[0, 3] = text[0, 2]
    text[1, :4] = rng.randint(1, 990, 4)
    return {"speech": speech, "speech_lengths": LENS.copy(), "text": text}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_the_head_runs_k4_above_the_ks128_split():
    """The CTC head's K is d 1536: K4's KS-256 route on clusters of 6, the
    forward's resident rows at their limit; the heads are 96 wide."""
    _, tcfg = _cfgs()
    assert tcfg.encoder.output_size == D and D // tcfg.encoder.attention_heads == 96
    assert vocab_lse.padded_k(D) == D > vocab_lse.SPLIT128_K
    assert vocab_lse.dx_tiling(16 * 468, D, 51865, 132)["C"] == 6
    assert vocab_lse.fwd_tiling(16 * 468, D, 51865, 132)["route"] == "chunks"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ctc_loss_streaming_matches_jax(dtype, monkeypatch):
    """The CTC loss from a (2, 64, 1536) encoder output and the (1536,
    1001) head, and its gradients in the encoder output, W and b; bf16 runs
    JAX's K4 interpreted and the port's plain versions."""
    monkeypatch.setenv("AGACS_VOCAB_LSE", "interpret")
    rng = np.random.RandomState(5)
    enc = rng.randn(2, 64, D).astype(np.float32)
    w = (rng.randn(D, V) / np.sqrt(D)).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(1, V, (2, 9)).astype(np.int64)
    labels[1, 5:] = -1
    lens, label_lens = np.array([64, 54]), np.array([9, 5])
    jdt = getattr(jnp, dtype)

    def jloss(e, w_, b_):
        return jlosses.ctc_loss_streaming(e.astype(jdt), w_, b_, jnp.asarray(lens),
                                          jnp.asarray(labels.astype(np.int32)),
                                          jnp.asarray(label_lens))

    ref, ref_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(enc), jnp.asarray(w), jnp.asarray(b))
    te, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (enc, w, b))
    loss = tlosses.ctc_loss_streaming(te.to(getattr(torch, dtype)), tw, tb,
                                      torch.from_numpy(lens), torch.from_numpy(labels),
                                      torch.from_numpy(label_lens))
    loss.backward()
    rtol, gtol = (1e-5, 1e-4) if dtype == "float32" else (1e-3, 1e-2)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=rtol)
    for name, got, want in zip(("enc", "w", "b"), (te.grad, tw.grad, tb.grad), ref_g):
        want = np.asarray(want, np.float32)
        err = np.abs(got.numpy() - want).max()
        assert err <= gtol * np.abs(want).max(), (name, err, np.abs(want).max())


def _float64_forward(model, tcfg, batch):
    """`conformer_asr.forward` and its backward with every float32 cast
    (`Tensor.float`: the layer norms, the attention scores, the logits)
    kept in float64, from the frontend's float32 features on."""
    float32, featurize, keep = torch.Tensor.float, tasr._featurize, [True]

    def as_float(self, *args, **kwargs):
        if keep[0] and self.dtype == torch.float64:
            return self
        return float32(self, *args, **kwargs)

    def features(model, speech, lens):
        keep[0] = False
        try:
            feats, flens = featurize(model, speech, lens)
        finally:
            keep[0] = True
        return feats.double(), flens

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", as_float)
        mp.setattr(tasr, "_featurize", features)
        loss, stats = tasr.forward(model, tcfg, batch, train=True,
                                   generator=torch.Generator().manual_seed(0))
        loss.backward()
    return stats


@pytest.fixture(scope="module")
def micro_step():
    """JAX's micro-step on JAX-initialised weights, and the port's on the
    same weights in float32 and in float64 (`_float64_forward`):
    {"ref_stats", "ref_grads", "stats", "grads", "stats64", "grads64"},
    the gradients flat by JAX's names."""
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(0), jcfg))
    batch = _batch()
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt: jasr.forward(p, jcfg, bt, train=True, rng=jax.random.PRNGKey(0)),
        has_aux=True))
    (_, ref_stats), ref_grads = fn(jax.tree.map(jnp.asarray, tree), jb)
    out = {"ref_stats": ref_stats, "ref_grads": _flat(ref_grads)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for dt, key in ((torch.float32, ""), (torch.float64, "64")):
        tcfg = _cfgs(dt)[1]
        model = tasr.ConformerASR.from_state_dict(
            tcfg, conformer_params_from_numpy(tree, tcfg), param_dtype=dt).to(dt)
        for p in model.parameters():
            p.requires_grad_(True)
        if dt == torch.float32:
            loss, stats = tasr.forward(model, tcfg, tb, train=True,
                                       generator=torch.Generator().manual_seed(0))
            loss.backward()
        else:
            stats = _float64_forward(model, tcfg, tb)
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert all(g.dtype == dt for g in grads.values())
        grads.update({n: torch.zeros_like(buf) for n, buf in model.named_buffers()})
        out["stats" + key] = stats
        out["grads" + key] = {k: v for k, v in numpy_from_conformer_params(grads, tcfg).items()
                              if not (k.startswith("mvn/") or "running_" in k)}  # buffers
    return out


def test_micro_step_loss_and_gradients_match_jax(micro_step):
    """`conformer_asr.forward` (hybrid CTC/attention, train mode) at d 1536,
    16 heads: the losses, the accuracy and every parameter's gradient but
    the subsampling convolutions' (the next test)."""
    stats, ref_stats = micro_step["stats"], micro_step["ref_stats"]
    assert set(stats) == set(ref_stats) == {"loss", "loss_att", "loss_ctc", "acc"}
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]), rtol=1e-5, err_msg=k)
    got, want = micro_step["grads"], micro_step["ref_grads"]
    scale = max(np.abs(v).max() for v in want.values())
    assert got["ctc/w"].shape == (D, V)
    assert {k for k in got if k.startswith(SUBSAMPLE)} == {
        f"{SUBSAMPLE}{i}/{p}" for i in (1, 2) for p in ("w", "b")}
    for key, g in got.items():
        if key.startswith(SUBSAMPLE):
            continue
        r = want[key]
        bound = 5e-6 * scale if key.endswith(ZERO_GRAD) else 1e-4 * np.abs(r).max()
        err = np.abs(g - r).max()
        assert err <= bound, f"d {key}: max |err| {err} > {bound}"
    assert vocab_lse.FWD_LAUNCHES == vocab_lse.DX_LAUNCHES == vocab_lse.DW_LAUNCHES == 0


def test_subsampling_gradients_within_twice_jax_of_float64(micro_step):
    """The two subsampling convolutions' weight and bias gradients: the
    port's float32 against the float64 reference (`_float64_forward`,
    whose losses equal the float32 ones within 1e-5), within twice JAX's
    float32 error from the same reference, as max |err| / max |ref|."""
    ref64 = micro_step["grads64"]
    for k in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(micro_step["stats64"][k].item(),
                                   micro_step["stats"][k].item(), rtol=1e-5, err_msg=k)
    for key in sorted(k for k in ref64 if k.startswith(SUBSAMPLE)):
        r = ref64[key].astype(np.float64)
        scale = np.abs(r).max()
        port = np.abs(micro_step["grads"][key] - r).max() / scale
        jax_err = np.abs(micro_step["ref_grads"][key] - r).max() / scale
        assert port <= 2 * jax_err, f"d {key}: port {port:.3e} > 2 x JAX's {jax_err:.3e}"
