"""K5 above d_head 128 on the CPU: the port's plain forward and backward
(`relpos_flash.relpos_mha_plain`, `relpos_mha_bwd_plain`) against
agacs_tpu's Pallas kernels `_fwd_pallas` and `_bwd_pallas` run in interpret
mode at d_head 160 (d 640, 4 heads), 256 (d 1024, 4 heads), 512 (d 512, 1
head) and 1024 (d 1024, 1 head), T 64 and 67 (a partial tile); at d_head
512 and 1024 with d_head 64's inputs unscaled, the port's float32 forward
and backward against a float64 reference within twice JAX's own error; the card
wrapper's zero-padding of d_head 160 to 256 (K5's wide route, two chunks of
128) changing nothing; the envelope's head widths above 128; the conformer
encoder at d 256 with one head (d_head 256) against JAX's; and the bf16
`conformer_asr.forward` loss of a 2-block, 1-head model against JAX's.
Inputs are made with numpy from a seed.

Tolerances, with their reasons (`tests/test_torch_relpos_widths.py`'s):
float32 1e-5 x max |ref| (the same arithmetic, summed in another order);
bf16 1e-2 x max |ref| (p, do / l and ds rounded to bf16 after float32 sums
taken in another order). The padded plain versions against the unpadded:
1e-6 x max |ref| (the zero columns add exact zeros; the products' float32
sums may split differently), the padded columns of every gradient exact
zeros. The encoders: float32 1e-5 (JAX's einsum path on both sides); bf16
on K5's path (JAX's kernel interpreted, the port's plain version) 5e-2
relative L2, `chip_smoke.py`'s CONF_REL_L2 for bf16 rounding through
conformer blocks. The bf16 loss 1e-2 relative
(`tests/test_torch_conformer_train.py`'s: bf16 activations rounded at
other places).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import conformer_asr as jasr
from agacs_tpu.ops import relpos_flash as jrf
from agacs_tpu.utils.config import task_from_dict as jax_task_from_dict
from agacs_tpu_torch.models import conformer_asr as tasr
from agacs_tpu_torch.models.checkpoint import conformer_params_from_numpy
from agacs_tpu_torch.ops import relpos_flash, vocab_lse
from agacs_tpu_torch.utils.config import task_from_dict

torch.set_num_threads(1)

NAMES = ("dqu", "dqv", "dk", "dv", "dpe")
# (d, heads) of each head width above 128: 160 (padded to 256 on the
# card), 256, 512 and 1024 (one head of the whole model)
WIDE = {160: (640, 4), 256: (1024, 4), 512: (512, 1), 1024: (1024, 1)}
CASES = [(dh, t, dt) for dh in WIDE for t in (64, 67) for dt in ("float32", "bfloat16")]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, rtol, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


def _inputs(dh: int, t: int, seed: int, scaled: bool = True):
    """qu, qv, k, v (2, T, d), pe (Wp, d) zero-padded, the additive mask
    (row 1's last 20 keys masked) and the output cotangent, as float32
    numpy; content and position scores of the spread and offset that
    `tests/test_torch_relpos_widths.py` gives d_head 64 (qu's and k's
    means scaled with their spread by (64 / d_head)^0.25, so the content
    scores' offset stays -8 after the d_head^-0.5 scale); `scaled` False:
    d_head 64's inputs unscaled (scores spread sqrt(d_head / 64) times
    wider)."""
    d, _ = WIDE[dh]
    rng = np.random.RandomState(seed)
    sc = (64 / dh) ** 0.25 if scaled else 1.0
    qu = rng.randn(2, t, d) * 1.5 * sc - sc
    qv = rng.randn(2, t, d) * 1.5 * sc
    k = rng.randn(2, t, d) * 1.5 * sc + sc
    v = rng.randn(2, t, d)
    pe = np.zeros((jrf._wp(t), d))
    pe[: 2 * t - 1] = rng.randn(2 * t - 1, d) * 1.5 * sc
    mask = np.zeros((2, t), np.float32)
    mask[1, t - 20:] = jrf.NEG_MASK
    do = rng.randn(2, t, d)
    return [x.astype(np.float32) for x in (qu, qv, k, v, pe)], mask, do.astype(np.float32)


def _pair(xs, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(x).astype(jdt) for x in xs]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt) for x in jx]
    return jx, tx


@pytest.mark.parametrize("dh,t,dtype", CASES)
def test_plain_forward_and_backward_match_pallas(dh, t, dtype):
    """The forward (through `relpos_mha`, which takes the plain version for
    a CPU tensor) and then the backward on JAX's forward output."""
    xs, mask, do = _inputs(dh, t, seed=dh + t)
    h = WIDE[dh][1]
    jx, tx = _pair(xs, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    jm = jnp.asarray(mask)
    o = jrf._fwd_pallas(*jx, jm, h, True)
    out = relpos_flash.relpos_mha(*tx, torch.from_numpy(mask), h)
    assert out.dtype == tdt
    _close(out, o, rtol, f"K5 d_head {dh} T={t} {dtype}")
    ref = jrf._bwd_pallas(*jx, jm, o, jnp.asarray(do).astype(jdt), h, True)
    ref = list(ref[:4]) + [jnp.sum(ref[4], axis=0).astype(jdt)]
    got = relpos_flash.relpos_mha_bwd_plain(
        *tx, torch.from_numpy(mask), torch.from_numpy(_np(o)).to(tdt),
        torch.from_numpy(do).to(tdt), h)
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == tdt, name
        _close(g, r, rtol, f"{name} d_head {dh} T={t} {dtype}")
    assert relpos_flash.LAUNCHES == relpos_flash.BWD_LAUNCHES == 0


def _f64_reference(xs, mask, do, h):
    """The rel-pos attention's output and its gradients in qu, qv, k, v and
    pe, in float64 by autograd from the definition (scores, the shift as a
    gather of columns T-1-q+j, the mask, a softmax, the value product)."""
    qu, qv, k, v, pe = (torch.from_numpy(x).double().requires_grad_() for x in xs)
    b, t, d = qu.shape
    dh = d // h

    def heads(x):
        return x.reshape(b, t, h, dh).transpose(1, 2)

    peh = pe[: 2 * t - 1].reshape(2 * t - 1, h, dh).transpose(0, 1)
    cols = (t - 1) - torch.arange(t)[:, None] + torch.arange(t)[None, :]
    bd = (heads(qv) @ peh.transpose(-1, -2)[None]).gather(3, cols.expand(b, h, t, t))
    s = ((heads(qu) @ heads(k).transpose(-1, -2) + bd) * dh ** -0.5
         + torch.from_numpy(mask).double()[:, None, None, :])
    o = (torch.softmax(s, -1) @ heads(v)).transpose(1, 2).reshape(b, t, d)
    return o.detach(), torch.autograd.grad(o, (qu, qv, k, v, pe), torch.from_numpy(do).double())


@pytest.mark.parametrize("dh,t", [(dh, t) for dh in (512, 1024) for t in (64, 67)])
def test_unscaled_inputs_float32_backward_within_twice_jax(dh, t):
    """At d_head 512 and 1024 with d_head 64's inputs unscaled (scores 2.8
    and 4 times wider: worse conditioned than the scaled cases above), the
    port's float32 forward and backward (the plain versions a CPU tensor
    takes) against a float64 reference, each within twice JAX's own
    float32 error there (`_fwd_pallas` and `_bwd_pallas` interpreted), as
    max |err| / max |ref|."""
    xs, mask, do = _inputs(dh, t, seed=dh + t + 1, scaled=False)
    h = WIDE[dh][1]
    o64, g64 = _f64_reference(xs, mask, do, h)
    jx, tx = _pair(xs, "float32")
    jm = jnp.asarray(mask)
    oj = jrf._fwd_pallas(*jx, jm, h, True)
    gj = jrf._bwd_pallas(*jx, jm, oj, jnp.asarray(do), h, True)
    gj = list(gj[:4]) + [jnp.sum(gj[4], axis=0)]
    ot = relpos_flash.relpos_mha(*tx, torch.from_numpy(mask), h)
    gt = relpos_flash.relpos_mha_bwd_plain(*tx, torch.from_numpy(mask), ot,
                                           torch.from_numpy(do), h)

    def rel(out, ref):
        return float(np.abs(np.asarray(_np(out), np.float64) - ref.numpy()).max()
                     / ref.abs().max().item())

    for name, port, jax_out, ref in zip(("o",) + NAMES, [ot, *gt], [oj, *gj], [o64, *g64]):
        assert port.dtype == torch.float32, name
        err, jax_err = rel(port, ref), rel(jax_out, ref)
        assert 0 < jax_err and err <= 2 * jax_err, (
            f"{name} d_head {dh} T={t}: port {err:.3e} > 2 x JAX's {jax_err:.3e}")


def test_padding_160_to_256_changes_nothing():
    """What the card wrapper does at d_head 160: each head zero-padded to
    256 (two chunks of 128 on K5's wide route), the real width's scale
    kept, the padded columns dropped; the plain forward and backward on the
    padded heads equal the unpadded ones, and the padded columns of every
    gradient are exact zeros."""
    dh, t, h = 160, 67, 4
    d = h * dh
    w = relpos_flash.instance(dh)
    assert w == 256 and w % relpos_flash.CHUNK == 0 and w not in relpos_flash.INSTANCES
    rng = np.random.RandomState(dh)
    qu, qv, k, v = (torch.from_numpy(rng.randn(2, t, d).astype(np.float32)) for _ in range(4))
    pe = relpos_flash.pad_pe(torch.from_numpy(rng.randn(2 * t - 1, d).astype(np.float32)), t)
    mask = torch.zeros(2, t)
    mask[1, 50:] = relpos_flash.NEG_MASK
    do = torch.from_numpy(rng.randn(2, t, d).astype(np.float32))

    def pad(x):
        y = relpos_flash.pad_heads(x, h, w)
        assert y.shape[-1] == h * w and y.is_contiguous()
        return y

    o = relpos_flash.relpos_mha_plain(qu, qv, k, v, pe, mask, h)
    o_pad = relpos_flash.relpos_mha_plain(pad(qu), pad(qv), pad(k), pad(v), pad(pe), mask, h,
                                          scale=dh ** -0.5)
    assert torch.equal(relpos_flash.unpad_heads(pad(o), h, dh), o)
    _close(relpos_flash.unpad_heads(o_pad, h, dh), o, 1e-6, "padded forward d_head 160")
    ref = relpos_flash.relpos_mha_bwd_plain(qu, qv, k, v, pe, mask, o, do, h)
    got = relpos_flash.relpos_mha_bwd_plain(pad(qu), pad(qv), pad(k), pad(v), pad(pe), mask,
                                            pad(o), pad(do), h, scale=dh ** -0.5)
    for name, g, r in zip(NAMES, got, ref):
        assert not g.reshape(*g.shape[:-1], h, w)[..., dh:].any(), name
        _close(relpos_flash.unpad_heads(g, h, dh), r, 1e-6, f"padded {name} d_head 160")


@pytest.mark.parametrize("dh,want", [(136, 256), (160, 256), (248, 256), (256, 256),
                                     (264, 384), (376, 384), (512, 512), (1024, 1024),
                                     (1280, 1280)])
def test_wide_heads_run_at_the_next_chunk_multiple(dh, want):
    """Above the 128 instance a head is padded to the next multiple of
    CHUNK (128): K5's wide route takes the chunk count at launch."""
    assert relpos_flash.instance(dh) == want
    assert relpos_flash.check_envelope(64, 16 * dh, 16) == want


# 2 blocks at d 256 with one head (d_head 256)
RAW = {"encoder": "conformer",
       "encoder_conf": {"output_size": 256, "attention_heads": 1, "linear_units": 512,
                        "num_blocks": 2, "cnn_module_kernel": 15, "unroll_layers": True},
       "decoder": "transformer",
       "decoder_conf": {"attention_heads": 4, "linear_units": 512, "num_blocks": 1},
       "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1},
       "normalize": "global_mvn",
       "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80}}
V, SOS, EOS = 300, 298, 299
LENS = np.array([48000, 40000])  # 93 and 77 encoder frames: K5's envelope


def _cfgs(dtype: str):
    out = []
    for task, dt in ((jax_task_from_dict, jnp), (task_from_dict, torch)):
        c = task(RAW, compute_dtype=getattr(dt, dtype)).cfg
        out.append(dataclasses.replace(
            c, decoder=dataclasses.replace(c.decoder, vocab_size=V), sos=SOS, eos=EOS,
            use_specaug=False, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0)))
    return tuple(out)


def _tree(jcfg, seed: int) -> dict:
    return jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(seed),
                                                                   jcfg))


def _audio(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    audio = (rng.randn(2, int(LENS.max())) * 0.1).astype(np.float32)
    audio[1, LENS[1]:] = 0.0
    return audio


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_head_encoder_matches_jax(dtype, monkeypatch):
    """bf16: K5's path on both sides (JAX's kernel interpreted, the port's
    plain version); float32: the einsum path on both sides."""
    monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret" if dtype == "bfloat16" else "0")
    jcfg, tcfg = _cfgs(dtype)
    tree = _tree(jcfg, seed=1)
    model = tasr.ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg))
    audio = _audio(seed=1)
    ref, ref_lens = jasr.encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(audio),
                                jnp.asarray(LENS))
    calls = []
    real = relpos_flash.relpos_mha
    relpos_flash.relpos_mha = lambda *a: calls.append(1) or real(*a)
    try:
        with torch.no_grad():
            out, lens = tasr.encode(model, torch.from_numpy(audio), torch.from_numpy(LENS))
    finally:
        relpos_flash.relpos_mha = real
    assert len(calls) == (2 if dtype == "bfloat16" else 0)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert out.shape == (2, 93, 256)
    if dtype == "float32":
        _close(out, ref, 1e-5, "one-head encoder")
    else:
        o, r = _np(out).astype(np.float64), _np(ref).astype(np.float64)
        rel = np.linalg.norm(o - r) / np.linalg.norm(r)
        assert rel <= 5e-2, f"bf16 one-head encoder: rel L2 {rel}"


def test_one_head_bf16_loss_matches_jax(monkeypatch):
    """bf16 `conformer_asr.forward` of the 2-block, 1-head model: the
    rel-pos attention takes K5's path and the CTC head K4's (the plain
    versions here, JAX's Pallas kernels interpreted); every gradient
    finite."""
    monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret")
    monkeypatch.setenv("AGACS_VOCAB_LSE", "interpret")
    jcfg, tcfg = _cfgs("bfloat16")
    tree = _tree(jcfg, seed=2)
    rng = np.random.RandomState(2)
    tree["mvn"] = {"mean": rng.randn(80).astype(np.float32),
                   "std": (0.5 + rng.rand(80)).astype(np.float32)}
    text = np.full((2, 7), -1, np.int64)
    text[0, :5] = rng.randint(1, 290, 5)
    text[1, :3] = rng.randint(1, 290, 3)
    batch = {"speech": _audio(seed=2), "speech_lengths": LENS.copy(), "text": text}
    ref, ref_stats = jasr.forward(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in batch.items()}, train=True, rng=jax.random.PRNGKey(0))
    model = tasr.ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg),
                                              param_dtype=torch.float32)
    for p in model.parameters():
        p.requires_grad_(True)
    loss, stats = tasr.forward(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                               train=True, generator=torch.Generator().manual_seed(0))
    loss.backward()
    for k in ("loss", "loss_att", "loss_ctc"):
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]), rtol=1e-2, err_msg=k)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert relpos_flash.LAUNCHES == relpos_flash.BWD_LAUNCHES == 0
    assert vocab_lse.FWD_LAUNCHES == vocab_lse.DX_LAUNCHES == vocab_lse.DW_LAUNCHES == 0
