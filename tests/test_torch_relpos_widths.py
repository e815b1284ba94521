"""K5 at head widths other than 64, on the CPU: the port's plain forward
and backward (`relpos_flash.relpos_mha_plain`, `relpos_mha_bwd_plain`)
against agacs_tpu's Pallas kernels `_fwd_pallas` and `_bwd_pallas` run in
interpret mode at d_head 32, 48 and 128, T 64 and 67 (a partial tile); the
zero-padding of a head to the next K5 instance (`pad_heads`, what the card
wrapper does at d_head 48 or 96) changing nothing; the conformer encoder at
d 256 with 2 heads (d_head 128) and 8 heads (d_head 32) against JAX's; and
the kernel's envelope against JAX's `supports`. Inputs are made with numpy
from a seed.

Tolerances, with their reasons (`tests/test_torch_relpos_bwd.py`'s):
float32 1e-5 x max |ref| (the same arithmetic, summed in another order);
bf16 1e-2 x max |ref| (p, do / l and ds rounded to bf16 after float32 sums
taken in another order). The padded plain versions against the unpadded:
1e-6 x max |ref| (the zero columns add exact zeros; the products' float32
sums may split differently). The encoders: float32 1e-5 (JAX's einsum path
on both sides); bf16 on K5's path (JAX's kernel interpreted, the port's
plain version) 5e-2 relative L2, `chip_smoke.py`'s CONF_REL_L2 for bf16
rounding through conformer blocks.
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
from agacs_tpu_torch.models.checkpoint import conformer_params_from_numpy
from agacs_tpu_torch.models.conformer_asr import ConformerASR, encode
from agacs_tpu_torch.ops import relpos_flash
from agacs_tpu_torch.utils.config import task_from_dict

torch.set_num_threads(1)

NAMES = ("dqu", "dqv", "dk", "dv", "dpe")
# (d, heads) of each head width: 32 and 48 inside JAX's envelope (d % 128
# == 0), 128 at d 256
WIDTHS = {32: (128, 4), 48: (384, 8), 128: (256, 2)}
CASES = [(dh, t, dt) for dh in WIDTHS for t in (64, 67) for dt in ("float32", "bfloat16")]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, rtol, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


def _inputs(dh: int, t: int, seed: int):
    """qu, qv, k, v (2, T, d), pe (Wp, d) zero-padded, the additive mask
    (row 1's last 20 keys masked) and the output cotangent, as float32
    numpy; content and position scores of comparable spread at this
    d_head."""
    d, _ = WIDTHS[dh]
    rng = np.random.RandomState(seed)
    sc = 1.5 * (64 / dh) ** 0.25
    qu = rng.randn(2, t, d) * sc - 1.0
    qv = rng.randn(2, t, d) * sc
    k = rng.randn(2, t, d) * sc + 1.0
    v = rng.randn(2, t, d)
    pe = np.zeros((jrf._wp(t), d))
    pe[: 2 * t - 1] = rng.randn(2 * t - 1, d) * sc
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
def test_plain_forward_matches_pallas(dh, t, dtype):
    xs, mask, _ = _inputs(dh, t, seed=dh + t)
    h = WIDTHS[dh][1]
    jx, tx = _pair(xs, dtype)
    ref = jrf._fwd_pallas(*jx, jnp.asarray(mask), h, True)
    out = relpos_flash.relpos_mha(*tx, torch.from_numpy(mask), h)
    assert out.dtype == tx[0].dtype
    _close(out, ref, 1e-5 if dtype == "float32" else 1e-2, f"K5 d_head {dh} T={t} {dtype}")


@pytest.mark.parametrize("dh,t,dtype", CASES)
def test_plain_backward_matches_pallas(dh, t, dtype):
    xs, mask, do = _inputs(dh, t, seed=dh + t + 1)
    h = WIDTHS[dh][1]
    jx, tx = _pair(xs, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = jnp.asarray(mask)
    o = jrf._fwd_pallas(*jx, jm, h, True)
    ref = jrf._bwd_pallas(*jx, jm, o, jnp.asarray(do).astype(jdt), h, True)
    ref = list(ref[:4]) + [jnp.sum(ref[4], axis=0).astype(jdt)]
    got = relpos_flash.relpos_mha_bwd_plain(
        *tx, torch.from_numpy(mask), torch.from_numpy(_np(o)).to(tdt),
        torch.from_numpy(do).to(tdt), h)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == tdt, name
        _close(g, r, rtol, f"{name} d_head {dh} T={t} {dtype}")


@pytest.mark.parametrize("dh", [32, 48, 96, 128])
def test_padded_heads_change_nothing(dh):
    """What the card wrapper does at a width between instances: each head
    zero-padded to `instance(dh)`, the real width's scale kept, the padded
    columns dropped; the plain forward and backward on the padded heads
    equal the unpadded ones."""
    t, h = 67, 4
    d = h * dh
    rng = np.random.RandomState(dh)
    qu, qv, k, v = (torch.from_numpy(rng.randn(2, t, d).astype(np.float32)) for _ in range(4))
    pe = relpos_flash.pad_pe(torch.from_numpy(rng.randn(2 * t - 1, d).astype(np.float32)), t)
    mask = torch.zeros(2, t)
    mask[1, 50:] = relpos_flash.NEG_MASK
    do = torch.from_numpy(rng.randn(2, t, d).astype(np.float32))
    w = relpos_flash.instance(dh)
    assert w >= dh and w in relpos_flash.INSTANCES

    def pad(x):
        y = relpos_flash.pad_heads(x, h, w)
        assert y.shape[-1] == h * w and y.is_contiguous()
        return y

    o = relpos_flash.relpos_mha_plain(qu, qv, k, v, pe, mask, h)
    o_pad = relpos_flash.relpos_mha_plain(pad(qu), pad(qv), pad(k), pad(v), pad(pe), mask, h,
                                          scale=dh ** -0.5)
    assert torch.equal(relpos_flash.unpad_heads(pad(o), h, dh), o)
    _close(relpos_flash.unpad_heads(o_pad, h, dh), o, 1e-6, f"padded forward d_head {dh}")
    ref = relpos_flash.relpos_mha_bwd_plain(qu, qv, k, v, pe, mask, o, do, h)
    got = relpos_flash.relpos_mha_bwd_plain(pad(qu), pad(qv), pad(k), pad(v), pad(pe), mask,
                                            pad(o), pad(do), h, scale=dh ** -0.5)
    for name, g, r in zip(NAMES, got, ref):
        if w != dh:  # the padded columns' gradients are exact zeros
            assert not g.reshape(*g.shape[:-1], h, w)[..., dh:].any(), name
        _close(relpos_flash.unpad_heads(g, h, dh), r, 1e-6, f"padded {name} d_head {dh}")


# (T, d, heads) around the envelope's edges: T 63/64/640/641, d % 128, d_head
# % 8, and d_head 8 .. 1024
ENVELOPE = [(t, d, h) for t in (63, 64, 468, 640, 641)
            for d, h in ((128, 2), (128, 4), (128, 16), (256, 2), (256, 8), (256, 32),
                         (384, 8), (384, 3), (512, 4), (512, 2), (768, 8), (1024, 8),
                         (1024, 4), (192, 4), (1280, 10), (640, 5), (512, 1), (640, 4),
                         (768, 2), (1024, 1))]


@pytest.mark.parametrize("t,d,h", ENVELOPE)
def test_envelope_is_jax_supports(t, d, h, monkeypatch):
    """K5 on the card takes every (T, d, h) JAX's `supports` takes: at the
    least instance that holds d_head, or above 128 at the least multiple of
    128 (the wide route); it raises, naming the envelope, exactly where
    JAX's `supports` says no, and `supports` (which picks the conformer's
    path) stays JAX's."""
    monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret")
    jax_ok = jrf.supports(t, d, h, jnp.bfloat16)
    assert relpos_flash.supports(t, d, h, torch.bfloat16) == jax_ok
    if jax_ok:
        w = relpos_flash.check_envelope(t, d, h)
        dh = d // h
        assert w == (min(i for i in relpos_flash.INSTANCES if i >= dh) if dh <= 128
                     else -(-dh // 128) * 128)
    else:
        with pytest.raises(ValueError, match="envelope"):
            relpos_flash.check_envelope(t, d, h)


# 2 blocks at d 256: 2 heads (d_head 128), 8 heads (d_head 32)
def _raw(heads: int) -> dict:
    return {"encoder": "conformer",
            "encoder_conf": {"output_size": 256, "attention_heads": heads, "linear_units": 512,
                             "num_blocks": 2, "cnn_module_kernel": 15, "unroll_layers": True},
            "decoder": "transformer",
            "decoder_conf": {"attention_heads": heads, "linear_units": 512, "num_blocks": 1},
            "normalize": "global_mvn",
            "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80}}


LENS = np.array([48000, 40000])  # 93 and 77 encoder frames: K5's envelope


@pytest.mark.parametrize("heads", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(heads, dtype, monkeypatch):
    """bf16: K5's path on both sides (JAX's kernel interpreted, the port's
    plain version); float32: the einsum path on both sides."""
    monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret" if dtype == "bfloat16" else "0")
    raw = _raw(heads)
    jcfg = jax_task_from_dict(raw, compute_dtype=getattr(jnp, dtype)).cfg
    tcfg = task_from_dict(raw, compute_dtype=getattr(torch, dtype)).cfg
    jcfg, tcfg = (dataclasses.replace(c, decoder=dataclasses.replace(c.decoder, vocab_size=300),
                                      sos=298, eos=299) for c in (jcfg, tcfg))
    tree = jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(heads),
                                                                   jcfg))
    model = ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg))
    rng = np.random.RandomState(heads)
    audio = (rng.randn(2, int(LENS.max())) * 0.1).astype(np.float32)
    audio[1, LENS[1]:] = 0.0
    ref, ref_lens = jasr.encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(audio),
                                jnp.asarray(LENS))
    calls = []
    real = relpos_flash.relpos_mha
    relpos_flash.relpos_mha = lambda *a: calls.append(1) or real(*a)
    try:
        with torch.no_grad():
            out, lens = encode(model, torch.from_numpy(audio), torch.from_numpy(LENS))
    finally:
        relpos_flash.relpos_mha = real
    assert len(calls) == (2 if dtype == "bfloat16" else 0)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert out.shape == (2, 93, 256)
    if dtype == "float32":
        _close(out, ref, 1e-5, f"encoder {heads} heads")
    else:
        o, r = _np(out).astype(np.float64), _np(ref).astype(np.float64)
        rel = np.linalg.norm(o - r) / np.linalg.norm(r)
        assert rel <= 5e-2, f"bf16 encoder {heads} heads: rel L2 {rel}"
