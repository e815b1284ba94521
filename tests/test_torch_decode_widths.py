"""K3's and K3-f32's plain rows at head widths other than 64, on the CPU:
the conformer decoder's cached step and the transformer LM's cached step
at d_head 32, 36, 128 and 256 against JAX's with its decode kernel forced
(`AGACS_DECODE_KERNEL=pallas`: `_make_kernel` interpreted, which takes any
width), the kernels' split over time (`decode_cache_attention_split_ref`)
at those widths against JAX's interpreted kernel and oracle, and the rule
of which widths the card's rows take (`rows_width_ok`) against the
constant it shares with `csrc/decode_attn.cu`. Inputs are made with numpy
from a seed.

Tolerances, with their reasons: the decode and LM steps run in float32 on
both sides, 1e-5 x max |ref| (the same arithmetic, summed in another order,
as `tests/test_torch_conformer.py`); the split reference in float32 1e-5
absolute, in bf16 2e-2 absolute on outputs of magnitude ~1 (p rounded to
bf16 after float32 sums taken in another order), as
`tests/test_torch_decode_split.py`.
"""

import dataclasses
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import conformer as jconf
from agacs_tpu.models import conformer_asr as jasr
from agacs_tpu.models import lm as jlm
from agacs_tpu.ops import decode_attn as jda
from agacs_tpu.utils.config import task_from_dict as jax_task_from_dict
from agacs_tpu_torch.models import conformer as tconf
from agacs_tpu_torch.models import lm as tlm
from agacs_tpu_torch.models.checkpoint import conformer_params_from_numpy, lm_params_from_numpy
from agacs_tpu_torch.models.conformer_asr import ConformerASR
from agacs_tpu_torch.ops import decode_attn
from agacs_tpu_torch.utils.config import task_from_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# d_head -> (d, heads): 32, 36 (Conformer(S) 144 / 4), 128 (the XLarge
# 1024 / 8) and 256, at 2 heads (1 at 256) to keep the steps small
WIDTHS = {32: (64, 2), 36: (72, 2), 128: (256, 2), 256: (256, 1)}
V, SOS, EOS = 300, 298, 299


def _close(out, ref, rtol, what):
    out = out.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


def _count_calls(monkeypatch, module, name) -> list:
    calls, real = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("dh", list(WIDTHS))
def test_decoder_step_matches_jax_kernel(dh, monkeypatch):
    """Five cached steps of the conformer decoder (2 blocks) at d_head dh:
    JAX on its Pallas kernel, the port on K3's plain version."""
    monkeypatch.setenv("AGACS_DECODE_KERNEL", "pallas")
    d, h = WIDTHS[dh]
    raw = {"encoder": "conformer",
           "encoder_conf": {"output_size": d, "attention_heads": h, "linear_units": 2 * d,
                            "num_blocks": 1, "cnn_module_kernel": 15},
           "decoder": "transformer",
           "decoder_conf": {"attention_heads": h, "linear_units": 2 * d, "num_blocks": 2}}
    jcfg = jax_task_from_dict(raw, compute_dtype=jnp.float32).cfg
    tcfg = task_from_dict(raw, compute_dtype=torch.float32).cfg
    jcfg, tcfg = (dataclasses.replace(c, decoder=dataclasses.replace(c.decoder, vocab_size=V),
                                      sos=SOS, eos=EOS) for c in (jcfg, tcfg))
    tree = jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(dh), jcfg))
    model = ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg))
    rng = np.random.RandomState(dh)
    mem = rng.randn(2, 30, d).astype(np.float32)
    mlens = np.array([30, 22])
    tokens = rng.randint(0, V, (2, 5))
    jcalls = _count_calls(monkeypatch, jda, "decode_cache_attention")
    tcalls = _count_calls(monkeypatch, tconf, "decode_cache_attention")
    jdec = jax.tree.map(jnp.asarray, tree["decoder"])
    jkv = jconf.init_decoder_kv_cache(jcfg.decoder, 2, 12)
    jcross = jconf.precompute_decoder_cross_kv(jdec, jcfg.decoder, jnp.asarray(mem))
    kv = tconf.init_decoder_kv_cache(tcfg.decoder, 2, 12)
    with torch.no_grad():
        cross = tconf.precompute_decoder_cross_kv(model.decoder, torch.from_numpy(mem))
        for pos in range(5):
            ref, jkv = jconf.transformer_decode_step(
                jdec, jcfg.decoder, jnp.asarray(tokens[:, pos]), jnp.int32(pos), jkv, jcross,
                jnp.asarray(mlens))
            out, kv = tconf.transformer_decode_step(
                model.decoder, torch.from_numpy(tokens[:, pos]), pos, kv, cross,
                torch.from_numpy(mlens))
            _close(out, ref, 1e-5, f"decoder step d_head {dh} pos={pos}")
    assert len(jcalls) == len(tcalls) == 2 * 5  # both layers, every step, on the kernels


@pytest.mark.parametrize("dh", list(WIDTHS))
def test_lm_step_matches_jax_kernel(dh, monkeypatch):
    """Six cached steps of a 2-block LM (float32 caches: K3-f32 on the card)
    at d_head dh, JAX on its Pallas kernel."""
    monkeypatch.setenv("AGACS_DECODE_KERNEL", "pallas")
    d, h = WIDTHS[dh]
    conf = dict(vocab_size=V, d_model=d, attention_heads=h, linear_units=2 * d, num_blocks=2,
                sos=SOS, eos=EOS)
    jcfg, tcfg = jlm.TransformerLMConfig(**conf), tlm.TransformerLMConfig(**conf)
    tree = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(dh), jcfg))
    lm = tlm.TransformerLM.from_state_dict(tcfg, lm_params_from_numpy(tree, tcfg))
    tokens = np.random.RandomState(dh + 1).randint(0, V, (3, 6))
    jcalls = _count_calls(monkeypatch, jda, "decode_cache_attention")
    jp = jax.tree.map(jnp.asarray, tree)
    jkv = jlm.init_lm_kv_cache(jcfg, 3, 8)
    kv = tlm.init_lm_kv_cache(tcfg, 3, 8)
    assert kv["k"][0].dtype == torch.float32
    with torch.no_grad():
        for pos in range(6):
            ref, jkv = jlm.lm_score_step_cached(jp, jcfg, jnp.asarray(tokens[:, pos]),
                                                jnp.int32(pos), jkv)
            out, kv = tlm.lm_score_step_cached(lm, torch.from_numpy(tokens[:, pos]), pos, kv)
            _close(out, ref, 1e-5, f"LM step d_head {dh} pos={pos}")
    assert len(jcalls) == 2 * 6


SPLIT_CASES = [(dh, s, pos, dt) for dh in (36, 44, 128, 256) for s in (1, 3, 8)
               for pos in (0, 41, 95) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("dh,splits,pos,dtype", SPLIT_CASES)
def test_split_ref_matches_jax_at_width(dh, splits, pos, dtype):
    """The card's split over time (global max and sum, p normalised and,
    in bf16, rounded, the partials in rank order) at a width other than 64,
    against JAX's kernel interpreted and its oracle; keys past pos
    poisoned in the kernels' caches."""
    h, n, tp = 2, 3, 96
    d = h * dh
    rng = np.random.RandomState(dh + splits + pos)
    q = (rng.randn(n, d) * dh ** -0.5).astype(np.float32)
    k = rng.randn(n, tp, d).astype(np.float32)
    v = rng.randn(n, tp, d).astype(np.float32)
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[:, pos + 1:], v_bad[:, pos + 1:] = 0.0, 1e4
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = lambda x: jnp.asarray(x).astype(jdt)  # noqa: E731
    kernel = jda.decode_cache_attention(j(q), j(k_bad), j(v_bad), pos, h, interpret=True)
    ref = jda.decode_cache_attention_ref(j(q), j(k), j(v), pos, h)
    t = lambda x: torch.from_numpy(x).to(tdt)  # noqa: E731
    out = decode_attn.decode_cache_attention_split_ref(t(q), t(k_bad), t(v_bad), pos, h, splits)
    assert out.dtype == tdt and out.shape == (n, d)
    atol = 1e-5 if dtype == "float32" else 2e-2
    for what, r in (("kernel", kernel), ("oracle", ref)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   atol=atol, err_msg=f"{what} d_head {dh} S {splits}")


def test_rows_width_rule():
    """The plain rows take every d_head <= ROWS_D_HEAD_MAX that is a
    multiple of 4 (8-byte bf16 pieces where 16 bytes do not divide the row)
    and nothing else; the limit is the source's DH_MAX."""
    for dh in range(1, 300):
        want = dh <= decode_attn.ROWS_D_HEAD_MAX and dh % decode_attn.ROWS_D_HEAD_ALIGN == 0
        assert decode_attn.rows_width_ok(4 * dh, 4) == want, dh
    assert not decode_attn.rows_width_ok(130, 4)  # d not a multiple of the heads
    with open(os.path.join(REPO, "agacs_tpu_torch", "csrc", "decode_attn.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int DH_MAX = (\d+);", src).group(1)) == \
        decode_attn.ROWS_D_HEAD_MAX
    assert "if (dw <= 0 || dw > DH_MAX || dw % 4)" in src
