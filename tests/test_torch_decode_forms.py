"""K3's whisper-only forms at every head width and K3s past 16 queries, on
the CPU: the ancestry map (K3a), PE (K3-PE, K3a-PE) and int8 caches
(K3-int8, K3a-int8) at d_head 32, 48, 80, 128 and 256, the plain rows at
320 and 512 (the long route, heads streamed in 256-wide pieces), K3s at
17, 20, 32 and 33 queries a group (tiles of 16) and at d_head 128 and 256
(64-channel sub-rows), each against JAX's Pallas
kernel interpreted (`_make_kernel` and `_make_kernel_shared` take any
width and any beam), keys past pos poisoned on both kernels' sides; the
route `envelope` names at these shapes; and the constants the wrapper
shares with `csrc/decode_attn.cu`. Inputs are made with numpy from a seed.

Tolerances, as `tests/test_torch_decode_split.py` sets them: float32
within 1e-5 absolute on outputs of magnitude ~1 (summation order); bf16
within 2e-2 absolute (where each side rounds); int8 within 1e-5 x max
|JAX| of JAX's interpreted kernel (both round q·s_k and p to bf16 the same
way)."""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.models import whisper as jw
from agacs_tpu.ops import decode_attn as jda
from agacs_tpu_torch.ops import decode_attn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, TP, H, BEAM = 6, 96, 2, 3  # 2 groups of 3 rows; int8 needs Tp % 32
WIDTHS = (32, 48, 80, 128, 256)
FORMS = ("anc", "pe", "anc_pe", "int8", "anc_int8")


def _inputs(seed: int, n: int, caches: int, d: int, pos: int, int8: bool):
    """numpy q (pre-scaled), k, v and the same caches with keys past pos
    poisoned (int8: quantised first, poison 127)."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(n, d) * (d // H) ** -0.5).astype(np.float32)
    k = rng.randn(caches, TP, d).astype(np.float32)
    v = (rng.randn(caches, TP, d) * 0.5).astype(np.float32)
    scales = {}
    if int8:
        (k, ks), (v, vs) = jw._quantize_kv(jnp.asarray(k)), jw._quantize_kv(jnp.asarray(v))
        k, v = np.array(k), np.array(v)
        scales = {"k_scale": np.array(ks), "v_scale": np.array(vs)}
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[:, pos + 1:] = 127 if int8 else 0.0
    v_bad[:, pos + 1:] = 127 if int8 else 1e4
    return rng, q, k_bad, v_bad, scales


def _compare(out: torch.Tensor, ref, dtype: str, int8: bool, what: str):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.float().numpy()
    assert out.shape == ref.shape, what
    if int8:
        atol = 1e-5 * np.abs(ref).max()
    else:
        atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out, ref, atol=atol, err_msg=what)


CASES = [(form, dh, dt, pos) for form in FORMS for dh in WIDTHS
         for dt in (("bfloat16",) if "int8" in form else ("bfloat16", "float32"))
         for pos in (5, TP - 1)]


@pytest.mark.parametrize("form, dh, dtype, pos", CASES)
def test_form_at_width_matches_jax_kernel(form, dh, dtype, pos):
    """The port's plain version of each whisper-only form (what the CPU
    wrapper runs; on the card `decode_attn_forms_fwd`, or the long route
    for float32) against JAX's `_make_kernel` interpreted at d_head dh."""
    d, int8 = H * dh, "int8" in form
    rng, q, k, v, scales = _inputs(dh + 3 * pos + 17 * FORMS.index(form), N, N, d, pos, int8)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    extra = {}
    if "anc" in form:
        extra.update(anc_local=rng.randint(0, BEAM, (N, TP)).astype(np.int32), beam=BEAM)
    if "pe" in form:
        k_cs = rng.randn(N, TP, d).astype(np.float32)
        k_cs[:, pos + 1:] = 0.0
        extra.update(q_cs=(rng.randn(N, d) * (dh ** -0.5)).astype(np.float32), k_cs=k_cs,
                     gate=rng.rand(H).astype(np.float32))

    def cast_j(name, x):
        if not isinstance(x, np.ndarray):
            return x
        if x.dtype == np.float32 and name not in ("gate", "k_scale", "v_scale"):
            return jnp.asarray(x).astype(jdt)
        return jnp.asarray(x)

    def cast_t(name, x):
        if not isinstance(x, np.ndarray):
            return x
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(tdt) if t.dtype == torch.float32 and name not in (
            "gate", "k_scale", "v_scale") else t

    allargs = {"q": q, "k": k, "v": v, **extra, **scales}
    ref = jda.decode_cache_attention(*(cast_j(n, allargs[n]) for n in ("q", "k", "v")), pos, H,
                                     interpret=True,
                                     **{n: cast_j(n, x) for n, x in allargs.items()
                                        if n not in ("q", "k", "v")})
    out = decode_attn.decode_cache_attention(*(cast_t(n, allargs[n]) for n in ("q", "k", "v")),
                                             pos, H, **{n: cast_t(n, x) for n, x in
                                                        allargs.items()
                                                        if n not in ("q", "k", "v")})
    assert out.dtype == tdt
    _compare(out, ref, dtype, int8, f"{form} d_head {dh} {dtype} pos {pos}")


@pytest.mark.parametrize("dh", [320, 512])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pos", [0, 50, TP - 1])
def test_plain_rows_above_256_match_jax_kernel(dh, dtype, pos):
    """Plain rows above d_head 256 take the long route (heads in 256-wide
    pieces); its plain version against JAX's kernel interpreted."""
    d = H * dh
    _, q, k, v, _ = _inputs(dh + pos, N, N, d, pos, False)
    assert decode_attn.envelope("rows", dh, 1, TP, getattr(torch, dtype)) == "long"
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jda.decode_cache_attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), pos, H,
                                     interpret=True)
    out = decode_attn.decode_cache_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                             pos, H)
    _compare(out, ref, dtype, False, f"rows d_head {dh} {dtype} pos {pos}")


@pytest.mark.parametrize("j", [17, 20, 32, 33])
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("pos", [3, TP - 1])
def test_shared_past_16_queries_matches_jax_kernel(j, kind, pos):
    """K3s at j queries a group (two or three tiles of 16 on the card's
    tensor cores at d_head 64) against JAX's `_make_kernel_shared`
    interpreted, 2 groups over (2, 96, 128), 2 heads of 64."""
    g, d, int8 = 2, H * 64, kind == "int8"
    _, q, k, v, scales = _inputs(j + pos + 50 * int8, g * j, g, d, pos, int8)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16) if x.dtype == np.float32 \
        else jnp.asarray(x)  # noqa: E731
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = ((torch.from_numpy(x) if int8 else torch.from_numpy(x).to(torch.bfloat16))
              for x in (k, v))
    assert decode_attn.plan("shared", g, H, tk, j)[0] == "shared"
    ref = jda.decode_shared_cache_attention(bf(q), bf(k), bf(v), pos, H, j, interpret=True,
                                            **{n: jnp.asarray(x) for n, x in scales.items()})
    out = decode_attn.decode_shared_cache_attention(
        tq, tk, tv, pos, H, j, **{n: torch.from_numpy(x) for n, x in scales.items()})
    _compare(out, ref, "bfloat16", int8, f"K3s j {j} {kind} pos {pos}")


@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("j", [5, 20])
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_shared_at_wider_heads_matches_jax_kernel(dh, j, kind):
    """K3s at d_head 128 and 256 (the card's tensor cores on 64-channel
    sub-rows) against JAX's `_make_kernel_shared` interpreted, 2 groups
    over (2, 96, 2 x dh), pos 60."""
    g, d, int8, pos = 2, H * dh, kind == "int8", 60
    _, q, k, v, scales = _inputs(dh + j + 7 * int8, g * j, g, d, pos, int8)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16) if x.dtype == np.float32 \
        else jnp.asarray(x)  # noqa: E731
    tk, tv = ((torch.from_numpy(x) if int8 else torch.from_numpy(x).to(torch.bfloat16))
              for x in (k, v))
    assert decode_attn.plan("shared", g, H, tk, j)[0] == "shared"
    ref = jda.decode_shared_cache_attention(bf(q), bf(k), bf(v), pos, H, j, interpret=True,
                                            **{n: jnp.asarray(x) for n, x in scales.items()})
    out = decode_attn.decode_shared_cache_attention(
        torch.from_numpy(q).to(torch.bfloat16), tk, tv, pos, H, j,
        **{n: torch.from_numpy(x) for n, x in scales.items()})
    _compare(out, ref, "bfloat16", int8, f"K3s d_head {dh} j {j} {kind}")


@pytest.mark.parametrize("form, dh, dtype, beam, want", [
    ("anc", 64, torch.bfloat16, 5, "d64"),        # whisper's K3a: the fixed instance
    ("anc", 128, torch.bfloat16, 5, "forms"),     # the runtime-width forms
    ("anc_pe", 48, torch.bfloat16, 5, "forms"),
    ("pe", 80, torch.bfloat16, 1, "forms"),
    ("rows", 80, torch.int8, 1, "forms"),
    ("anc", 256, torch.int8, 5, "forms"),
    ("rows", 40, torch.int8, 1, "long"),          # not a multiple of 16 int8 channels
    ("anc", 36, torch.bfloat16, 5, "long"),       # not a multiple of 8 bf16 channels
    ("anc", 64, torch.float32, 5, "long"),        # float32 forms
    ("rows", 320, torch.bfloat16, 1, "long"),     # past 256: the head in pieces
    ("rows", 33, torch.float32, 1, "long"),       # any width
    ("rows", 36, torch.bfloat16, 1, "rows"),      # the plain rows' runtime width
    ("rows", 48, torch.bfloat16, 1, "d48"),
    ("rows", 64, torch.float32, 1, "f32"),
    ("shared", 64, torch.bfloat16, 33, "shared"),  # three query tiles
    ("shared", 128, torch.int8, 5, "shared"),     # two 64-channel sub-rows
    ("shared", 256, torch.bfloat16, 20, "shared"),
    ("shared", 96, torch.int8, 5, "long"),        # not a multiple of 64: one query a block
    ("shared", 320, torch.bfloat16, 5, "long"),
    ("shared", 64, torch.float32, 5, "long"),
])
def test_envelope_routes(form, dh, dtype, beam, want):
    """The kernel `envelope` names at 96 keys in one block."""
    assert decode_attn.envelope(form, dh, beam, TP, dtype) == want


@pytest.mark.parametrize("form,dh,dtype,beam,keys,splits,want", [
    ("rows", 64, torch.float32, 1, 6016, 1, "f32"),    # the LM, 80 rows x 8 heads, 6000 steps
    ("rows", 64, torch.float32, 1, 8192, 1, "f32"),    # a table of scores: 8192 keys
    ("rows", 64, torch.float32, 1, 8208, 1, "long"),
    ("rows", 64, torch.bfloat16, 1, 8192, 1, "d64"),
    ("rows", 64, torch.int8, 1, 8192, 1, "d64"),
    ("pe", 128, torch.bfloat16, 1, 8192, 1, "forms"),
    ("rows", 512, torch.float32, 1, 8192, 1, "long"),  # past 256: long at any keys
    ("anc", 64, torch.bfloat16, 5, 4096, 1, "d64"),    # scores beside rows: 4096 keys
    ("anc", 64, torch.bfloat16, 5, 4112, 1, "long"),
    ("anc_pe", 128, torch.bfloat16, 5, 4112, 1, "long"),
    ("rows", 256, torch.bfloat16, 1, 32816, 8, "rows"),  # blocks of 4102 keys
    ("rows", 256, torch.bfloat16, 1, 65616, 8, "long"),  # blocks of 8202 keys
    ("shared", 64, torch.bfloat16, 5, 18016, 3, "shared"),  # blocks of 6006 keys
    ("shared", 64, torch.bfloat16, 5, 65616, 8, "long"),
])
def test_short_route_holds_its_table(form, dh, dtype, beam, keys, splits, want):
    """A block takes the short route while its keys fit one table
    (`short_keys`: 8192 scores, 4096 beside an ancestry map's rows), and
    the long route past it."""
    assert decode_attn.envelope(form, dh, beam, keys, dtype, splits) == want


def test_plan_keeps_the_lm_on_the_short_route():
    """The recipe's LM in joint beam search (80 rows, 8 heads of 64, one
    block a (head, row)) over 6016 positions stays on K3-f32's table; its
    decoder at 10 rows over 65616 positions splits 8 ways into blocks past
    the table and takes the long route in passes of PASS_KEYS."""
    lm = torch.empty(80, 6016, 512, dtype=torch.float32, device="meta")
    assert decode_attn.plan("rows", 80, 8, lm) == ("f32", 1, decode_attn.PASS_KEYS)
    dec = torch.empty(10, 65616, 256, dtype=torch.bfloat16, device="meta")
    assert decode_attn.plan("rows", 10, 4, dec) == ("long", 8, decode_attn.PASS_KEYS)


def test_routes_share_the_sources_constants():
    """The wrapper's limits are the source's: the forms' widths and
    alignment, the long route's head piece and pass, K3s's query tile."""
    with open(os.path.join(REPO, "agacs_tpu_torch", "csrc", "decode_attn.cu")) as f:
        src = f.read()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa
    assert const("PIECE") == decode_attn.HEAD_PIECE
    assert decode_attn.PASS_KEYS <= const("MAX_PASS") and decode_attn.PASS_KEYS % 64 == 0
    assert const("QTILE") == decode_attn.QUERY_TILE
    assert const("DH_MAX") == decode_attn.ROWS_D_HEAD_MAX
    assert "dw % (quant ? 16 : 8)" in src
    assert decode_attn.FORMS_ALIGN == {torch.bfloat16: 8, torch.int8: 16}
    assert "kc < 64 || kc % 64" in src
    assert re.search(r"constexpr int MAX_DYN_SMEM = 220 \* 1024;", src) and \
        decode_attn.MAX_DYN_SMEM == 220 * 1024
    assert "if (dh % DH || dh < DH || dh > 4 * DH)" in src and \
        decode_attn.SHARED_WIDTHS == tuple(64 * m for m in range(1, 5))
