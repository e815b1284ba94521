"""K3's long route (the counterpart of JAX's `_call_chunked`) on the CPU:
`decode_cache_attention_chunked_ref`, the split x passes in plain
PyTorch, against JAX's time-chunked kernel interpreted (forced the way
JAX's own tests force it, `_VMEM_BUDGET` patched down) for plain rows,
the ancestry map, PE, ancestry-PE and float32; against the single-block
plain versions where both apply; the CPU wrapper taking it where the card
would; the conformer decoder's, the LM's and whisper's beam-20 cached
steps past the long route's threshold (the short route's tables and
`decode_attn.PASS_KEYS` patched down) against JAX's steps on its kernels;
and `envelope`, the rule of which kernel takes a call, refusing nothing
that JAX's two functions accept. Inputs are made with numpy from a seed.

Tolerances, with their reasons: float32 against JAX's chunked kernel 2e-6
absolute on outputs of magnitude ~0.3 (JAX's own bound for that kernel
against its oracle, `tests/test_decode_attn.py:170`: the same recurrence,
summed in another order); bf16 2e-2 absolute (each side rounds p to bf16,
at its own pass edges, as `tests/test_torch_decode_split.py`); the chunked
reference against the single-block plain version in float32 1e-6 x max
(summation order only); the cached steps' logits in float32 1e-5 x max
|JAX| (as `tests/test_torch_decode_widths.py`)."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import conformer as jconf
from agacs_tpu.models import conformer_asr as jasr
from agacs_tpu.models import lm as jlm
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops import decode_attn as jda
from agacs_tpu.utils.config import task_from_dict as jax_task_from_dict
from agacs_tpu_torch.models import conformer as tconf
from agacs_tpu_torch.models import lm as tlm
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import (conformer_params_from_numpy, lm_params_from_numpy,
                                               params_from_numpy)
from agacs_tpu_torch.models.conformer_asr import ConformerASR
from agacs_tpu_torch.ops import decode_attn
from agacs_tpu_torch.utils.config import task_from_dict

torch.set_num_threads(1)

N, TP, D, H, BEAM = 6, 256, 64, 2, 3  # 2 groups of 3 rows, d_head 32
TC = 64  # JAX's chunk (forced by its budget) and the port's pass
FORMS = ("rows", "anc", "pe", "anc_pe", "rows_f32", "anc_pe_f32")
POS = (40, 63, 64, 191, 255)  # either side of a chunk edge, and the last key


def _budget(n_caches: int, rows: int) -> int:
    """JAX's VMEM budget that fits a (rows, TC, D) chunk and no larger one."""
    return 2 * n_caches * rows * TC * D * 2


def _case(form: str, pos: int):
    """numpy inputs of `form` (keys past pos poisoned on the kernels' side)
    and the keyword arguments each side takes."""
    rng = np.random.RandomState(100 + pos + 7 * FORMS.index(form))
    mk = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    q, k, v = mk(N, D) * 3.0, mk(N, TP, D) * 3.0, mk(N, TP, D)
    anc = np.zeros((N, TP), np.int32)
    kw = {}
    if "anc" in form:
        anc = rng.randint(0, BEAM, (N, TP)).astype(np.int32)
        kw.update(anc_local=anc, beam=BEAM)
    if "pe" in form:
        kw.update(q_cs=mk(N, D) * 3.0, k_cs=mk(N, TP, D) * 3.0,
                  gate=rng.rand(H).astype(np.float32))
    return q, k, v, kw


def _jax_chunked(form, q, k, v, pos, kw, monkeypatch):
    """JAX's decode_cache_attention with its chunked kernel forced and seen
    to run (tc == TC)."""
    pe, anc = "pe" in form, "anc" in form
    n_caches = 3 if pe else 2
    monkeypatch.setattr(jda, "_VMEM_BUDGET", _budget(n_caches, BEAM if anc else 1))
    calls, real = [], jda._call_chunked
    monkeypatch.setattr(jda, "_call_chunked",
                        lambda *a, **k_: calls.append(k_.get("tc", a[5])) or real(*a, **k_))
    dt = jnp.float32 if form.endswith("f32") else jnp.bfloat16
    j = {n: (jnp.asarray(x).astype(dt) if x.dtype == np.float32 and n != "gate"
             else jnp.asarray(x)) for n, x in kw.items() if n != "beam"}
    out = jda.decode_cache_attention(jnp.asarray(q).astype(dt), jnp.asarray(k).astype(dt),
                                     jnp.asarray(v).astype(dt), pos, H, interpret=True,
                                     beam=kw.get("beam", 1), **j)
    assert calls == [TC], calls
    return np.asarray(out.astype(jnp.float32))


def _force_long(monkeypatch, keys: int = TC) -> None:
    """The port's long route at small sizes: a short-route block holds at
    most `keys` keys, and the long route walks them in passes of `keys`."""
    for name in ("SHORT_KEYS", "SHORT_MAP_KEYS", "PASS_KEYS"):
        monkeypatch.setattr(decode_attn, name, keys)


def _torch(x, dt):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dt) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("splits", [1, 2])
def test_chunked_ref_matches_jax_chunked_kernel(form, pos, splits, monkeypatch):
    """The long route's plain version (S blocks, passes of TC keys from each
    block's first key) against JAX's `_call_chunked` (chunks of TC from key
    0), keys past pos poisoned in the port's input."""
    q, k, v, kw = _case(form, pos)
    ref = _jax_chunked(form, q, k, v, pos, kw, monkeypatch)
    f32 = form.endswith("f32")
    dt = torch.float32 if f32 else torch.bfloat16
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[:, pos + 1:], v_bad[:, pos + 1:] = 0.0, 1e4
    tkw = {n: (_torch(x, torch.float32 if n == "gate" else dt) if isinstance(x, np.ndarray)
               else x) for n, x in kw.items()}
    if "k_cs" in tkw:
        tkw["k_cs"][:, pos + 1:] = 0.0
    out = decode_attn.decode_cache_attention_chunked_ref(
        _torch(q, dt), _torch(k_bad, dt), _torch(v_bad, dt), pos, H, splits, TC, **tkw)
    assert out.dtype == dt and out.shape == (N, D)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-6 if f32 else 2e-2)


@pytest.mark.parametrize("form", ["rows", "anc", "pe", "anc_pe", "int8", "anc_int8", "shared",
                                  "shared_int8"])
@pytest.mark.parametrize("pos", [0, 63, 64, 200, 255])
def test_chunked_ref_is_the_single_block_plain_version(form, pos):
    """In float32 the passes and the split move only summation order: at
    every S and pass the chunked reference equals the short route's plain
    version (what the CPU wrapper runs at these shapes) within 1e-6 x
    max; int8 in the kernels' folding (q·s_k and p rounded to bf16) within
    2e-2 x max, where the two round p at different points."""
    shared = form.startswith("shared")
    q, k, v, kw = _case(form.replace("int8", "").replace("shared", "").strip("_") or "rows",
                        pos)
    if shared:  # N // 2 groups of BEAM queries over one cache each
        q = np.random.RandomState(pos).randn(N // 2 * BEAM, D).astype(np.float32)
        k, v = k[: N // 2], v[: N // 2]
        kw = {"beam": BEAM}
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    rtol = 1e-6
    if form.endswith("int8"):
        (tk, ks), (tv, vs) = tw.quantize_kv(tk), tw.quantize_kv(tv)
        tkw.update(k_scale=ks, v_scale=vs)
        rtol = 2e-2
    if shared:
        plain = decode_attn.decode_shared_cache_attention_plain(tq, tk, tv, pos, H, **tkw)
    else:
        plain = decode_attn.decode_cache_attention_plain(tq, tk, tv, pos, H, **tkw)
    for splits in (1, 3, 8):
        for kc in (64, 128, 1024):
            out = decode_attn.decode_cache_attention_chunked_ref(tq, tk, tv, pos, H, splits, kc,
                                                                 shared=shared, **tkw)
            np.testing.assert_allclose(out.numpy(), plain.numpy(),
                                       atol=rtol * plain.abs().max().item(),
                                       err_msg=f"S {splits} pass {kc}")


@pytest.mark.parametrize("form", ["rows", "anc_pe", "rows_f32"])
def test_cpu_wrapper_takes_the_long_route_where_the_card_would(form, monkeypatch):
    """A CPU tensor runs the plain version of the kernel the card would
    launch: with a pass shorter than a block's keys, the chunked reference
    at `time_splits`'s S, bit for bit; with the default pass, the short
    route's."""
    q, k, v, kw = _case(form, 200)
    dt = torch.float32 if form.endswith("f32") else torch.bfloat16
    tkw = {n: (_torch(x, torch.float32 if n == "gate" else dt) if isinstance(x, np.ndarray)
               else x) for n, x in kw.items()}
    args = (_torch(q, dt), _torch(k, dt), _torch(v, dt), 200, H)
    base = "anc_pe" if "anc" in form else "rows"
    short = decode_attn.decode_cache_attention(*args, **tkw)
    assert decode_attn.plan(base, N, H, args[1], kw.get("beam", 1))[0] != "long"
    _force_long(monkeypatch)
    route, s, kc = decode_attn.plan(base, N, H, args[1], kw.get("beam", 1))
    assert route == "long" and kc == TC and s == decode_attn.time_splits(N, H, TP)
    long = decode_attn.decode_cache_attention(*args, **tkw)
    assert torch.equal(long, decode_attn.decode_cache_attention_chunked_ref(*args, s, TC, **tkw))
    fn = (decode_attn.decode_cache_attention_anc_ref if "anc" in form
          else decode_attn.decode_cache_attention_ref)
    extra = (tkw["anc_local"], BEAM) if "anc" in form else ()
    pe = {n: tkw[n] for n in ("q_cs", "k_cs", "gate") if n in tkw}
    assert torch.equal(short, fn(*args, *extra, **pe))


# ---------------------------------------------------------------------------
# the cached steps past the long route's threshold
# ---------------------------------------------------------------------------

V, SOS, EOS = 300, 298, 299
STEP_ROWS, STEP_TP, STEP_POS = 10, 256, (190, 191, 192, 193)  # S 3: blocks of 86 keys


def _fill(rng, caches: dict, n_fill: int) -> tuple[dict, dict]:
    """Rows 0..n_fill-1 of every per-layer cache drawn from `rng`: the same
    numbers as a JAX cache dict and a torch one."""
    jout, tout = {}, {}
    for name, bufs in caches.items():
        arrs = []
        for b in bufs:
            a = np.zeros(tuple(b.shape), np.float32)
            a[:, :n_fill] = rng.randn(a.shape[0], n_fill, a.shape[2]).astype(np.float32) * 0.5
            arrs.append(a)
        jout[name] = tuple(jnp.asarray(a) for a in arrs)
        tout[name] = tuple(torch.from_numpy(a.copy()) for a in arrs)
    return jout, tout


def _long_counts(monkeypatch) -> list:
    calls, real = [], decode_attn.decode_cache_attention_chunked_ref
    monkeypatch.setattr(decode_attn, "decode_cache_attention_chunked_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _close(out, ref, what):
    out, ref = out.float().numpy(), np.asarray(jnp.asarray(ref).astype(jnp.float32))
    err, bound = np.abs(out - ref).max(), 1e-5 * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {bound}"


def test_conformer_and_lm_steps_past_the_long_route_match_jax(monkeypatch):
    """The conformer decoder's (d 64, 2 heads, 2 blocks) and the LM's cached
    steps at pos 190-193 over 10 rows whose caches hold 256 positions,
    rows 0..189 drawn from a seed: the port's long route (tables and passes
    of 64 keys, blocks of 86 keys) against JAX's steps on its chunked kernel (budget
    patched down)."""
    monkeypatch.setenv("AGACS_DECODE_KERNEL", "pallas")
    _force_long(monkeypatch)
    monkeypatch.setattr(jda, "_VMEM_BUDGET", 2 * 2 * 1 * 32 * 64 * 2)
    chunked, real = [], jda._call_chunked
    monkeypatch.setattr(jda, "_call_chunked", lambda *a, **k: chunked.append(1) or real(*a, **k))
    long = _long_counts(monkeypatch)
    d, h = 64, 2
    raw = {"encoder": "conformer",
           "encoder_conf": {"output_size": d, "attention_heads": h, "linear_units": 2 * d,
                            "num_blocks": 1, "cnn_module_kernel": 15},
           "decoder": "transformer",
           "decoder_conf": {"attention_heads": h, "linear_units": 2 * d, "num_blocks": 2}}
    jcfg = jax_task_from_dict(raw, compute_dtype=jnp.float32).cfg
    tcfg = task_from_dict(raw, compute_dtype=torch.float32).cfg
    jcfg, tcfg = (dataclasses.replace(c, decoder=dataclasses.replace(c.decoder, vocab_size=V),
                                      sos=SOS, eos=EOS) for c in (jcfg, tcfg))
    tree = jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(5), jcfg))
    model = ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg))
    conf = dict(vocab_size=V, d_model=d, attention_heads=h, linear_units=2 * d, num_blocks=2,
                sos=SOS, eos=EOS)
    jlcfg, tlcfg = jlm.TransformerLMConfig(**conf), tlm.TransformerLMConfig(**conf)
    ltree = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(6), jlcfg))
    lm = tlm.TransformerLM.from_state_dict(tlcfg, lm_params_from_numpy(ltree, tlcfg))
    rng = np.random.RandomState(8)
    mem = rng.randn(STEP_ROWS, 20, d).astype(np.float32)
    mlens = np.full((STEP_ROWS,), 20)
    tokens = rng.randint(0, V, (STEP_ROWS, len(STEP_POS)))
    jkv, kv = _fill(rng, tconf.init_decoder_kv_cache(tcfg.decoder, STEP_ROWS, STEP_TP),
                    STEP_POS[0])
    jlkv, lkv = _fill(rng, tlm.init_lm_kv_cache(tlcfg, STEP_ROWS, STEP_TP), STEP_POS[0])
    assert decode_attn.plan("rows", STEP_ROWS, h, kv["k"][0]) == ("long", 3, TC)
    jdec = jax.tree.map(jnp.asarray, tree["decoder"])
    jcross = jconf.precompute_decoder_cross_kv(jdec, jcfg.decoder, jnp.asarray(mem))
    jlp = jax.tree.map(jnp.asarray, ltree)
    with torch.no_grad():
        cross = tconf.precompute_decoder_cross_kv(model.decoder, torch.from_numpy(mem))
        for i, pos in enumerate(STEP_POS):
            tok = tokens[:, i]
            ref, jkv = jconf.transformer_decode_step(jdec, jcfg.decoder, jnp.asarray(tok),
                                                     jnp.int32(pos), jkv, jcross,
                                                     jnp.asarray(mlens))
            out, kv = tconf.transformer_decode_step(model.decoder, torch.from_numpy(tok), pos,
                                                    kv, cross, torch.from_numpy(mlens))
            _close(out, ref, f"decoder step pos={pos}")
            ref, jlkv = jlm.lm_score_step_cached(jlp, jlcfg, jnp.asarray(tok), jnp.int32(pos),
                                                 jlkv)
            out, lkv = tlm.lm_score_step_cached(lm, torch.from_numpy(tok), pos, lkv)
            _close(out, ref, f"LM step pos={pos}")
    steps = len(STEP_POS)
    assert len(long) == 2 * 2 * steps and len(chunked) == 2 * 2 * steps


def test_whisper_beam20_step_matches_jax_chunked(monkeypatch):
    """whisper_decode_step at beam 20 (2 utterances, 40 rows; a 2-layer
    decoder of d 128 and heads of 64) at pos 33-35 over a 64-position self
    cache whose rows 0..32 and ancestry map are drawn from a seed: JAX with
    its kernels forced takes `_call_chunked` (chunks of 32) for the
    self-attention and `_call_shared` at 20 queries for the cross; the port
    runs K3a's and K3s's plain versions (on the card: K3a at d_head 64, K3s
    in two query tiles)."""
    monkeypatch.setenv("AGACS_DECODE_KERNEL", "pallas")
    b, beam, tp, p0 = 2, 20, 64, 33
    n = b * beam
    dims = dict(n_mels=80, n_audio_ctx=16, n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                n_vocab=300, n_text_ctx=tp, n_text_state=128, n_text_head=2, n_text_layer=2,
                adapter=True)
    jcfg, tcfg = jw.WhisperConfig(**dims), tw.WhisperConfig(**dims)
    monkeypatch.setattr(jda, "_VMEM_BUDGET", 2 * 2 * beam * 32 * 128 * 2)
    assert jda.pick_chunk(2, beam, tp, 128) == 32 and jda.shared_kernel_fits(16, 128)
    seen = {"chunked": 0, "shared": 0}
    for name, key in (("_call_chunked", "chunked"), ("_call_shared", "shared")):
        real = getattr(jda, name)
        monkeypatch.setattr(jda, name, lambda *a, _r=real, _k=key, **k: (
            seen.__setitem__(_k, seen[_k] + 1), _r(*a, **k))[1])
    params = jw.init_whisper_params(jax.random.PRNGKey(3), jcfg)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    rng = np.random.RandomState(9)
    enc = rng.randn(b, 16, 128).astype(np.float32) * 0.3
    toks = rng.randint(0, 300, (n, 3)).astype(np.int32)
    kv_t = tw.init_self_kv_cache(tcfg, n, tp, ancestry=True)
    kv_j, kv_filled = _fill(rng, {k: kv_t[k] for k in ("k", "v")}, p0)
    base = np.arange(n)[:, None] // beam * beam
    anc = (base + rng.randint(0, beam, (n, tp))).astype(np.int32)[None]
    kv_j["anc"] = jnp.asarray(anc)
    kv_t = {**kv_filled, "anc": torch.from_numpy(anc.copy())}
    cross_j = jw.precompute_cross_kv(params, jcfg, jnp.asarray(enc))
    bf16_rows = torch.empty(n, tp, 128, dtype=torch.bfloat16)  # the card's caches
    assert decode_attn.plan("anc", n, 2, bf16_rows, beam)[0] == "d64"
    assert decode_attn.plan("shared", b, 2, torch.empty(b, 16, 128, dtype=torch.bfloat16),
                            beam)[0] == "shared"
    with torch.inference_mode():
        cross_t = tw.precompute_cross_kv(model, torch.from_numpy(enc))
        for i in range(3):
            p = p0 + i
            ref, kv_j = jw.whisper_decode_step(params, jcfg, jnp.asarray(toks[:, i]),
                                               jnp.int32(p), kv_j, cross_j, beam_groups=beam)
            out, kv_t = tw.whisper_decode_step(model, torch.from_numpy(toks[:, i]).long(), p,
                                               kv_t, cross_t, beam_groups=beam)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert seen == {"chunked": 2 * 3, "shared": 2 * 3}, seen


# ---------------------------------------------------------------------------
# the envelope
# ---------------------------------------------------------------------------

ROUTES = ("d64", "f32", "d48", "rows", "forms", "shared", "long")


@settings(max_examples=400, deadline=None, database=None)
@given(form=st.sampled_from(decode_attn.FORMS), d_head=st.integers(1, 2048),
       beam=st.integers(1, 64), tiles=st.integers(1, 4096),
       dtype=st.sampled_from(decode_attn.CACHE_DTYPES), splits=st.integers(1, 8),
       table_keys=st.sampled_from([None, 64, 128, 1024, 4096]))
def test_envelope_refuses_nothing_jax_accepts(form, d_head, beam, tiles, dtype, splits,
                                              table_keys):
    """Over (form, d_head, beam, keys, dtype) that JAX's
    `decode_cache_attention` / `decode_shared_cache_attention` accept (keys
    a multiple of its time tile, 32 for int8; PE never with int8, which
    JAX asserts), the envelope names a kernel and raises for none, and the
    kernel it names takes the call: the short routes only where a block's
    keys fit one pass, the fixed entries at their widths, K3s's tensor
    cores at 64-256 in bf16 or int8."""
    int8 = dtype == torch.int8
    if int8 and form in ("pe", "anc_pe"):
        with pytest.raises(ValueError, match="PE"):
            decode_attn.envelope(form, d_head, beam, 32 * tiles, dtype, splits, table_keys)
        return
    keys = (decode_attn.TIME_ALIGN_I8 if int8 else decode_attn.TIME_ALIGN) * tiles
    route = decode_attn.envelope(form, d_head, beam, keys, dtype, splits, table_keys)
    assert route in ROUTES
    chunk, table = -(-keys // splits), table_keys or decode_attn.short_keys(form)
    if route != "long":
        assert chunk <= table
    if route in ("d64", "f32"):
        assert d_head == decode_attn.D_HEAD
    if route == "shared":
        assert form == "shared" and dtype != torch.float32
        assert d_head in decode_attn.SHARED_WIDTHS
    if route in ("rows", "forms"):
        assert d_head <= decode_attn.ROWS_D_HEAD_MAX
    if route == "forms":
        assert form in ("anc", "pe", "anc_pe") or (form == "rows" and int8)
        assert d_head % decode_attn.FORMS_ALIGN[dtype] == 0
    if form == "shared" and route == "long":
        smem = (4 * decode_attn.query_tiles(beam)[1] * (chunk + splits * (d_head + 2))
                + decode_attn.SHARED_RING_KEYS * d_head * dtype.itemsize)
        assert d_head not in decode_attn.SHARED_WIDTHS or dtype == torch.float32 or \
            chunk > table or smem > decode_attn.MAX_DYN_SMEM


def test_envelope_keeps_jax_refusals():
    """PE with int8 caches: JAX asserts, the port raises."""
    with pytest.raises(AssertionError):
        z = jnp.zeros((2, 32, 64), jnp.int8)
        jda.decode_cache_attention(jnp.zeros((2, 64), jnp.bfloat16), z, z, 3, 1,
                                   q_cs=jnp.zeros((2, 64), jnp.bfloat16),
                                   k_cs=jnp.zeros((2, 32, 64), jnp.bfloat16),
                                   gate=jnp.zeros((1,)), k_scale=jnp.ones(64),
                                   v_scale=jnp.ones(64), interpret=True)
    for form in ("pe", "anc_pe"):
        with pytest.raises(ValueError, match="PE"):
            decode_attn.envelope(form, 64, 5, 448, torch.int8)
