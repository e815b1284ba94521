"""The port's beam-search serving path against agacs_tpu on the CPU: K3a
(ancestry rows) and K3s (shared cross-KV) plain versions against the
Pallas kernels interpreted, the decode step with beam groups, the dense
beam loop under a synthetic step, `beam_decode`, `Speech2Text` and the
decode CLI. Same numpy-seeded inputs and JAX-initialized weights on both
sides.

Tolerances: attention in float32 within 1e-5 x max |ref| (summation
order), in bf16 within 1e-2 (where each side rounds); decode-step logits
1e-5; beam tokens and lengths exact, beam scores within 1e-5 relative
(float32 sums of log-softmax values; exact under the synthetic step)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.beam import beam_decode as jax_beam
from agacs_tpu.decode.composed_beam import composed_beam_decode as jax_composed
from agacs_tpu.decode.speech2text import Speech2Text as JaxSpeech2Text
from agacs_tpu.models import whisper as jw
from agacs_tpu.models.asr_model import ASRModelConfig as JaxASRConfig
from agacs_tpu.ops.decode_attn import decode_cache_attention as jax_dca
from agacs_tpu.ops.decode_attn import decode_shared_cache_attention as jax_dsca
from agacs_tpu_torch.decode.beam import beam_decode
from agacs_tpu_torch.decode.composed_beam import composed_beam_decode, top_k
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.ops import decode_attn

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=2, adapter=True)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(a: np.ndarray, bf16: bool):
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def beam_ancestry(rng, n: int, tp: int, j: int, pos: int) -> np.ndarray:
    """(n, tp) int32 local rows as a beam run leaves them: position t < pos
    of row i points to another slot of its group most of the time, and
    position pos to the row itself (the step writes it before attending)."""
    own = np.arange(n)[:, None] % j
    anc = (own + rng.randint(1, j, (n, tp))) % j
    keep = rng.rand(n, tp) < 0.2
    anc = np.where(keep, own, anc)
    anc[:, pos] = own[:, 0]
    return anc.astype(np.int32)


def poison_unread(k, v, anc, j, pos, value=1e4):
    """Poisoned copies of k, v: keys past pos, and every (row, t) at t <= pos
    that no row of its own group reads through the map, get k = 0 and
    v = value (finite: JAX's one-hot mix multiplies them by 0.0)."""
    n = k.shape[0]
    read = np.zeros((n, k.shape[1]), bool)
    rows = (np.arange(n) // j * j)[:, None] + anc
    read[rows, np.arange(k.shape[1])[None, :]] = True
    bad = ~read
    bad[:, pos + 1:] = True
    k, v = k.copy(), v.copy()
    k[bad], v[bad] = 0.0, value
    return k, v


@pytest.mark.parametrize("bf16,rtol", [(False, 1e-5), (True, 1e-2)])
@pytest.mark.parametrize("pos", [0, 9, 37, 63])
def test_anc_attention_plain_matches_jax(bf16, rtol, pos):
    """K3a: the port's plain version (the wrapper on CPU tensors) against
    the Pallas kernel interpreted, both reading poisoned caches: entries
    outside what the map selects would move the output by 1e4."""
    j, n, tp, d, h = 3, 6, 64, 128, 2
    rng = np.random.RandomState(pos)
    q = (rng.randn(n, d) * 0.3 * (d // h) ** -0.5).astype(np.float32)
    k = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    v = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    anc = beam_ancestry(rng, n, tp, j, pos)
    k_bad, v_bad = poison_unread(k, v, anc, j, pos)
    (qj, qt), (kj, kt), (vj, vt) = _both(q, bf16), _both(k_bad, bf16), _both(v_bad, bf16)
    out = decode_attn.decode_cache_attention(qt, kt, vt, pos, h,
                                             anc_local=torch.from_numpy(anc), beam=j)
    ref = jax_dca(qj, kj, vj, pos, h, anc_local=jnp.asarray(anc), beam=j, interpret=True)
    assert out.dtype == qt.dtype and out.shape == (n, d)
    scale = np.abs(_np(ref)).max()
    np.testing.assert_allclose(_np(out), _np(ref), atol=rtol * scale)
    # and it is the plain-row math on the gathered rows, unpoisoned
    rows = (np.arange(n) // j * j)[:, None] + anc
    t = np.arange(tp)[None, :]
    (_, kg), (_, vg) = _both(k[rows, t], bf16), _both(v[rows, t], bf16)
    plain = decode_attn.decode_cache_attention(qt, kg, vg, pos, h)
    np.testing.assert_array_equal(_np(out), _np(plain))


def test_anc_rows_are_clamped_into_the_group():
    """A map value outside [0, beam) reads the nearest row of the group,
    as the kernel clamps it: no row ever reads another group's cache."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((6, 128), (6, 16, 128), (6, 16, 128)))
    anc = torch.from_numpy(rng.randint(-4, 7, (6, 16)).astype(np.int32))
    out = decode_attn.decode_cache_attention(q, k, v, 9, 2, anc_local=anc, beam=3)
    ref = decode_attn.decode_cache_attention(q, k, v, 9, 2, anc_local=anc.clamp(0, 2),
                                             beam=3)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("bf16,rtol", [(False, 1e-5), (True, 1e-2)])
@pytest.mark.parametrize("pos", [0, 17, 49])
def test_shared_attention_plain_matches_jax(bf16, rtol, pos):
    """K3s: G groups of j distinct queries over one (Tp, d) cache each,
    keys past pos poisoned."""
    g, j, tp, d, h = 2, 4, 64, 128, 2
    rng = np.random.RandomState(100 + pos)
    q = (rng.randn(g * j, d) * 0.3 * (d // h) ** -0.5).astype(np.float32)
    k = (rng.randn(g, tp, d) * 0.3).astype(np.float32)
    v = (rng.randn(g, tp, d) * 0.3).astype(np.float32)
    k[:, pos + 1:], v[:, pos + 1:] = 1e9, 1e9
    (qj, qt), (kj, kt), (vj, vt) = _both(q, bf16), _both(k, bf16), _both(v, bf16)
    out = decode_attn.decode_shared_cache_attention(qt, kt, vt, pos, h, j)
    ref = jax_dsca(qj, kj, vj, pos, h, j, interpret=True)
    assert out.dtype == qt.dtype and out.shape == (g * j, d)
    scale = np.abs(_np(ref)).max()
    np.testing.assert_allclose(_np(out), _np(ref), atol=rtol * scale)


STEP_DIMS = dict(n_mels=80, n_audio_ctx=8, n_audio_state=64, n_audio_head=4,
                 n_audio_layer=2, n_vocab=128, n_text_ctx=32, n_text_state=64,
                 n_text_head=4, n_text_layer=2, adapter=True)


@pytest.mark.parametrize("ancestry", [True, False])
def test_decode_step_beam_groups_match_jax(ancestry):
    """whisper_decode_step(beam_groups=3) against JAX's XLA path for three
    steps, the ancestry map shuffled between steps as a beam reorder
    would (tests/test_decode_kernel_integration.py:38-84)."""
    b, beam = 2, 3
    jcfg, tcfg = jw.WhisperConfig(**STEP_DIMS), tw.WhisperConfig(**STEP_DIMS)
    params = jw.init_whisper_params(jax.random.PRNGKey(0), jcfg)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    rng = np.random.RandomState(0)
    enc = rng.randn(b, 8, 64).astype(np.float32) * 0.3
    toks = rng.randint(0, 128, (b * beam, 3)).astype(np.int32)
    perm = np.asarray([g * beam + (np.arange(beam) + 1) % beam for g in range(b)]).ravel()
    cross_j = jw.precompute_cross_kv(params, jcfg, jnp.asarray(enc))
    kv_j = jw.init_self_kv_cache(jcfg, batch=b * beam, max_len=16, ancestry=ancestry)
    kv_t = tw.init_self_kv_cache(tcfg, b * beam, 16, ancestry=ancestry)
    if ancestry:
        np.testing.assert_array_equal(kv_t["anc"].numpy(), np.asarray(kv_j["anc"]))
    with torch.inference_mode():
        cross_t = tw.precompute_cross_kv(model, torch.from_numpy(enc))
        for p in range(3):
            ref, kv_j = jw.whisper_decode_step(params, jcfg, jnp.asarray(toks[:, p]),
                                               jnp.int32(p), kv_j, cross_j, beam_groups=beam)
            out, kv_t = tw.whisper_decode_step(model, torch.from_numpy(toks[:, p]).long(),
                                               p, kv_t, cross_t, beam_groups=beam)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
            if ancestry:
                np.testing.assert_array_equal(kv_t["anc"].numpy(), np.asarray(kv_j["anc"]))
                kv_j["anc"] = kv_j["anc"][:, perm]
                kv_t["anc"] = kv_t["anc"][:, torch.from_numpy(perm)]


def test_top_k_breaks_ties_like_jax():
    rng = np.random.RandomState(0)
    x = np.round(rng.randn(4, 40), 0).astype(np.float32)  # many ties
    x[0, 5:] = -1e30
    x[1] = -np.inf
    x[1, 7] = 2.0
    x[2, :3] = [-0.0, 0.0, 0.0]
    vals, idx = top_k(torch.from_numpy(x), 6)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


def _table_steps(table: np.ndarray, k: int):
    """A synthetic decoder for both packages: logits of row n at position
    pos, given its current token c, are table[pos, n // k, c]."""
    def jax_step(cur, pos, state):
        rows = jnp.arange(cur.shape[0]) // k
        return jnp.asarray(table)[pos, rows, cur], state

    def torch_step(cur, pos, state):
        rows = torch.arange(cur.shape[0]) // k
        return torch.from_numpy(table)[pos, rows, cur], state

    return jax_step, torch_step


def _discard_table():
    """tests/test_composed_beam.py:172-213: an early ending beats a live
    path that only the length bonus inflates; eot below every other token
    afterwards, so every later step is dry (end detection stops the row)."""
    v, eot = 5, 0
    first = np.full((v,), -8.0, np.float32)
    first[eot], first[1] = -0.5, -0.6
    later = np.full((v,), -12.0, np.float32)
    later[1], later[eot] = -1e-3, -30.0
    table = np.broadcast_to(later, (64, 1, v, v)).copy()
    table[0] = first
    return table, dict(batch=1, vocab=v, beam_size=2, primer=(3,), max_steps=12,
                       eot=eot, max_pos=64, length_bonus=1.0)


def _random_table():
    """Two utterances, beam 3, a 7-token vocabulary with logits rounded to
    halves (ties everywhere) and eot (0) often near the top, so
    hypotheses end at different steps, slots die, and end detection stops
    one row while the other runs on."""
    rng = np.random.RandomState(3)
    v, eot = 7, 0
    table = np.round(rng.randn(16, 2, v, v) * 2, 0) / 2
    table[:, :, :, eot] += np.where(np.arange(16)[:, None, None] % 3 == 0, 3.0, -1.0)
    table[:, 1, :, eot] -= 4.0  # the second utterance ends later
    return table.astype(np.float32), dict(batch=2, vocab=v, beam_size=3, primer=(3, 4),
                                          max_steps=10, eot=eot, max_pos=64,
                                          length_bonus=0.25)


@pytest.mark.parametrize("loop", ["while", "scan"])
@pytest.mark.parametrize("end_detect", [True, False])
@pytest.mark.parametrize("make", [_discard_table, _random_table], ids=["discard", "random"])
def test_composed_beam_matches_jax_synthetic(make, end_detect, loop):
    """The dense loop under the same synthetic step in both packages:
    tokens, lengths and scores identical."""
    table, kw = make()
    jax_step, torch_step = _table_steps(table, kw["beam_size"])
    steps = []

    def counting_step(cur, pos, state):
        steps.append(pos)
        return torch_step(cur, pos, state)

    ref = jax_composed(jax_step, jnp.zeros((1, kw["batch"] * kw["beam_size"])),
                       use_end_detect=end_detect, loop=loop, **kw)
    out = composed_beam_decode(counting_step,
                               torch.zeros(1, kw["batch"] * kw["beam_size"]),
                               use_end_detect=end_detect, loop=loop, **kw)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    cap = len(kw["primer"]) + kw["max_steps"] + 1
    limit = len(kw["primer"]) + kw["max_steps"] - 1
    # the while loop exits once end detection has stopped every row: after
    # three dry steps (discard), or one step before the cap (random)
    early = {_discard_table: 4, _random_table: limit - 1}[make]
    assert len(steps) == (early if end_detect and loop == "while" else limit)
    if make is _random_table:
        assert (out[1] < cap).all()  # every row's best ended by a selected eot
    if make is _discard_table:
        assert int(out[1][0]) == (2 if end_detect else cap)


@pytest.fixture(scope="module")
def pair():
    params = jw.init_whisper_params(jax.random.PRNGKey(0), JCFG)
    model = tw.Whisper.from_state_dict(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, params), TCFG))
    # a large eot embedding row makes eot win some steps, so hypotheses end
    emb = np.array(params["decoder"]["token_emb"])
    emb[50257] *= 40.0
    params_eot = {**params, "decoder": {**params["decoder"], "token_emb": jnp.asarray(emb)}}
    model_eot = tw.Whisper.from_state_dict(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, params_eot), TCFG))
    return {"plain": (params, model), "eot": (params_eot, model_eot)}


@pytest.mark.parametrize("weights", ["plain", "eot"])
@pytest.mark.parametrize("loop", ["while", "scan"])
@pytest.mark.parametrize("beam", [3, 5])
def test_beam_decode_matches_jax(pair, beam, loop, weights):
    """beam_decode on the same weights and encoder output, B = 2, 12 steps:
    tokens and lengths exact, scores within 1e-5, for the ancestry map and
    for the physical cache gather."""
    params, model = pair[weights]
    enc = np.random.RandomState(1).randn(2, 32, 64).astype(np.float32)
    ref = jax_beam(params, JCFG, jnp.asarray(enc), beam_size=beam, max_steps=12,
                   length_bonus=0.1, loop=loop)
    for ancestry in (True, False):
        tok, lens, scores = beam_decode(model, torch.from_numpy(enc), beam_size=beam,
                                        max_steps=12, length_bonus=0.1, loop=loop,
                                        ancestry=ancestry)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref[2]), rtol=1e-5)
    if weights == "eot":
        assert (lens < 5 + 12 + 1).any()  # some hypothesis ended before the cap


def test_speech2text_beam_matches_jax(pair):
    params, model = pair["eot"]
    audio = np.random.RandomState(0).randn(2, 64 * 160).astype(np.float32) * 0.1
    lengths = np.array([64 * 160, 50 * 160])
    ref = JaxSpeech2Text(params, JaxASRConfig(whisper=JCFG, use_specaug=False),
                         beam_size=4, max_steps=8, length_bonus=0.2)(audio, lengths=lengths)
    out = Speech2Text(model, ASRModelConfig(whisper=TCFG), beam_size=4, max_steps=8,
                      length_bonus=0.2)(audio, lengths=lengths)
    assert [r.tokens for r in out] == [r.tokens for r in ref]
    assert [r.text for r in out] == [r.text for r in ref]
    np.testing.assert_allclose([r.score for r in out], [r.score for r in ref], rtol=1e-5)


def test_decode_cli_beam_yaml_matches_jax_cli(tmp_path, monkeypatch):
    """bin.decode with a decode YAML of beam_size 3 and penalty 0.5 (the
    length bonus) against agacs_tpu.bin.decode on the same checkpoint and
    data dir: the same hypotheses, and the same scores (read from each
    CLI's Speech2Text)."""
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
    (tmp_path / "decode.yaml").write_text(yaml.safe_dump(
        {"beam_size": 3, "ctc_weight": 0.0, "lm_weight": 0.0, "penalty": 0.5}))
    params = init_asr_params(jax.random.PRNGKey(3),
                             jax_model_config(conf, compute_dtype=jnp.float32))
    save_pytree(str(tmp_path / "p.params.npz"), params)
    rng = np.random.RandomState(5)
    wavs = {}
    for u, n in {"u1": 20000, "u2": 9000}.items():
        wavs[u] = str(tmp_path / f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(str(tmp_path / "wav.scp"), wavs)
    write_scp(str(tmp_path / "text"), {"u1": "hello 你好", "u2": "world"})

    scores = {}
    for name, mod in (("jax", jax_cli), ("torch", cli)):
        base = mod.Speech2Text

        class Recording(base):
            def __call__(self, *a, _name=name, **k):
                out = super().__call__(*a, **k)
                scores.setdefault(_name, []).extend(r.score for r in out)
                assert self.beam_size == 3 and self.length_bonus == 0.5
                return out

        monkeypatch.setattr(mod, "Speech2Text", Recording)
    common = ["--config", str(tmp_path / "config.yaml"),
              "--params", str(tmp_path / "p.params.npz"), "--data_dir", str(tmp_path),
              "--decode_config", str(tmp_path / "decode.yaml"),
              "--compute_dtype", "float32", "--max_steps", "6"]
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    cli.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert (read_trn(str(tmp_path / "torch" / "hyp.trn"))
            == read_trn(str(tmp_path / "jax" / "hyp.trn")))
    assert len(scores["torch"]) == 2
    np.testing.assert_allclose(scores["torch"], scores["jax"], rtol=1e-5)


@pytest.mark.cuda
def test_beam_kernels_match_plain_on_card():
    """K3a and K3s against their plain versions (float32, same bf16 inputs)
    on the card at the beam shapes, with chip_smoke.py's sharp, shifted
    inputs, poisoned cache entries and bound of 1e-2 x max |plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    chip_smoke.check_k3a(torch.device("cuda"), g, timed=False)
    chip_smoke.check_k3s(torch.device("cuda"), g, timed=False)
