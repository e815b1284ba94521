"""The port's PE (gated dual-QK) attention against agacs_tpu on the CPU: the
K3-PE / K3a-PE plain version against the Pallas kernel interpreted, `mha`'s
PE branch (non-causal and causal, with its columns and maps), the PE
encoder and teacher-forced decoder, greedy and beam decoding, 3-step
`whisper_pe` / `freeze_decoder_pe` trajectories against `make_train_step`,
the PE checkpoint both ways, the freeze presets, the bf16 cast of the
frozen leaves (`cast_frozen_params`), the TMECS PE recipes, and the train
CLI's PE checkpoint decoded by both decode CLIs. Same numpy-seeded inputs
and JAX-initialized weights on both sides, float32 unless stated.

Tolerances: decode attention 1e-6 abs (JAX's own bound for its kernel);
attention outputs, scores, logits and columns 1e-5 (float32 summation
order); greedy and beam tokens exact, beam scores 1e-5 relative;
trajectories 1e-5 relative per step; the bf16 cast and the bf16 decoder
input bit for bit."""

import os
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.beam import beam_decode as jax_beam
from agacs_tpu.decode.greedy import greedy_decode as jax_greedy
from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops.decode_attn import decode_cache_attention as jax_dca
from agacs_tpu.text import WhisperTokenIdConverter, WhisperTokenizer
from agacs_tpu.train.checkpoint import load_pytree_like
from agacs_tpu.train.freeze import trainable_mask
from agacs_tpu.train.optim import OptimConfig as JOptimConfig
from agacs_tpu.train.trainer import build_tx, cast_frozen_params, create_train_state
from agacs_tpu.train.trainer import make_train_step as jax_make_train_step
from agacs_tpu_torch.adapt import cs_loss
from agacs_tpu_torch.decode.beam import beam_decode
from agacs_tpu_torch.decode.greedy import greedy_decode
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import jax_leaf, numpy_from_params, params_from_numpy
from agacs_tpu_torch.ops import decode_attn
from agacs_tpu_torch.train.freeze import apply_freeze, trainable_names
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=64,
            n_text_head=4, n_text_layer=2)
# the TMECS PE recipes' two layouts: PE in both stacks, PE in the decoder
FLAGS = {"pe": dict(pe_attention=True), "pedecoder": dict(pe_decoder=True)}
TMECS = os.path.join(os.path.dirname(__file__), "..", "recipes", "tmecs", "conf")
PE_RECIPES = ["train_asr_whisper_small_pe.yaml", "train_asr_whisper_small_cs_loss_pe.yaml",
              "train_asr_whisper_small_pedecoder.yaml",
              "train_asr_whisper_small_pedecoder_csloss.yaml"]


def _tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def _flat(params) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module", params=sorted(FLAGS))
def pair(request):
    """(flags name, JAX params, JAX cfg, port cfg, port model) on the same
    JAX-initialized weights."""
    jcfg = jw.WhisperConfig(**DIMS, **FLAGS[request.param])
    tcfg = tw.WhisperConfig(**DIMS, **FLAGS[request.param])
    params = jw.init_whisper_params(jax.random.PRNGKey(11), jcfg)
    model = tw.Whisper.from_state_dict(tcfg, params_from_numpy(_tree(params), tcfg))
    return request.param, params, jcfg, tcfg, model


# ---------------------------------------------------------------------------
# K3-PE / K3a-PE plain version
# ---------------------------------------------------------------------------


def _ancestry(rng, n, tp, j, pos):
    own = np.arange(n)[:, None] % j
    anc = np.where(rng.rand(n, tp) < 0.2, own, (own + rng.randint(1, j, (n, tp))) % j)
    anc[:, pos] = own[:, 0]
    return anc.astype(np.int32)


@pytest.mark.parametrize("pos", [0, 9, 31])
@pytest.mark.parametrize("beam", [1, 4])
def test_pe_decode_attention_plain_matches_jax(beam, pos):
    """PE scores (1 - g)·q.k + g·q_cs.k_cs with distinct per-head gates
    (0 and 1 among them), plain rows and through an ancestry map whose
    unread entries (k, k_cs and v alike) are poisoned, against
    `decode_cache_attention(..., interpret=True)`."""
    rng = np.random.RandomState(10 * beam + pos)
    n, tp, d, h = 8, 32, 64, 4
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    q, k, v, q_cs, k_cs = mk(n, d), mk(n, tp, d), mk(n, tp, d), mk(n, d), mk(n, tp, d)
    gate = np.concatenate([[0.0, 1.0], rng.rand(h - 2)]).astype(np.float32)
    anc = None
    if beam > 1:
        anc = _ancestry(rng, n, tp, beam, pos)
        read = np.zeros((n, tp), bool)
        read[(np.arange(n) // beam * beam)[:, None] + anc, np.arange(tp)[None, :]] = True
        k[~read], k_cs[~read], v[~read] = 0.0, 0.0, 1e4
    kw = dict(anc_local=anc, beam=beam)
    ref = jax_dca(*(jnp.asarray(x) for x in (q, k, v)), pos, h, interpret=True,
                  q_cs=jnp.asarray(q_cs), k_cs=jnp.asarray(k_cs), gate=jnp.asarray(gate),
                  **{key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
                     for key, x in kw.items()})
    out = decode_attn.decode_cache_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), pos, h,
        anc_local=None if anc is None else torch.from_numpy(anc), beam=beam,
        q_cs=torch.from_numpy(q_cs), k_cs=torch.from_numpy(k_cs), gate=torch.from_numpy(gate))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_pe_and_int8_together_raise():
    q, kv = torch.zeros(4, 128), torch.zeros(4, 16, 128)
    with pytest.raises(ValueError):
        decode_attn.decode_cache_attention(q, kv, kv, 3, 2, q_cs=q, k_cs=kv,
                                           gate=torch.zeros(2), k_scale=torch.ones(128),
                                           v_scale=torch.ones(128))


# ---------------------------------------------------------------------------
# the PE model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_mha_pe_matches_jax(causal):
    """A PE attention block against JAX `mha(pe=True)`: the encoder form
    (non-causal), and the decoder's causal form with its language columns
    before and after the softmax and the full post-softmax map."""
    jcfg = jw.WhisperConfig(**DIMS, pe_attention=True)
    tcfg = tw.WhisperConfig(**DIMS, pe_attention=True)
    params = jw.init_whisper_params(jax.random.PRNGKey(5), jcfg)
    model = tw.Whisper.from_state_dict(tcfg, params_from_numpy(_tree(params), tcfg))
    stack = "decoder" if causal else "encoder"
    p = jax.tree.map(lambda a: a[1], params[stack]["blocks"]["attn"])
    attn = getattr(model, stack).blocks[1].attn
    x = np.random.RandomState(2).randn(2, 12, 64).astype(np.float32)
    ref, aux = jw.mha(p, jnp.asarray(x), causal=causal, n_head=4, pe=True,
                      lang_cols=(1, 3) if causal else None, full_scores=causal)
    with torch.no_grad():
        if causal:
            out, taux = attn.causal_self(torch.from_numpy(x), lang_cols=True,
                                         full_scores=True)
        else:
            out, taux = attn(torch.from_numpy(x)), {}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert set(taux) == set(aux)
    for key in taux:
        r = np.asarray(aux[key])
        assert np.array_equal(np.isinf(taux[key].numpy()), np.isinf(r)), key
        fin = np.isfinite(r)
        np.testing.assert_allclose(taux[key].numpy()[fin], r[fin], atol=1e-5, err_msg=key)


def test_pe_encoder_and_decoder_match_jax(pair):
    """The encoder and the teacher-forced decoder: logits, the language
    columns (p_cols always: the CS loss of a PE decoder reads them) and
    the post-softmax maps."""
    name, params, jcfg, _, model = pair
    rng = np.random.RandomState(3)
    mel = rng.randn(2, 64, 80).astype(np.float32)
    tokens = np.concatenate([np.full((2, 1), 50258), rng.randint(0, 51865, (2, 8))], 1)
    enc_ref = jw.whisper_encode(params, jcfg, jnp.asarray(mel))
    with torch.no_grad():
        enc = tw.whisper_encode(model, torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), atol=1e-5)
    feats = np.asarray(enc_ref)
    ref, ref_aux = jw.whisper_decode(params, jcfg, jnp.asarray(tokens, jnp.int32),
                                     jnp.asarray(feats), collect_lang_cols=True,
                                     collect_full_maps=True)
    with torch.no_grad():
        out, aux = tw.whisper_decode(model, torch.from_numpy(tokens), torch.from_numpy(feats),
                                     collect_lang_cols=True, collect_full_maps=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert set(aux) == set(ref_aux) == {"qk_cols", "p_cols", "maps"}
    for key in aux:
        r = np.asarray(ref_aux[key])
        assert aux[key].shape == r.shape, key
        fin = np.isfinite(r)
        assert np.array_equal(np.isfinite(aux[key].numpy()), fin), key
        np.testing.assert_allclose(aux[key].numpy()[fin], r[fin], atol=1e-5, err_msg=key)


def test_pe_greedy_token_exact(pair):
    _, params, jcfg, _, model = pair
    enc = np.random.RandomState(4).randn(2, 32, 64).astype(np.float32)
    ref_tok, ref_len = jax_greedy(params, jcfg, jnp.asarray(enc), max_steps=10)
    tok, lens = greedy_decode(model, torch.from_numpy(enc), max_steps=10)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))


def test_pe_beam_matches_jax(pair):
    """Beam 3, B = 2, 10 steps: tokens and lengths exact and scores within
    1e-5 relative, for the ancestry map and for the physical gather (which
    reorders k_cs with k and v)."""
    _, params, jcfg, _, model = pair
    enc = np.random.RandomState(6).randn(2, 32, 64).astype(np.float32)
    ref = jax_beam(params, jcfg, jnp.asarray(enc), beam_size=3, max_steps=10,
                   length_bonus=0.1)
    for ancestry in (True, False):
        tok, lens, scores = beam_decode(model, torch.from_numpy(enc), beam_size=3,
                                        max_steps=10, length_bonus=0.1, ancestry=ancestry)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref[2]), rtol=1e-5)


def test_pe_self_kv_cache_has_k_cs(pair):
    name, _, _, tcfg, _ = pair
    cache = tw.init_self_kv_cache(tcfg, 3, 20)
    assert set(cache) == {"k", "v", "k_cs"}
    assert len(cache["k_cs"]) == 2 and cache["k_cs"][0].shape == (3, 32, 64)


# ---------------------------------------------------------------------------
# checkpoints, freezing, the bf16 cast
# ---------------------------------------------------------------------------


def test_pe_checkpoint_round_trip(pair, tmp_path):
    """A PE npz both ways: the port's flat mapping has JAX's keys and
    values (query_cs, key_cs without bias, the gate), converts back
    exactly, and JAX's `load_pytree_like` reads it."""
    _, params, _, tcfg, model = pair
    flat = numpy_from_params(model.state_dict())
    ref = _flat(params)
    assert set(flat) == set(ref)
    assert "decoder/blocks/attn/gate" in flat and "decoder/blocks/attn/key_cs/b" not in flat
    for key, val in ref.items():
        np.testing.assert_array_equal(flat[key], val, err_msg=key)
    back = params_from_numpy(flat, tcfg)
    for key, t in model.state_dict().items():
        torch.testing.assert_close(back[key], t.float(), rtol=0, atol=0)
    np.savez(str(tmp_path / "port.params.npz"), **flat)
    loaded = load_pytree_like(str(tmp_path / "port.params.npz"), params)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("preset", ["whisper_pe", "freeze_decoder_pe", "whisper_pe_adapter",
                                    "none", "all_param"])
def test_freeze_presets_select_the_jax_leaves_on_a_pe_tree(pair, preset):
    """The presets pick JAX's leaves on a PE tree; under `whisper_pe` the
    gate, whose path has no "cs", stays frozen (as in the reference)."""
    _, params, _, _, model = pair
    mask = trainable_mask(params, preset)
    want = {".".join(str(k.key) for k in path)
            for path, m in jax.tree_util.tree_flatten_with_path(mask)[0] if m}
    got = {jax_leaf(n)[0].replace("/", ".") for n in trainable_names(model, preset)}
    assert got == want
    if preset == "whisper_pe":
        assert got and all("_cs." in n for n in got)


def _off_grid(params, rng):
    """Layer norms and PE gates drawn off the bf16 grid (the JAX init has
    them at 1/0 and uniform(0, 1) f32, which the cast may leave exact)."""
    def draw(path, leaf):
        key = "/".join(str(k.key) for k in path)
        if key.endswith("gate") or "ln" in key.split("/")[-2]:
            return jnp.asarray(rng.randn(*leaf.shape).astype(np.float32))
        return leaf
    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("preset", ["whisper_pe", "freeze_decoder_pe", "adapter"])
def test_cast_frozen_matches_jax_bit_for_bit(preset):
    """After `apply_freeze` + `cast_frozen_(bfloat16)` every frozen leaf
    (linears, conv stem, layer norms, embeddings, the PE gate) equals JAX's
    `cast_frozen_params` leaf bit for bit, and what trains stays float32;
    the bf16 decoder input of the teacher-forced forward and of a decode
    step (emb + pos summed in bf16) equals JAX's."""
    rng = np.random.RandomState(7)
    dims = dict(DIMS, pe_attention=True, adapter=True)
    params = _off_grid(jw.init_whisper_params(jax.random.PRNGKey(2), jw.WhisperConfig(**dims)),
                       rng)
    mask = trainable_mask(params, preset)
    ref = _flat(cast_frozen_params(params, mask))
    tcfg = tw.WhisperConfig(**dims, compute_dtype=torch.bfloat16)
    model = tw.Whisper.from_state_dict(tcfg, params_from_numpy(_tree(params), tcfg),
                                       param_dtype=torch.float32)
    apply_freeze(model, preset)
    model.cast_frozen_(torch.bfloat16)
    out = numpy_from_params(model.state_dict())
    assert set(out) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(out[key], val.astype(np.float32), err_msg=key)
    stored = {jax_leaf(n)[0]: p.dtype for n, p in model.named_parameters()}
    for key, val in ref.items():
        assert stored[key] == (torch.bfloat16 if val.dtype == jnp.bfloat16
                               else torch.float32), key
    assert stored["decoder/blocks/attn/gate"] == torch.bfloat16
    tokens = rng.randint(0, 51865, (2, 7))
    dec = cast_frozen_params(params, mask)["decoder"]
    want = (dec["token_emb"][tokens] + dec["pos_emb"][:7]).astype(jnp.bfloat16)
    got = model.decoder.embed(torch.from_numpy(tokens), slice(0, 7))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    want = (dec["token_emb"][tokens[:, 0]] + dec["pos_emb"][5]).astype(jnp.bfloat16)
    got = model.decoder.embed(torch.from_numpy(tokens[:, 0]), 5)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_layer_norm_reads_a_bf16_affine_as_jax():
    """A layer norm whose frozen affine is stored bf16 computes y * w + b in
    float32 (JAX's promotion), then rounds to the input's bf16."""
    rng = np.random.RandomState(8)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    ln = tw.LayerNorm(64)
    ln.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    ln.weight.data, ln.bias.data = ln.weight.data.bfloat16(), ln.bias.data.bfloat16()
    with torch.no_grad():
        out = ln(torch.from_numpy(x).bfloat16())
    ref = jw.layer_norm(jnp.asarray(x, jnp.bfloat16),
                        {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b, jnp.bfloat16)})
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2 ** -7 * np.abs(np.asarray(ref, np.float32)).max())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

N_FRAMES = 40  # mel frames -> 20 encoder positions
T_TEXT = 11
TEXTS = ["我们 go", "hello 你", "好 ok", "去 shop", "that 是 right", "嗯 ok lah"]


def _batch(tok, seed, b=2):
    conv = WhisperTokenIdConverter(tok)
    rng = np.random.RandomState(seed)
    text = np.full((b, T_TEXT), -1, np.int32)
    for i in range(b):
        ids = conv.tokens2ids(tok.text2tokens(TEXTS[(seed * b + i) % len(TEXTS)]))
        text[i, : len(ids[:T_TEXT])] = ids[:T_TEXT]
    ys_in = np.concatenate([np.full((b, 1), 50258, np.int32),
                            np.where(text == -1, 50257, text)], axis=1)
    return {"speech": (rng.randn(b, N_FRAMES * 160) * 0.05).astype(np.float32),
            "speech_lengths": np.full((b,), N_FRAMES * 160, np.int32),
            "text": text, "cs_labels": cs_loss.attention_target_labels(ys_in, tok)}


@pytest.mark.parametrize("flags, preset", [("pe", "whisper_pe"),
                                           ("pedecoder", "freeze_decoder_pe")])
def test_pe_trajectory_matches_jax(flags, preset):
    """3 optimizer steps with the CS loss (over the PE decoder's p_cols),
    clip 1.0, WarmupLR with 3 warmup steps, against JAX's make_train_step
    with the same preset: loss, loss_att, loss_cs, acc and grad norm per
    step within 1e-5 relative; frozen parameters (the gate among them)
    untouched; the final parameters JAX's."""
    dims = dict(DIMS, n_audio_ctx=N_FRAMES // 2, n_text_ctx=16, **FLAGS[flags])
    jcfg = jasr.ASRModelConfig(whisper=jw.WhisperConfig(**dims), use_specaug=False,
                               cs_weight=0.5)
    tcfg = asr_model.ASRModelConfig(whisper=tw.WhisperConfig(**dims), use_specaug=False,
                                    cs_weight=0.5)
    params = jasr.init_asr_params(jax.random.PRNGKey(9), jcfg)
    tx, mask = build_tx(params, JOptimConfig(warmup_steps=3), freeze_preset=preset)
    jstep = jax_make_train_step(jcfg, tx, accum_grad=1, trainable_mask=mask, donate=False)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))

    model = tw.Whisper.from_state_dict(tcfg.whisper,
                                       params_from_numpy(_tree(params), tcfg.whisper))
    trainable = apply_freeze(model, preset)
    opt, sched = build_optimizer(trainable, OptimConfig(warmup_steps=3))
    step = make_train_step(model, tcfg, opt, sched, grad_clip=1.0)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    assert any(n.endswith("attn.gate") for n in frozen)
    tok = WhisperTokenizer()
    for i in range(3):
        batch = _batch(tok, seed=i)
        state, ref = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tb["text"] = tb["text"].long()
        stats = step([tb])
        for k in ("loss", "loss_att", "loss_cs", "acc", "grad_norm"):
            np.testing.assert_allclose(float(stats[k]), float(ref[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert float(stats["loss_cs"]) > 0
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    out = numpy_from_params(model.state_dict())
    for key, leaf in _flat(state.params).items():
        np.testing.assert_allclose(out[key], leaf, atol=2e-6, err_msg=key)


def test_lid_ce_with_a_pe_decoder_raises_as_in_jax():
    with pytest.raises(ValueError):
        jasr.ASRModelConfig(whisper=jw.WhisperConfig(**DIMS, pe_decoder=True),
                            cs_weight=0.1, cs_loss_type="lid_ce")
    with pytest.raises(ValueError):
        asr_model.ASRModelConfig(whisper=tw.WhisperConfig(**DIMS, pe_decoder=True),
                                 cs_weight=0.1, cs_loss_type="lid_ce")


@pytest.mark.parametrize("recipe", PE_RECIPES)
def test_tmecs_pe_recipes_match_jax(recipe):
    """The four TMECS PE recipes resolve to the JAX package's PE flags,
    losses and freeze preset."""
    from agacs_tpu.utils import config as jconfig
    from agacs_tpu_torch.utils import config as tconfig

    d = tconfig.load_yaml(os.path.join(TMECS, recipe))
    ref = jconfig.model_config_from_dict(d, compute_dtype=jnp.float32)
    out = tconfig.model_config_from_dict(d, compute_dtype=torch.float32)
    for field in ("pe_attention", "pe_encoder", "pe_decoder", "adapter"):
        assert getattr(out.whisper, field) == getattr(ref.whisper, field), field
    assert out.whisper.part("decoder").pe_attention
    assert (out.cs_weight, out.cs_loss_type, out.src_layer) == (
        ref.cs_weight, ref.cs_loss_type, ref.src_layer)
    assert tconfig.trainer_config_from_dict(d).freeze_param == d["freeze_param"] in (
        "whisper_pe", "freeze_decoder_pe")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _write_data_dir(path, utts, seed):
    path.mkdir()
    rng = np.random.RandomState(seed)
    for u, (n, _) in utts.items():
        with wave.open(str(path / f"{u}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.randn(n) * 3000).astype(np.int16).tobytes())
    (path / "wav.scp").write_text("".join(f"{u} {path / u}.wav\n" for u in utts))
    (path / "text").write_text("".join(f"{u} {t}\n" for u, (_, t) in utts.items()))


def test_pe_train_cli_checkpoint_decodes_token_exact_with_jax_cli(tmp_path):
    """bin.train on the TMECS cs_loss_pe recipe (whisper `test` dims,
    float32, CPU, one epoch) writes a PE checkpoint; JAX's decode CLI and
    the port's decode it to the same hypotheses."""
    from agacs_tpu.bin import decode as jax_cli
    from agacs_tpu.eval.scoring import read_trn
    from agacs_tpu_torch.bin import decode, train

    _write_data_dir(tmp_path / "train", {f"t{i}": (8000 + 1000 * i, TEXTS[i])
                                         for i in range(4)}, seed=0)
    _write_data_dir(tmp_path / "valid", {"v0": (9000, "hello 你好"), "v1": (7000, "ok")},
                    seed=1)
    exp = tmp_path / "exp"
    out = train.main([
        "--config", os.path.join(TMECS, "train_asr_whisper_small_cs_loss_pe.yaml"),
        "--train_dir", str(tmp_path / "train"), "--valid_dir", str(tmp_path / "valid"),
        "--exp_dir", str(exp), "--max_epoch", "1", "--batch_bins", "40000",
        "--compute_dtype", "float32", "--device", "cpu", "--override",
        "encoder_conf.whisper_model=test", "decoder_conf.whisper_model=test",
        "accum_grad=1", "keep_nbest_models=1"])
    assert np.isfinite(out["history"][1]["train"]["loss"])
    assert out["history"][1]["train"]["loss_cs"] > 0
    with np.load(out["ave"]) as ave:
        assert "encoder/blocks/attn/query_cs/w" in ave.files
        assert "decoder/blocks/attn/gate" in ave.files
    common = ["--config", str(exp / "config.yaml"), "--params", out["ave"],
              "--data_dir", str(tmp_path / "valid"), "--compute_dtype", "float32",
              "--max_steps", "6"]
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    decode.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    hyps = read_trn(str(tmp_path / "torch" / "hyp.trn"))
    assert hyps == read_trn(str(tmp_path / "jax" / "hyp.trn")) and len(hyps) == 2


def test_pe_count_heads_and_dump_attention_clis_match_jax(tmp_path):
    """bin.count_heads (the mass criterion over the PE decoder's
    post-softmax columns) and bin.dump_attention (post-softmax maps) on a
    JAX-written pedecoder checkpoint, against JAX's CLIs."""
    import json

    import yaml

    from agacs_tpu.bin.count_heads import main as jax_count
    from agacs_tpu.bin.dump_attention import main as jax_dump
    from agacs_tpu.data.io import write_scp, write_wav
    from agacs_tpu.models.asr_model import init_asr_params
    from agacs_tpu.train.checkpoint import save_pytree
    from agacs_tpu.utils.config import model_config_from_dict as jax_model_config
    from agacs_tpu_torch.bin.count_heads import main as count
    from agacs_tpu_torch.bin.dump_attention import main as dump

    conf = {"encoder": "whisper", "encoder_conf": {"whisper_model": "test"},
            "decoder_conf": {"whisper_model": "test", "pe_whisper": True}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(conf))
    save_pytree(str(tmp_path / "p.params.npz"),
                init_asr_params(jax.random.PRNGKey(12),
                                jax_model_config(conf, compute_dtype=jnp.float32)))
    rng = np.random.RandomState(13)
    wavs = {}
    for u, n in {"u1": 20000, "u2": 9000}.items():
        wavs[u] = str(tmp_path / f"{u}.wav")
        write_wav(wavs[u], (rng.randn(n) * 0.1).astype(np.float32))
    write_scp(str(tmp_path / "wav.scp"), wavs)
    write_scp(str(tmp_path / "text"), {"u1": "我们 go 你好", "u2": "hello"})
    common = ["--config", str(tmp_path / "config.yaml"), "--data_dir", str(tmp_path),
              "--params", str(tmp_path / "p.params.npz")]
    jax_count(common + ["--compute_dtype", "float32", "--output", str(tmp_path / "j.json")])
    count(common + ["--compute_dtype", "float32", "--output", str(tmp_path / "t.json"),
                    "--device", "cpu"])
    assert (json.loads((tmp_path / "t.json").read_text())["counts"]
            == json.loads((tmp_path / "j.json").read_text())["counts"])
    jax_dump(common + ["--output_dir", str(tmp_path / "jd")])
    dump(common + ["--output_dir", str(tmp_path / "td"), "--device", "cpu"])
    for u in ("u1", "u2"):
        ref, out = np.load(tmp_path / "jd" / f"{u}.npz"), np.load(tmp_path / "td" / f"{u}.npz")
        assert np.isfinite(out["maps"]).all()  # post-softmax: masked entries are 0
        np.testing.assert_allclose(out["maps"], ref["maps"], atol=1e-5)


@pytest.mark.cuda
def test_pe_kernels_match_plain_on_card():
    """K3-PE and K3a-PE against their plain version on the card, with
    chip_smoke.py's inputs and bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    chip_smoke.check_k3pe(torch.device("cuda"), torch.Generator().manual_seed(0),
                          timed=False)
