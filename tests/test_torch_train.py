"""The port's training path (agacs_tpu_torch) against agacs_tpu on the CPU,
at float32 and tiny dims: the same JAX-initialized weights (through the
converter) and the same numpy-seeded inputs through both packages.

Tolerances: single ops (SpecAug, the losses, the CS loss) agree to
float32 summation order, 1e-5; the decoder's logits and language columns
and the forward's losses pass through a few layers and the 51865-wide
log-softmax, 1e-4 relative; the 4-step adapter trajectory compares the
loss and the global gradient norm of each step, 1e-5 relative (measured
<= 4e-7: AdamW in torch and optax round in different orders, and the
drift compounds over the steps)."""

import json
import os
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.adapt import cs_loss as jcs
from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops.specaug import SpecAugConfig as JSpecAugConfig
from agacs_tpu.ops.specaug import specaug as jax_specaug
from agacs_tpu.text import WhisperTokenIdConverter, WhisperTokenizer
from agacs_tpu.train import losses as jlosses
from agacs_tpu.train.checkpoint import load_pytree_like, save_pytree
from agacs_tpu.train.freeze import trainable_mask
from agacs_tpu.train.optim import OptimConfig as JOptimConfig
from agacs_tpu.train.optim import warmup_lr as jax_warmup_lr
from agacs_tpu.train.trainer import build_tx, create_train_state
from agacs_tpu.train.trainer import make_train_step as jax_make_train_step
from agacs_tpu_torch.adapt import cs_loss
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import jax_leaf, numpy_from_params, params_from_numpy
from agacs_tpu_torch.ops import specaug as tspecaug
from agacs_tpu_torch.train import losses
from agacs_tpu_torch.train.freeze import PRESETS, apply_freeze, trainable_names
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer, warmup_lr
from agacs_tpu_torch.train.trainer import make_eval_step, make_train_step

torch.set_num_threads(1)

N_FRAMES = 40  # mel frames -> 20 encoder positions
DIMS = dict(n_mels=80, n_audio_ctx=N_FRAMES // 2, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=3, adapter=True)
T_TEXT = 11
TEXTS = ["我们 go", "hello 你", "好 ok", "去 shop", "that 是 right", "嗯 ok lah",
         "我 think so", "走 了 bye"]
RECIPE = os.path.join(os.path.dirname(__file__), "..", "recipes", "seame", "conf",
                      "train_asr_whisper_small_adapter_csloss_2stage.yaml")


@pytest.fixture(scope="module")
def tok():
    return WhisperTokenizer()


def _cfgs(**kw):
    jcfg = jasr.ASRModelConfig(whisper=jw.WhisperConfig(**DIMS), use_specaug=False, **kw)
    tcfg = asr_model.ASRModelConfig(whisper=tw.WhisperConfig(**DIMS), use_specaug=False,
                                    **kw)
    return jcfg, tcfg


def _model(params, tcfg, preset=None):
    model = tw.Whisper.from_state_dict(
        tcfg.whisper, params_from_numpy(jax.tree.map(np.asarray, params), tcfg.whisper))
    if preset is not None:
        apply_freeze(model, preset)
    return model


def _batch(tok, seed, b=2):
    """numpy batch: noise speech, code-switched text, cs labels."""
    conv = WhisperTokenIdConverter(tok)
    rng = np.random.RandomState(seed)
    text = np.full((b, T_TEXT), -1, np.int32)
    for i in range(b):
        ids = conv.tokens2ids(tok.text2tokens(TEXTS[(seed * b + i) % len(TEXTS)]))
        text[i, : len(ids[:T_TEXT])] = ids[:T_TEXT]
    ys_in = np.where(text == -1, 50257, text)
    ys_in = np.concatenate([np.full((b, 1), 50258, np.int32), ys_in], axis=1)
    return {
        "speech": (rng.randn(b, N_FRAMES * 160) * 0.05).astype(np.float32),
        "speech_lengths": np.full((b,), N_FRAMES * 160, np.int32),
        "text": text,
        "cs_labels": cs_loss.attention_target_labels(ys_in, tok),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["text"] = out["text"].long()
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# ops and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,warp", [(60, True), (60, False), (9, True)])
def test_specaug_matches_jax_with_its_draws(t, warp):
    """JAX's own draws (its key splits replayed) handed to the port."""
    cfg = dict(apply_time_warp=warp, time_warp_window=5, freq_mask_width_range=(0, 30),
               num_freq_mask=2, time_mask_width_range=(0, 40), num_time_mask=2)
    spec = np.random.RandomState(t).randn(3, t, 80).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jax_specaug(key, jnp.asarray(spec), JSpecAugConfig(**cfg))

    k_warp, k_freq, k_time = jax.random.split(key, 3)
    draws = tspecaug.SpecAugDraws()
    if warp and t - 5 > 5:
        k1, k2 = jax.random.split(k_warp)
        c = jax.random.randint(k1, (3,), 5, t - 5)
        draws.warp_center = torch.from_numpy(np.asarray(c))
        draws.warp_to = draws.warp_center + torch.from_numpy(
            np.asarray(jax.random.randint(k2, (3,), -5, 5))) + 1
    for name, k, (lo, hi), size in (("freq", k_freq, (0, 30), 80), ("time", k_time, (0, 40), t)):
        k1, k2 = jax.random.split(k)
        setattr(draws, f"{name}_widths",
                torch.from_numpy(np.asarray(jax.random.randint(k1, (3, 2, 1), lo, hi))[..., 0]))
        setattr(draws, f"{name}_starts", torch.from_numpy(
            np.asarray(jax.random.randint(k2, (3, 2, 1), 0, max(1, size - hi)))[..., 0]))
    out = tspecaug.apply_specaug(torch.from_numpy(spec), draws)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert tspecaug.SpecAugConfig.from_dict(cfg) == tspecaug.SpecAugConfig(**cfg)


def test_specaug_draws_follow_the_config():
    g = torch.Generator().manual_seed(0)
    cfg = tspecaug.SpecAugConfig()
    d = tspecaug.draw_specaug(g, 64, 300, 80, cfg)
    assert ((d.warp_center >= 5) & (d.warp_center < 295)).all()
    assert ((d.warp_to - d.warp_center >= -4) & (d.warp_to - d.warp_center <= 5)).all()
    assert d.freq_widths.shape == (64, 2) and int(d.freq_widths.max()) < 30
    assert int(d.time_starts.max()) < 300 - 40
    spec = torch.randn(64, 300, 80)
    out = tspecaug.specaug(torch.Generator().manual_seed(0), spec, cfg)
    assert out.shape == spec.shape and (out == 0).any()


@pytest.mark.parametrize("normalize_length", [False, True])
def test_sos_eos_label_smoothing_accuracy_match_jax(normalize_length):
    rng = np.random.RandomState(0)
    ys = rng.randint(0, 500, (3, 7)).astype(np.int32)
    ys[0, 5:] = -1
    ys[2, 2:] = -1
    ref_in, ref_out = jlosses.add_sos_eos(jnp.asarray(ys), 499, 498)
    ys_in, ys_out = losses.add_sos_eos(torch.from_numpy(ys).long(), 499, 498)
    np.testing.assert_array_equal(ys_in.numpy(), np.asarray(ref_in))
    np.testing.assert_array_equal(ys_out.numpy(), np.asarray(ref_out))
    logits = rng.randn(3, 8, 500).astype(np.float32) * 3
    ref = jlosses.label_smoothing_loss(jnp.asarray(logits), ref_out, 0.1, -1,
                                       normalize_length)
    out = losses.label_smoothing_loss(torch.from_numpy(logits), ys_out, 0.1, -1,
                                      normalize_length)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)
    logits[0, 0, int(ref_out[0, 0])] = 100.0  # one sure hit
    np.testing.assert_allclose(
        float(losses.th_accuracy(torch.from_numpy(logits), ys_out)),
        float(jlosses.th_accuracy(jnp.asarray(logits), ref_out)), rtol=1e-6)


def test_attention_target_labels_match_jax(tok):
    conv = WhisperTokenIdConverter(tok)
    rows = [[50258] + conv.tokens2ids(tok.text2tokens(t)) for t in TEXTS[:4] + ["ok , 好 !"]]
    width = max(map(len, rows)) + 2
    ys_in = np.full((len(rows), width), 50257, np.int32)
    for i, r in enumerate(rows):
        ys_in[i, : len(r)] = r
    out = cs_loss.attention_target_labels(ys_in, tok)
    np.testing.assert_array_equal(out, jcs.attention_target_labels(ys_in, tok))
    assert {cs_loss.LANG_ZH, cs_loss.LANG_EN, cs_loss.LANG_BOTH, cs_loss.LANG_PAD} <= set(
        out.ravel().tolist())
    np.testing.assert_array_equal(cs_loss.REFERENCE_50PCT_HEAD_MASK,
                                  jcs.REFERENCE_50PCT_HEAD_MASK)


@pytest.mark.parametrize("layer_offset", [0, 1, 3])
def test_cs_attention_loss_matches_jax(layer_offset):
    rng = np.random.RandomState(layer_offset)
    n_l, b, h, t = 4, 3, 4, 9
    cols = rng.randn(n_l, b, h, t, 2).astype(np.float32)
    cols[..., 0, :] = -np.inf  # rows 0-1: causally masked columns
    cols[..., 1, 1] = -np.inf
    labels = rng.randint(0, 5, (b, t)).astype(np.int8)
    head_mask = (rng.rand(n_l, h) > 0.3).astype(np.float32)
    head_mask[1] = 0.0  # a head-masked layer
    cols[2, 1] = 0.0    # heads whose rows are all zero (the guarded 0/0)
    labels[1] = cs_loss.LANG_PAD
    ref = jcs.cs_attention_loss(jnp.asarray(cols), jnp.asarray(labels),
                                jnp.asarray(head_mask), 0.6, layer_offset)
    out = cs_loss.cs_attention_loss(torch.from_numpy(cols), torch.from_numpy(labels),
                                    torch.from_numpy(head_mask), 0.6, layer_offset)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# model: teacher-forced decoder, forward, nll
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs(cs_weight=0.5)
    params = jasr.init_asr_params(jax.random.PRNGKey(0), jcfg)
    return params, jcfg, tcfg, _model(params, tcfg)


@pytest.mark.parametrize("src_layer", [0, 1])
def test_whisper_decode_matches_jax(pair, src_layer):
    params, jcfg, _, model = pair
    rng = np.random.RandomState(src_layer)
    tokens = np.concatenate([np.full((2, 1), 50258), rng.randint(0, 51865, (2, 8))], 1)
    enc = rng.randn(2, 20, 64).astype(np.float32)
    ref, ref_aux = jw.whisper_decode(params, jcfg.whisper, jnp.asarray(tokens, jnp.int32),
                                     jnp.asarray(enc), src_layer=src_layer,
                                     collect_lang_cols=True)
    with torch.no_grad():
        out, aux = tw.whisper_decode(model, torch.from_numpy(tokens), torch.from_numpy(enc),
                                     src_layer=src_layer, collect_lang_cols=True)
    assert out.dtype == torch.float32 and out.shape == (2, 9, 51865)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    ref_cols = np.asarray(ref_aux["qk_cols"])
    assert aux["qk_cols"].shape == ref_cols.shape == (3 - src_layer, 2, 4, 9, 2)
    assert np.array_equal(np.isinf(aux["qk_cols"].numpy()), np.isinf(ref_cols))
    fin = np.isfinite(ref_cols)
    np.testing.assert_allclose(aux["qk_cols"].numpy()[fin], ref_cols[fin], atol=1e-4)


def test_forward_matches_jax(pair, tok):
    params, jcfg, tcfg, model = pair
    batch = _batch(tok, seed=1)
    ref_loss, ref_stats = jasr.forward(params, jcfg, _jax_batch(batch), train=False)
    with torch.no_grad():
        loss, stats = asr_model.forward(model, tcfg, _torch_batch(batch), train=False)
    assert set(stats) == set(ref_stats) == {"loss", "loss_att", "loss_cs", "acc"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(ref_stats[k]), rtol=1e-4, err_msg=k)
    assert float(stats["loss_cs"]) > 0  # the 3-layer decoder has a non-early layer
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)


def test_nll_matches_jax(pair):
    params, jcfg, tcfg, model = pair
    rng = np.random.RandomState(4)
    ys = rng.randint(0, 51865, (2, 6)).astype(np.int32)
    ys[1, 4:] = -1
    enc = rng.randn(2, 20, 64).astype(np.float32)
    ref = jasr.nll(params, jcfg, jnp.asarray(enc), jnp.asarray(ys))
    with torch.no_grad():
        out = asr_model.nll(model, tcfg, torch.from_numpy(enc), torch.from_numpy(ys).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4)


# ---------------------------------------------------------------------------
# freeze, schedule, trajectory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", sorted(PRESETS) + [["decoder.blocks", "encoder.conv1"]],
                         ids=str)
def test_freeze_presets_select_the_jax_leaves(pair, preset):
    params, _, _, model = pair
    mask = trainable_mask(params, preset)
    flat, _ = jax.tree_util.tree_flatten_with_path(mask)
    want = {".".join(str(k.key) for k in path) for path, m in flat if m}
    got = {jax_leaf(n)[0].replace("/", ".") for n in trainable_names(model, preset)}
    assert got == want
    if preset == "adapter":
        assert got and all("adapter" in n for n in got)


def test_warmup_lr_matches_jax():
    ref = jax_warmup_lr(1e-3, 500)
    opt, sched = build_optimizer([torch.nn.Parameter(torch.zeros(2))],
                                 OptimConfig(lr=1e-3, warmup_steps=500))
    for count in range(0, 1200, 7):
        np.testing.assert_allclose(1e-3 * warmup_lr(500)(count), float(ref(count)),
                                   rtol=1e-6)
    lrs = []
    for _ in range(3):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [float(ref(c)) for c in range(3)], rtol=1e-6)


def test_trajectory_matches_jax(tok):
    """4 optimizer steps of accum 2 (adapter preset, CS loss, clip 1.0,
    WarmupLR with 4 warmup steps so the lr moves), against JAX's
    make_train_step + build_tx(freeze_preset="adapter")."""
    jcfg, tcfg = _cfgs(cs_weight=0.5)
    params = jasr.init_asr_params(jax.random.PRNGKey(7), jcfg)
    tx, mask = build_tx(params, JOptimConfig(warmup_steps=4), freeze_preset="adapter")
    jstep = jax_make_train_step(jcfg, tx, accum_grad=2, trainable_mask=mask, donate=False)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))

    model = _model(params, tcfg, preset="adapter")
    trainable = [p for p in model.parameters() if p.requires_grad]
    opt, sched = build_optimizer(trainable, OptimConfig(warmup_steps=4))
    step = make_train_step(model, tcfg, opt, sched, grad_clip=1.0)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}

    for i in range(4):
        micro = [_batch(tok, seed=2 * i + a) for a in range(2)]
        stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]}
        state, ref = jstep(state, stacked)
        stats = step([_torch_batch(m) for m in micro])
        for k in ("loss", "loss_att", "loss_cs", "acc", "grad_norm"):
            np.testing.assert_allclose(float(stats[k]), float(ref[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert int(stats["grad_nonfinite_total"]) == int(ref["grad_nonfinite_total"]) == 0
        assert float(ref["grad_norm"]) > 1.0 or i > 0  # the first step clips
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    out = numpy_from_params(model.state_dict())
    want = jax.tree_util.tree_flatten_with_path(state.params)[0]
    for path, leaf in want:
        key = "/".join(str(k.key) for k in path)
        np.testing.assert_allclose(out[key], np.asarray(leaf), atol=2e-6, err_msg=key)


def test_nonfinite_step_is_skipped_and_counted(pair, tok):
    params, _, tcfg, _ = pair
    model = _model(params, tcfg, preset="adapter")
    trainable = [p for p in model.parameters() if p.requires_grad]
    opt, sched = build_optimizer(trainable, OptimConfig(warmup_steps=4))
    step = make_train_step(model, tcfg, opt, sched)
    before = [p.detach().clone() for p in trainable]
    bad = _torch_batch(_batch(tok, seed=0))
    bad["speech"][0, 5] = float("nan")
    stats = step([bad])
    assert not torch.isfinite(stats["grad_norm"]) and int(stats["grad_nonfinite_total"]) == 1
    assert all(torch.equal(a, p) for a, p in zip(before, trainable))
    assert sched.last_epoch == 0 and opt.param_groups[0]["lr"] == pytest.approx(
        1e-3 * warmup_lr(4)(0))
    stats = step([_torch_batch(_batch(tok, seed=0))])
    assert int(stats["grad_nonfinite_total"]) == 1 and sched.last_epoch == 1


def test_bf16_model_keeps_float32_trainable_masters(pair, tok):
    """The trunk frozen and stored bf16, the adapters float32 masters: a
    WarmupLR first step (lr 2e-6 with 500 warmup steps) changes them,
    which bf16 storage could not resolve."""
    params, _, tcfg, _ = pair
    cfg = tw.WhisperConfig(**{**DIMS, "compute_dtype": torch.bfloat16})
    bcfg = asr_model.ASRModelConfig(whisper=cfg, use_specaug=False, cs_weight=0.5)
    model = tw.Whisper.from_state_dict(
        cfg, params_from_numpy(jax.tree.map(np.asarray, params), cfg),
        param_dtype=torch.float32)
    trainable = apply_freeze(model, "adapter")
    model.cast_frozen_(torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in trainable)
    assert model.encoder.blocks[0].mlp[0].weight.dtype == torch.bfloat16
    assert model.decoder.blocks[0].attn.query.weight.dtype == torch.bfloat16
    opt, sched = build_optimizer(trainable, OptimConfig(warmup_steps=500))
    before = [p.detach().clone() for p in trainable]
    stats = make_train_step(model, bcfg, opt, sched)([_torch_batch(_batch(tok, seed=3))])
    assert torch.isfinite(stats["loss"])
    assert all(not torch.equal(a, p) for a, p in zip(before, trainable))


def test_trained_token_embedding_reaches_the_logits(pair, tok):
    """Preset `none` trains the embedding table: the head's weight is cast
    in the forward, and the decode step after an update reads the new one."""
    params, _, tcfg, _ = pair
    model = _model(params, tcfg, preset="none")
    assert model.decoder.token_embedding.weight.requires_grad
    opt, sched = build_optimizer(list(model.parameters()), OptimConfig(warmup_steps=1))
    make_train_step(model, tcfg, opt, sched)([_torch_batch(_batch(tok, seed=5))])
    dec = model.decoder
    with torch.no_grad():
        torch.testing.assert_close(dec.logits_w(), dec.token_embedding.weight,
                                   rtol=0, atol=0)
        enc = torch.randn(1, 20, 64)
        kv = tw.init_self_kv_cache(model.cfg, 1, 4)
        step_logits, _ = tw.whisper_decode_step(model, torch.tensor([50258]), 0, kv,
                                                tw.precompute_cross_kv(model, enc))
        full, _ = tw.whisper_decode(model, torch.tensor([[50258]]), enc)
    torch.testing.assert_close(step_logits, full[:, 0], rtol=1e-4, atol=1e-4)


def test_eval_step_returns_preds(pair, tok):
    _, _, tcfg, model = pair
    stats, (ys_hat, ys_out) = make_eval_step(model, tcfg)(_torch_batch(_batch(tok, seed=6)))
    assert ys_hat.shape == ys_out.shape == (2, T_TEXT + 1)
    assert 0.0 <= float(stats["acc"]) <= 1.0


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------


def test_numpy_from_params_round_trip_and_jax_load(pair, tmp_path):
    params, jcfg, tcfg, model = pair
    sd = model.state_dict()
    flat = numpy_from_params(sd)
    back = params_from_numpy(flat, tcfg.whisper)
    assert set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    path = str(tmp_path / "port.params.npz")
    np.savez(path, **flat)
    loaded = load_pytree_like(path, params)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    save_pytree(str(tmp_path / "jax.params.npz"), params)
    with np.load(str(tmp_path / "jax.params.npz")) as ref:
        assert set(ref.files) == set(flat)


def test_recipe_training_configs_match_jax():
    """The stage-2 recipe's model_conf / specaug / optimizer / trainer
    fields resolve to the JAX package's values."""
    import dataclasses

    from agacs_tpu.utils import config as jconfig
    from agacs_tpu_torch.utils import config as tconfig

    d = tconfig.apply_overrides(tconfig.load_yaml(RECIPE), ["model_conf.lsm_weight=0.2"])
    assert d == jconfig.apply_overrides(jconfig.load_yaml(RECIPE),
                                        ["model_conf.lsm_weight=0.2"])
    ref = jconfig.model_config_from_dict(d, compute_dtype=jnp.float32)
    out = tconfig.model_config_from_dict(d, compute_dtype=torch.float32)
    for f in dataclasses.fields(out):
        if f.name not in ("whisper", "specaug", "audio"):
            assert getattr(out, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(out.specaug) == dataclasses.asdict(ref.specaug)
    assert out.lsm_weight == 0.2 and out.cs_weight == 0.01 and out.use_specaug
    assert dataclasses.asdict(tconfig.optim_config_from_dict(d)) == dataclasses.asdict(
        jconfig.optim_config_from_dict(d))
    tref = jconfig.trainer_config_from_dict(d)
    for f in dataclasses.fields(tconfig.TrainerConfig):
        assert getattr(tconfig.trainer_config_from_dict(d), f.name) == getattr(tref, f.name)


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


def test_train_cli_then_decode_cli(tmp_path):
    """bin.train on a tiny data dir with the stage-2 recipe (whisper `test`
    dims, float32, CPU), then bin.decode on its n-best average."""
    from agacs_tpu_torch.bin import decode, train

    _write_data_dir(tmp_path / "train", {f"t{i}": (8000 + 1000 * i, TEXTS[i])
                                         for i in range(6)}, seed=0)
    _write_data_dir(tmp_path / "valid", {"v0": (9000, "hello 你好"), "v1": (7000, "ok")},
                    seed=1)
    exp = tmp_path / "exp"
    out = train.main([
        "--config", RECIPE, "--train_dir", str(tmp_path / "train"),
        "--valid_dir", str(tmp_path / "valid"), "--exp_dir", str(exp),
        "--max_epoch", "3", "--batch_bins", "40000", "--compute_dtype", "float32",
        "--device", "cpu", "--override", "encoder_conf.whisper_model=test",
        "decoder_conf.whisper_model=test", "accum_grad=2", "keep_nbest_models=2"])
    assert sorted(out["history"]) == [1, 2, 3]
    for ep in out["history"].values():
        assert np.isfinite(ep["train"]["loss"]) and "loss_cs" in ep["train"]
        assert ep["train"]["grad_nonfinite_total"] == 0 and "cer" in ep["valid"]
    assert len(list(exp.glob("*epoch.params.npz"))) == 2
    assert (exp / "valid.acc.ave.params.npz").exists() and (exp / "config.yaml").exists()
    assert json.loads((exp / "train_history.json").read_text()).keys() == {"1", "2", "3"}
    res = decode.main(["--config", str(exp / "config.yaml"),
                       "--params", str(exp / "valid.acc.ave.params.npz"),
                       "--data_dir", str(tmp_path / "valid"),
                       "--output_dir", str(tmp_path / "dec"), "--compute_dtype", "float32",
                       "--device", "cpu", "--max_steps", "4"])
    assert set(res["hyps"]) == {"v0", "v1"}
    assert (tmp_path / "dec" / "hyp.trn").exists()
