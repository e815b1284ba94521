"""`--resume` (agacs_tpu_torch) three ways, on the CPU at the `test` size:

  * the port alone: a run of 2 epochs and a run of 1 epoch resumed to 2
    write bit-identical params, optimizer state, step and counters, and
    the same history (times apart), with SpecAug on;
  * JAX writes, the port resumes: the optimizer state is loaded exactly
    and the next 2 steps (SpecAug and dropout off) match JAX's own
    continuation within 1e-5 relative (loss, grad norm; trained leaves
    within 2e-6 absolute, as `test_trajectory_matches_jax`);
  * the port writes, JAX's `CheckpointManager.resume` loads it: names,
    shapes and dtypes are JAX's own, and JAX's next step matches the
    port's within the same tolerances.
"""

import json
import os
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.text import WhisperTokenIdConverter, WhisperTokenizer
from agacs_tpu.adapt import cs_loss as jcs
from agacs_tpu.train.checkpoint import CheckpointManager as JaxManager
from agacs_tpu.train.checkpoint import _flatten_with_names
from agacs_tpu.train.optim import OptimConfig as JOptimConfig
from agacs_tpu.train.trainer import build_tx, create_train_state
from agacs_tpu.train.trainer import make_train_step as jax_make_train_step
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import numpy_from_params, params_from_numpy
from agacs_tpu_torch.train.checkpoint import CheckpointManager, TrainState, opt_state_keys
from agacs_tpu_torch.train.freeze import apply_freeze
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "seame", "conf",
                      "train_asr_whisper_small_adapter_csloss_2stage.yaml")
N_FRAMES = 40
DIMS = dict(n_mels=80, n_audio_ctx=N_FRAMES // 2, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=3, adapter=True)
TEXTS = ["我们 go", "hello 你", "好 ok", "去 shop", "that 是 right", "嗯 ok lah",
         "我 think so", "走 了 bye"]
HISTORY = {1: {"train": {"loss": 3.0}, "valid": {"acc": 0.25}}}


@pytest.fixture(scope="module")
def tok():
    return WhisperTokenizer()


def _batch(tok, seed, b=2):
    conv = WhisperTokenIdConverter(tok)
    rng = np.random.RandomState(seed)
    text = np.full((b, 11), -1, np.int32)
    for i in range(b):
        ids = conv.tokens2ids(tok.text2tokens(TEXTS[(seed * b + i) % len(TEXTS)]))
        text[i, : len(ids[:11])] = ids[:11]
    ys_in = np.concatenate([np.full((b, 1), 50258, np.int32),
                            np.where(text == -1, 50257, text)], axis=1)
    return {"speech": (rng.randn(b, N_FRAMES * 160) * 0.05).astype(np.float32),
            "speech_lengths": np.full((b,), N_FRAMES * 160, np.int32), "text": text,
            "cs_labels": jcs.attention_target_labels(ys_in, tok)}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["text"] = out["text"].long()
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _setup(seed, optim=JOptimConfig(warmup_steps=3), estimate_c=True):
    """JAX and port configs, JAX params, tx and state, and a port model on
    the same weights with its optimizer and TrainState (seed 5)."""
    jcfg = jasr.ASRModelConfig(whisper=jw.WhisperConfig(**DIMS), use_specaug=False,
                               cs_weight=0.5, estimate_c=estimate_c)
    tcfg = asr_model.ASRModelConfig(whisper=tw.WhisperConfig(**DIMS), use_specaug=False,
                                    cs_weight=0.5, estimate_c=estimate_c)
    params = jasr.init_asr_params(jax.random.PRNGKey(seed), jcfg)
    tx, mask = build_tx(params, optim, freeze_preset="adapter")
    jstate = create_train_state(params, tx, jax.random.PRNGKey(1))
    model = tw.Whisper.from_state_dict(
        tcfg.whisper, params_from_numpy(jax.tree.map(np.asarray, params), tcfg.whisper))
    trainable = apply_freeze(model, "adapter")
    ocfg = OptimConfig(**{f: getattr(optim, f) for f in OptimConfig.__dataclass_fields__})
    opt, sched = build_optimizer(trainable, ocfg)
    state = TrainState(opt, sched, {n: p for n, p in model.named_parameters()
                                    if p.requires_grad}, ocfg, torch.Generator(), seed=5)
    return jcfg, tcfg, tx, mask, jstate, model, state


def _port_step(model, tcfg, state):
    step = make_train_step(model, tcfg, state.optimizer, state.scheduler,
                           grad_clip=state.optim_cfg.grad_clip, nonfinite=state.nonfinite)

    def run(batch):
        stats = step([_torch_batch(batch)])
        state.step += 1
        state.nonfinite = int(stats["grad_nonfinite_total"])
        return stats

    return run


def _close(stats, ref, what):
    for k in ("loss", "loss_cs", "grad_norm"):
        np.testing.assert_allclose(float(stats[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=f"{what} {k}")


def _same_params(model, jparams, atol):
    out = numpy_from_params(model.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = "/".join(str(k.key) for k in path)
        np.testing.assert_allclose(out[key], np.asarray(leaf), atol=atol, err_msg=key)


@pytest.mark.parametrize("optim", [
    JOptimConfig(), JOptimConfig(grad_clip=0), JOptimConfig(optim="adam"),
    JOptimConfig(scheduler="constant")], ids=["adamw", "no_clip", "adam", "constant"])
def test_opt_state_names_shapes_dtypes_are_jaxs(optim, tok):
    """The port's optimizer npz holds exactly JAX's leaves for the chain the
    config makes (the names derived from the preset and the config)."""
    jcfg, tcfg, tx, mask, jstate, model, state = _setup(0, optim)
    jstep = jax_make_train_step(jcfg, tx, trainable_mask=mask, donate=False)
    run = _port_step(model, tcfg, state)
    for i in range(2):
        jstate, _ = jstep(jstate, _jax_batch(_batch(tok, i)))
        run(_batch(tok, i))
    ref = dict(_flatten_with_names(jstate.opt_state))
    out = state.opt_to_numpy(numpy_from_params)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape and out[k].dtype == ref[k].dtype, k
    keys = opt_state_keys(state.optim_cfg)
    for k in (f"{keys['adam']}/.count", keys["schedule"], keys["notfinite"]):
        assert int(out[k]) == int(ref[k]), k
    assert f"{keys['adam']}/.mu/estimated_c_val" in out


def test_jax_files_resume_in_the_port(tok, tmp_path, caplog):
    jcfg, tcfg, tx, mask, jstate, model, state = _setup(2)
    jstep = jax_make_train_step(jcfg, tx, trainable_mask=mask, donate=False)
    for i in range(2):
        jstate, _ = jstep(jstate, _jax_batch(_batch(tok, i)))
    JaxManager(str(tmp_path)).save_epoch(1, jstate, HISTORY)
    mgr = CheckpointManager(str(tmp_path),
                            from_numpy=lambda f, **kw: params_from_numpy(f, tcfg.whisper, **kw))
    with caplog.at_level("INFO"):
        start, history = mgr.resume(model, state)
    assert (start, history, state.step, state.nonfinite) == (2, HISTORY, 2, 0)
    assert "reseeded from seed + 1" in caplog.text
    assert torch.equal(state.generator.get_state(),
                       torch.Generator().manual_seed(6).get_state())
    ref = dict(_flatten_with_names(jstate.opt_state))
    out = state.opt_to_numpy(numpy_from_params)
    for k in ref:  # loaded exactly
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert state.scheduler.last_epoch == 2
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        1e-3 * 3 ** 0.5 * min(3 ** -0.5, 3 * 3 ** -1.5), rel=1e-12)
    _same_params(model, jstate.params, atol=0)
    run = _port_step(model, tcfg, state)
    for i in range(2, 4):
        jstate, ref_stats = jstep(jstate, _jax_batch(_batch(tok, i)))
        _close(run(_batch(tok, i)), ref_stats, f"step {i}")
    _same_params(model, jstate.params, atol=2e-6)


def test_port_files_resume_in_jax(tok, tmp_path):
    jcfg, tcfg, tx, mask, jstate, model, state = _setup(3)
    jstep = jax_make_train_step(jcfg, tx, trainable_mask=mask, donate=False)
    run = _port_step(model, tcfg, state)
    for i in range(2):
        run(_batch(tok, i))
    CheckpointManager(str(tmp_path)).save_epoch(1, model, HISTORY, state)
    meta = json.loads((tmp_path / "checkpoint_meta.json").read_text())
    assert list(meta)[:4] == ["epoch", "step", "rng", "history"] and meta["step"] == 2
    assert meta["rng"] == np.asarray(jax.random.PRNGKey(6)).tolist()
    ref_names = dict(_flatten_with_names(jstate.opt_state))
    with np.load(tmp_path / "checkpoint.opt.npz") as data:
        assert {k: (data[k].shape, data[k].dtype) for k in data.files} == {
            k: (v.shape, v.dtype) for k, v in ref_names.items()}
    with np.load(tmp_path / "checkpoint.params.npz") as data:
        assert {k: (data[k].shape, data[k].dtype) for k in data.files} == {
            k: (v.shape, v.dtype) for k, v in _flatten_with_names(jstate.params)}
    jstate, start, history = JaxManager(str(tmp_path)).resume(jstate)
    assert (start, history, int(jstate.step)) == (2, HISTORY, 2)
    _same_params(model, jstate.params, atol=0)
    out = state.opt_to_numpy(numpy_from_params)
    for k, v in _flatten_with_names(jstate.opt_state):
        np.testing.assert_array_equal(v, out[k], err_msg=k)
    for i in range(2, 4):
        jstate, ref_stats = jstep(jstate, _jax_batch(_batch(tok, i)))
        _close(run(_batch(tok, i)), ref_stats, f"step {i}")
    _same_params(model, jstate.params, atol=2e-6)


def test_a_missing_moment_raises(tok, tmp_path):
    _, tcfg, _, _, _, model, state = _setup(4)
    CheckpointManager(str(tmp_path)).save_epoch(1, model, HISTORY, state)
    with np.load(tmp_path / "checkpoint.opt.npz") as data:
        kept = {k: data[k] for k in data.files if "adapter_mlp/up/w" not in k}
    np.savez(tmp_path / "checkpoint.opt.npz", **kept)
    mgr = CheckpointManager(str(tmp_path),
                            from_numpy=lambda f, **kw: params_from_numpy(f, tcfg.whisper, **kw))
    with pytest.raises(KeyError, match="adapter_mlp"):
        mgr.resume(model, state)


def _write_dir(path, utts, seed):
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


CONFORMER = [os.path.join(REPO, "recipes", "seame", "conf", "train_asr_conformer.yaml"),
             "encoder_conf.output_size=128", "encoder_conf.attention_heads=2",
             "encoder_conf.linear_units=256", "encoder_conf.num_blocks=2",
             "decoder_conf.attention_heads=2", "decoder_conf.linear_units=256",
             "decoder_conf.num_blocks=1", "normalize_conf.stats_file=null"]


@pytest.mark.parametrize("trunk", ["float32", "int8", "conformer"])
def test_resumed_cli_run_is_bit_identical(trunk, tmp_path):
    """bin.train for 2 epochs, against 1 epoch then --resume to 2: the same
    checkpoint.params.npz, checkpoint.opt.npz, meta step and history, bit
    for bit (SpecAug on, accum 2; the int8 trunk's plain kernels; the
    conformer at d 128 with dropout and Adam over every parameter)."""
    from agacs_tpu_torch.bin import train

    _write_dir(tmp_path / "train", {f"t{i}": (8000 + 1000 * i, TEXTS[i]) for i in range(6)},
               seed=0)
    _write_dir(tmp_path / "valid", {"v0": (9000, "hello 你好")}, seed=1)
    config, extra = RECIPE, ["encoder_conf.whisper_model=test",
                             "decoder_conf.whisper_model=test"]
    if trunk == "int8":
        extra.append("freeze_quant=int8")
    elif trunk == "conformer":
        config, *extra = CONFORMER

    def run(exp, epochs, *flags):
        return train.main([
            "--config", config, "--train_dir", str(tmp_path / "train"), "--valid_dir",
            str(tmp_path / "valid"), "--exp_dir", str(tmp_path / exp), "--max_epoch",
            str(epochs), "--batch_bins", "30000", "--compute_dtype", "float32", "--device",
            "cpu", "--num_att_plot", "0", *flags, "--override", "accum_grad=2",
            "keep_nbest_models=2", *extra])

    whole = run("whole", 2)
    run("cut", 1)
    resumed = run("cut", 2, "--resume")
    for name in ("checkpoint.params.npz", "checkpoint.opt.npz"):
        with np.load(tmp_path / "whole" / name) as a, np.load(tmp_path / "cut" / name) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (name, k)
    metas = [json.loads((tmp_path / d / "checkpoint_meta.json").read_text())
             for d in ("whole", "cut")]
    assert metas[0]["step"] == metas[1]["step"] > 0
    assert metas[0]["torch_generator"] == metas[1]["torch_generator"]

    def untimed(h):
        return {e: {ph: {k: v for k, v in d.items() if not k.endswith("_time")}
                    for ph, d in phases.items()} for e, phases in h.items()}

    assert untimed(whole["history"]) == untimed(resumed["history"])
    assert sorted(resumed["history"]) == [1, 2]
    assert "iter_time" in resumed["history"][2]["train"]
    if trunk == "int8":
        with np.load(tmp_path / "cut" / "checkpoint.params.npz") as a:
            assert any(k.endswith("w_q") and a[k].dtype == np.int8 for k in a.files)
