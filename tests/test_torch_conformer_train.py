"""The port's conformer training (agacs_tpu_torch) against agacs_tpu on the
CPU: `conformer_asr.forward` (the hybrid CTC/attention loss, both conv
norms, BN in train mode) with every parameter's gradient, a bf16 forward
through K5's and K4's paths (JAX's kernels interpreted), dropout, the BN
recalibration probe, the recipe's SpecAug, and the MVN statistics file
(interCTC and the optimizer trajectory: test_torch_conformer_trajectory.py). Inputs are made with numpy from a seed and JAX-initialized weights
are handed to both packages.

Tolerances, each with its reason:
  * losses and accuracy in float32 1e-5 relative (float32 layers summed in
    another order);
  * gradients in float32 1e-4 x max |grad| of the parameter (the float32
    rounding of a loss of ~100 spread through the backward; the CTC head's
    gradients carry the dense-vs-streaming difference of JAX's CPU path);
    parameters whose gradient is zero in exact arithmetic (the key biases:
    softmax ignores a per-row shift; the depthwise conv bias under batch
    statistics: the batch mean absorbs it) 5e-6 x the largest gradient of
    the model (both sides' float32 noise);
  * bf16: the loss 1e-2 relative (bf16 activations rounded at other places);
  * BN statistics 1e-6 x max |ref| (float32 means over the same values).
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import conformer as jconf
from agacs_tpu.models import conformer_asr as jasr
from agacs_tpu.ops.specaug import SpecAugConfig as JSpecAugConfig
from agacs_tpu.utils.config import load_yaml as jax_load_yaml
from agacs_tpu.utils.config import task_from_dict as jax_task_from_dict
from agacs_tpu_torch.models import conformer as tconf
from agacs_tpu_torch.models import conformer_asr as tasr
from agacs_tpu_torch.models.checkpoint import conformer_params_from_numpy, numpy_from_conformer_params
from agacs_tpu_torch.ops import relpos_flash, vocab_lse
from agacs_tpu_torch.utils.config import load_yaml, task_from_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "seame", "conf", "train_asr_conformer.yaml")
# 2 blocks, d 128, 2 heads (d_head 64: K5's envelope holds), a small
# vocabulary with sos/eos inside it
RAW = {
    "encoder": "conformer",
    "encoder_conf": {"output_size": 128, "attention_heads": 2, "linear_units": 256,
                     "num_blocks": 2, "cnn_module_kernel": 15},
    "decoder": "transformer",
    "decoder_conf": {"attention_heads": 2, "linear_units": 256, "num_blocks": 2},
    "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1},
    "normalize": "global_mvn",
    "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
}
V, SOS, EOS = 300, 298, 299
# 3 s and 2.5 s: 93 and 77 encoder frames
LENS = np.array([48000, 40000])
ZERO_GRAD = ("attn/k/b", "src_attn/k/b", "self_attn/k/b")


def _cfgs(conv_norm="layer", dtype="float32", blocks=2, **model_conf):
    raw = {**RAW, "encoder_conf": {**RAW["encoder_conf"], "conv_norm": conv_norm,
                                   "num_blocks": blocks},
           "model_conf": {**RAW["model_conf"], **model_conf}}
    out = []
    for task, dt in ((jax_task_from_dict, jnp), (task_from_dict, torch)):
        c = task(raw, compute_dtype=getattr(dt, dtype)).cfg
        out.append(dataclasses.replace(
            c, decoder=dataclasses.replace(c.decoder, vocab_size=V), sos=SOS, eos=EOS,
            use_specaug=False, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0)))
    return tuple(out)


def _params(jcfg, seed=0):
    """JAX params as numpy, with non-trivial MVN statistics."""
    tree = jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(seed),
                                                                   jcfg))
    rng = np.random.RandomState(seed + 1)
    tree["mvn"] = {"mean": rng.randn(80).astype(np.float32),
                   "std": (0.5 + rng.rand(80)).astype(np.float32)}
    return tree


def _batch(seed=0):
    """numpy batch: noise speech (3 s and 2.5 s), token rows with a repeat."""
    rng = np.random.RandomState(seed)
    speech = (rng.randn(2, int(LENS.max())) * 0.1).astype(np.float32)
    speech[1, LENS[1]:] = 0.0
    text = np.full((2, 7), -1, np.int64)
    text[0, :5] = rng.randint(1, 290, 5)
    text[0, 2] = text[0, 1]
    text[1, :3] = rng.randint(1, 290, 3)
    return {"speech": speech, "speech_lengths": LENS.copy(), "text": text}


def _jb(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(tree, tcfg):
    model = tasr.ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg),
                                              param_dtype=torch.float32)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _jax_value_and_grad(jcfg, tree, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jasr.forward(p, jcfg, b, train=True, rng=jax.random.PRNGKey(0)),
        has_aux=True))
    return fn(jax.tree.map(jnp.asarray, tree), _jb(batch))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check_grads(model, tcfg, ref_grads):
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update({n: torch.zeros_like(b) for n, b in model.named_buffers()})
    got, want = numpy_from_conformer_params(grads, tcfg), _flat(ref_grads)
    scale = max(np.abs(v).max() for v in want.values())
    for key, g in got.items():
        if key.startswith("mvn/") or "running_" in key:
            continue  # buffers in the port
        r = want[key]
        exact_zero = key.endswith(ZERO_GRAD) or (key.endswith("conv/dw_b")
                                                 and tcfg.encoder.conv_norm == "batch")
        bound = 5e-6 * scale if exact_zero else 1e-4 * np.abs(r).max()
        err = np.abs(g - r).max()
        assert err <= bound, f"d {key}: max |err| {err} > {bound}"


@pytest.mark.parametrize("conv_norm", ["layer", "batch"])
def test_forward_and_gradients_match_jax(conv_norm):
    jcfg, tcfg = _cfgs(conv_norm)
    tree, batch = _params(jcfg), _batch()
    (ref, ref_stats), ref_grads = _jax_value_and_grad(jcfg, tree, batch)
    model = _model(tree, tcfg)
    loss, stats = tasr.forward(model, tcfg, _tb(batch), train=True,
                               generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert set(stats) == set(ref_stats) == {"loss", "loss_att", "loss_ctc", "acc"}
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]), rtol=1e-5, err_msg=k)
    _check_grads(model, tcfg, ref_grads)


def test_bf16_forward_through_the_kernel_paths_matches_jax(monkeypatch):
    """bf16 at T 93/77: the rel-pos attention takes K5's path and the CTC
    head K4's (the plain versions here, JAX's Pallas kernels interpreted)."""
    monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret")
    monkeypatch.setenv("AGACS_VOCAB_LSE", "interpret")
    jcfg, tcfg = _cfgs("layer", dtype="bfloat16")
    tree, batch = _params(jcfg, seed=3), _batch(seed=3)
    ref, ref_stats = jasr.forward(jax.tree.map(jnp.asarray, tree), jcfg, _jb(batch),
                                  train=True, rng=jax.random.PRNGKey(0))
    model = _model(tree, tcfg)
    loss, stats = tasr.forward(model, tcfg, _tb(batch), train=True,
                               generator=torch.Generator().manual_seed(0))
    loss.backward()
    for k in ("loss", "loss_att", "loss_ctc"):
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]), rtol=1e-2, err_msg=k)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert relpos_flash.LAUNCHES == relpos_flash.BWD_LAUNCHES == 0
    assert vocab_lse.FWD_LAUNCHES == vocab_lse.DX_LAUNCHES == vocab_lse.DW_LAUNCHES == 0


def test_dropout_keep_rate_scaling_and_draws():
    x = torch.ones(100_000)
    out = tconf.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.9))
    again = tconf.dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert not torch.equal(out, tconf.dropout(x, 0.1, torch.Generator().manual_seed(1)))
    assert tconf.dropout(x, 0.1, None) is x and tconf.dropout(x, 0.0, torch.Generator()) is x


def test_dropout_reaches_every_branch_and_follows_the_generator():
    jcfg, tcfg = _cfgs("layer")
    tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(tcfg.encoder,
                                                                 dropout_rate=0.1))
    model = _model(_params(jcfg), tcfg)
    batch = _tb(_batch())
    with torch.no_grad():
        runs = [tasr.forward(model, tcfg, batch, generator=torch.Generator().manual_seed(s))[0]
                for s in (0, 0, 1)]
        off = tasr.forward(model, tcfg, batch, train=False)[0]
    assert runs[0] == runs[1] and runs[0] != runs[2] and runs[0] != off


def test_bn_statistics_match_jax():
    jcfg, tcfg = _cfgs("batch")
    tree, batch = _params(jcfg, seed=7), _batch(seed=7)
    ref_m, ref_v = jasr.bn_calibration_stats(jax.tree.map(jnp.asarray, tree), jcfg,
                                             jnp.asarray(batch["speech"]),
                                             jnp.asarray(batch["speech_lengths"]))
    model = _model(tree, tcfg)
    with torch.no_grad():
        m, v = tasr.bn_calibration_stats(model, torch.from_numpy(batch["speech"]),
                                         torch.from_numpy(batch["speech_lengths"]))
    assert m.shape == v.shape == (2, 128)
    for out, ref in ((m, ref_m), (v, ref_v)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=1e-6 * np.abs(np.asarray(ref)).max())
    new = jconf.apply_bn_stats(jax.tree.map(jnp.asarray, tree["encoder"]), ref_m, ref_v)
    tconf.apply_bn_stats(model.encoder, m, v)
    got = numpy_from_conformer_params(model.state_dict(), tcfg)
    for leaf in ("running_mean", "running_var"):
        ref = np.asarray(new["blocks"]["conv"][leaf])
        np.testing.assert_allclose(got[f"encoder/blocks/conv/{leaf}"], ref,
                                   atol=1e-6 * np.abs(ref).max())


def test_recipe_specaug_and_task_match_jax():
    """train_asr_conformer.yaml: the same SpecAug config (time warp 5, two
    frequency masks up to 30, two time masks up to 40) as JAX's, which PR
    2's SpecAug serves at 80 mel bins; the task's init and loss functions."""
    raw, jraw = load_yaml(RECIPE), jax_load_yaml(RECIPE)
    task, jtask = task_from_dict(raw), jax_task_from_dict(jraw)
    assert dataclasses.asdict(task.cfg.specaug) == dataclasses.asdict(jtask.cfg.specaug)
    assert dataclasses.asdict(jtask.cfg.specaug) == dataclasses.asdict(JSpecAugConfig(
        time_warp_window=5, freq_mask_width_range=(0, 30), num_freq_mask=2,
        time_mask_width_range=(0, 40), num_time_mask=2))
    assert task.cfg.use_specaug and task.cfg.ctc_weight == 0.3 and task.cfg.lsm_weight == 0.1
    assert task.init_fn is tasr.init_conformer_asr_params and task.loss_fn is tasr.forward
    spec = torch.randn(2, 93, 80)
    from agacs_tpu_torch.ops.specaug import specaug

    out = specaug(torch.Generator().manual_seed(0), spec, task.cfg.specaug)
    assert out.shape == spec.shape and not torch.equal(out, spec)


def test_mvn_statistics_file_is_loaded_at_init(tmp_path):
    _, tcfg = _cfgs("layer")
    rng = np.random.RandomState(11)
    mean, std = rng.randn(80).astype(np.float32), (1 + rng.rand(80)).astype(np.float32)
    np.savez(tmp_path / "feats_stats.npz", mean=mean, std=std, count=np.asarray(7))
    sd = tasr.init_conformer_asr_params(
        torch.Generator().manual_seed(0),
        dataclasses.replace(tcfg, mvn_stats_path=str(tmp_path / "feats_stats.npz")))
    assert torch.equal(sd["mvn_mean"], torch.from_numpy(mean))
    assert torch.equal(sd["mvn_std"], torch.from_numpy(std))
    sd0 = tasr.init_conformer_asr_params(torch.Generator().manual_seed(0), tcfg)
    assert torch.equal(sd0["mvn_std"], torch.ones(80))
