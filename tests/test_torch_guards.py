"""Guards of the port: it never imports JAX, never falls back from the
card to the CPU or a plain version, and refuses what it cannot run yet."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from agacs_tpu.models import whisper as jw
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.ops import decode_attn, flash_train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
import agacs_tpu_torch

torch.set_num_threads(1)
mods = [m.name for m in pkgutil.walk_packages(agacs_tpu_torch.__path__,
                                              "agacs_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig

cfg = tw.make_config("test", adapter=True)
model = tw.Whisper.from_state_dict(
    cfg, tw.init_whisper_params(torch.Generator().manual_seed(0), cfg))
out = Speech2Text(model, ASRModelConfig(whisper=cfg), max_steps=4)(
    np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1)
assert [r.tokens[:5] for r in out] == [[50258, 50260, 50259, 50359, 50363]] * 2

# one adapter + CS-loss training step
from agacs_tpu_torch.train.freeze import apply_freeze
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import make_train_step

acfg = ASRModelConfig(whisper=cfg, cs_weight=0.5)
opt, sched = build_optimizer(apply_freeze(model, "adapter"), OptimConfig())
batch = {"speech": torch.randn(2, 16000) * 0.1, "speech_lengths": torch.tensor([16000, 9000]),
         "text": torch.tensor([[50260, 50259, 50359, 50363, 1000, 50257]] * 2),
         "cs_labels": torch.tensor([[0, 1, 2, 0, 0, 1, 3]] * 2, dtype=torch.int8)}
stats = make_train_step(model, acfg, opt, sched,
                        generator=torch.Generator().manual_seed(0))([batch])
assert torch.isfinite(stats["loss"]) and float(stats["loss_cs"]) > 0
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print("OK", len(mods))
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_mods = int(proc.stdout.split()[-1])
    assert n_mods >= 20  # every module of the package was imported


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        tw.Whisper(tw.make_config("test"), device="cuda")


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    x = torch.empty(2, 16, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_train.packed_flash_mha(x, x, x, 2)
    lse = torch.empty(2, 2, 16, device="meta")
    with pytest.raises(ValueError):
        flash_train.packed_flash_mha_bwd(x, x, x, x, lse, x, 2)
    with pytest.raises(ValueError):
        flash_train.PackedFlashMHA.apply(x.requires_grad_(), x, x, 2)
    with pytest.raises(ValueError):
        decode_attn.decode_cache_attention(x[:, 0], x, x, 3, 2)


def test_launch_counters_stay_zero_on_cpu():
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = decode_attn.LAUNCHES = 0
    cfg = tw.make_config("test", adapter=True)
    model = tw.Whisper.from_state_dict(
        cfg, tw.init_whisper_params(torch.Generator().manual_seed(1), cfg))
    out = Speech2Text(model, ASRModelConfig(whisper=cfg), max_steps=3)(
        np.random.RandomState(1).randn(1, 8000).astype(np.float32) * 0.1)
    assert len(out[0].tokens) >= 6
    assert flash_train.LAUNCHES == 0 and decode_attn.LAUNCHES == 0
    assert flash_train.BWD_LAUNCHES == 0


@pytest.mark.parametrize("flags", [
    dict(pe_attention=True), dict(pe_decoder=True), dict(pe_encoder=True),
    dict(side_network=tw.SideNetworkConfig()), dict(cross_kv_int8=True),
])
def test_unported_model_configs_raise(flags):
    with pytest.raises(NotImplementedError):
        tw.Whisper(tw.make_config("test", **flags))


@pytest.mark.parametrize("leaf", ["w_q", "token_emb_q", "logits_w_q", "query_cs"])
def test_unported_checkpoints_raise(leaf):
    cfg = jw.make_config("test")
    tree = jax.tree.map(np.asarray, jw.init_whisper_params(jax.random.PRNGKey(0), cfg))
    if leaf == "w_q":
        tree["encoder"]["blocks"]["mlp"]["fc1"] = {
            "w_q": np.zeros((2, 64, 256), np.int8), "w_s": np.ones((2, 256))}
    elif leaf == "query_cs":
        tree["decoder"]["blocks"]["attn"]["query_cs"] = {"w": np.zeros((2, 64, 64))}
    else:
        tree["decoder"][leaf] = np.zeros((4, 64), np.int8)
    with pytest.raises(NotImplementedError):
        params_from_numpy(tree, tw.make_config("test"))


@pytest.mark.parametrize("kw", [dict(beam_size=2), dict(ctc_weight=0.3),
                                dict(lm_weight=0.5), dict(ngram_weight=0.1)])
def test_unported_decoding_raises(kw):
    cfg = tw.make_config("test")
    model = tw.Whisper(cfg)
    with pytest.raises(NotImplementedError):
        Speech2Text(model, ASRModelConfig(whisper=cfg), **kw)


@pytest.mark.parametrize("kw", [
    dict(anc_local=torch.zeros(4, 16, dtype=torch.long), beam=2),
    dict(q_cs=torch.zeros(4, 128), k_cs=torch.zeros(4, 16, 128),
         gate=torch.zeros(2)),
    dict(k_scale=torch.ones(128), v_scale=torch.ones(128)),
])
def test_unported_decode_attention_variants_raise(kw):
    q, kv = torch.zeros(4, 128), torch.zeros(4, 16, 128)
    with pytest.raises(NotImplementedError):
        decode_attn.decode_cache_attention(q, kv, kv, 3, 2, **kw)


@pytest.mark.parametrize("kw", [dict(ctc_weight=0.3), dict(cs_weight=0.1, cs_loss_type="lid_ce"),
                                dict(estimate_c=True)], ids=str)
def test_unported_training_options_raise(kw):
    cfg = tw.make_config("test")
    acfg = ASRModelConfig(whisper=cfg, **kw)
    batch = {"speech": torch.zeros(1, 1600), "speech_lengths": torch.tensor([1600]),
             "text": torch.tensor([[50257]]), "cs_labels": torch.zeros(1, 2, dtype=torch.int8)}
    with pytest.raises(NotImplementedError):
        asr_model.forward(tw.Whisper(cfg), acfg, batch)


@pytest.mark.parametrize("flags", [
    ["--resume"], ["--tensor_parallel", "2"], ["--optim_state_shard"],
    ["--ckpt_backend", "orbax"], ["--batch_type", "fixed_shapes"],
    ["--override", "freeze_quant=int8"], ["--init_param", "small.pt"],
    ["--override", "model_conf.ctc_weight=0.3"],
], ids=str)
def test_unported_train_cli_options_raise(flags, tmp_path):
    from agacs_tpu_torch.bin import train

    conf = os.path.join(REPO, "recipes", "seame", "conf",
                        "train_asr_whisper_small_adapter_csloss_2stage.yaml")
    with pytest.raises(NotImplementedError):
        train.main(["--config", conf, "--train_dir", str(tmp_path), "--valid_dir",
                    str(tmp_path), "--exp_dir", str(tmp_path / "exp"), "--device", "cpu",
                    *flags])
