"""Guards of the port: it never imports JAX or the JAX package, never
falls back from the card to the CPU or a plain version, and refuses what
it cannot run yet (CTC and LM fusion in whisper decoding, the transducer,
n-gram fusion, the train CLI's multi-device options)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from agacs_tpu_torch.decode.composed_beam import composed_beam_decode
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.ops import (
    decode_attn,
    flash_train,
    int8_linear,
    int8_mlp,
    int8_serve,
    relpos_flash,
    vocab_lse,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "agacs_tpu")  # agacs_tpu_torch is another name

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
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

# a beam decode (ancestry map, shared cross-KV), with its scores
out = Speech2Text(model, ASRModelConfig(whisper=cfg), beam_size=3, max_steps=4,
                  length_bonus=0.5)(np.random.RandomState(1).randn(2, 16000).astype(np.float32))
assert all(r.tokens[:5] == [50258, 50260, 50259, 50359, 50363] for r in out)
assert all(np.isfinite(r.score) and r.score != 0.0 for r in out)

# bin.count_heads on a generated data dir, and the n-best average of two
# port-written npz files
import json, os, tempfile, wave
from agacs_tpu_torch.bin import count_heads
from agacs_tpu_torch.models.checkpoint import numpy_from_params, params_from_numpy

tmp_dir = tempfile.TemporaryDirectory()
tmp = tmp_dir.name
rng = np.random.RandomState(2)
with open(os.path.join(tmp, "wav.scp"), "w") as scp:
    for u in ("a", "b"):
        with wave.open(os.path.join(tmp, u + ".wav"), "wb") as w:
            w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
            w.writeframes((rng.randn(12000) * 3000).astype(np.int16).tobytes())
        scp.write(f"{u} {tmp}/{u}.wav\n")
with open(os.path.join(tmp, "text"), "w") as f:
    f.write("a 我们 go\nb hello\n")
with open(os.path.join(tmp, "config.yaml"), "w") as f:
    f.write("encoder: whisper\nencoder_conf: {whisper_model: test}\n"
            "decoder_conf: {whisper_model: test}\n")
res = count_heads.main(["--config", os.path.join(tmp, "config.yaml"), "--data_dir", tmp,
                        "--output", os.path.join(tmp, "counts.json"), "--device", "cpu",
                        "--compute_dtype", "float32"])
assert res["counts"].shape == (2, 2)
assert json.load(open(os.path.join(tmp, "counts.mask.json")))["head_mask"]

from agacs_tpu_torch.train.checkpoint import CheckpointManager

mgr = CheckpointManager(tmp, keep_nbest=2)
paths, sds = [], []
for ep, seed in ((1, 3), (2, 4)):
    sds.append(tw.init_whisper_params(torch.Generator().manual_seed(seed), cfg))
    np.savez(os.path.join(tmp, f"{ep}epoch.params.npz"), **numpy_from_params(sds[-1]))
ave = params_from_numpy(np.load(mgr.average_nbest(
    {1: {"valid": {"acc": 1.0}}, 2: {"valid": {"acc": 2.0}}})), cfg)
assert all(torch.allclose(ave[k], (sds[0][k] + sds[1][k]) / 2) for k in ave)

# the int8 frozen trunk: a train step (K2 plain versions: 16 encoder rows
# are below the fused path's 256, so also the unfused MLP), then greedy
# decoding on the quantised model
from agacs_tpu_torch.ops import int8_linear, int8_mlp

model = tw.Whisper.from_state_dict(cfg, tw.init_whisper_params(torch.Generator().manual_seed(5), cfg))
opt, sched = build_optimizer(apply_freeze(model, "adapter"), OptimConfig())
model.quantize_frozen_()
stats = make_train_step(model, acfg, opt, sched,
                        generator=torch.Generator().manual_seed(0))([batch])
assert torch.isfinite(stats["loss"]) and float(stats["grad_norm"]) > 0
out = Speech2Text(model, ASRModelConfig(whisper=cfg), max_steps=4)(
    np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1)
assert [r.tokens[:5] for r in out] == [[50258, 50260, 50259, 50359, 50363]] * 2
assert model.state_dict()["decoder.blocks.1.mlp.2.weight_q"].dtype == torch.int8
assert int8_linear.LAUNCHES == int8_mlp.FWD_LAUNCHES == 0

# PE (the TMECS cs_loss_pe layout): a whisper_pe + CS-loss train step, then
# greedy and beam decoding with the k_cs cache; and int8 cross-KV greedy
cfg = tw.make_config("test", pe_attention=True)
model = tw.Whisper.from_state_dict(cfg, tw.init_whisper_params(torch.Generator().manual_seed(6), cfg))
opt, sched = build_optimizer(apply_freeze(model, "whisper_pe"), OptimConfig())
stats = make_train_step(model, ASRModelConfig(whisper=cfg, cs_weight=1.0), opt, sched,
                        generator=torch.Generator().manual_seed(0))([batch])
assert torch.isfinite(stats["loss"]) and float(stats["loss_cs"]) > 0
for beam in (1, 3):
    out = Speech2Text(model, ASRModelConfig(whisper=cfg), beam_size=beam, max_steps=4)(
        np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1)
    assert all(r.tokens[:5] == [50258, 50260, 50259, 50359, 50363] for r in out)
cfg = tw.make_config("test", adapter=True, cross_kv_int8=True)
model = tw.Whisper.from_state_dict(cfg, tw.init_whisper_params(torch.Generator().manual_seed(0), cfg))
out = Speech2Text(model, ASRModelConfig(whisper=cfg), max_steps=4)(
    np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1)
assert len(out[0].tokens) > 5

# K6's paths: greedy on an int8 trunk under AGACS_W8A16=interpret (every
# decode-step product on K6's plain version), then on a serving-quantised
# model (its int8 token table and logits head) with and without it
from agacs_tpu_torch.ops import decode_attn, int8_serve

cfg = tw.make_config("test", adapter=True)
model = tw.Whisper.from_state_dict(cfg, tw.init_whisper_params(torch.Generator().manual_seed(9), cfg))
apply_freeze(model, "adapter")
model.quantize_frozen_()
os.environ["AGACS_W8A16"] = "interpret"
audio = np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1
out = Speech2Text(model, ASRModelConfig(whisper=cfg), max_steps=4)(audio)
assert [r.tokens[:5] for r in out] == [[50258, 50260, 50259, 50359, 50363]] * 2
model = int8_serve.quantize_for_serving(
    tw.Whisper.from_state_dict(cfg, tw.init_whisper_params(torch.Generator().manual_seed(9), cfg)))
for env in ("interpret", "0"):
    os.environ["AGACS_W8A16"] = env
    out = Speech2Text(model, ASRModelConfig(whisper=cfg), beam_size=2, max_steps=4)(audio)
    assert all(r.tokens[:5] == [50258, 50260, 50259, 50359, 50363] for r in out)
del os.environ["AGACS_W8A16"]
assert int8_serve.LAUNCHES == 0 and model.decoder.logits_w_q.dtype == torch.int8

# the ladder side network (d_head 48): greedy and beam, and a sidenetwork
# train step
cfg = tw.make_config("test", side_network=tw.SideNetworkConfig(96, 2, (0, 1)))
model = tw.Whisper.from_state_dict(cfg, tw.init_whisper_params(torch.Generator().manual_seed(10), cfg))
for beam in (1, 3):
    out = Speech2Text(model, ASRModelConfig(whisper=cfg), beam_size=beam, max_steps=4)(audio)
    assert all(r.tokens[:5] == [50258, 50260, 50259, 50359, 50363] for r in out)
opt, sched = build_optimizer(apply_freeze(model, "sidenetwork"), OptimConfig())
stats = make_train_step(model, ASRModelConfig(whisper=cfg, cs_weight=0.5), opt, sched,
                        generator=torch.Generator().manual_seed(0))([batch])
assert torch.isfinite(stats["loss"]) and float(stats["grad_norm"]) > 0
assert decode_attn.D48_LAUNCHES == 0

# the conformer recipe's serving: encode (K5's path in bf16), CTC log-probs,
# the joint beam with the LM (float32 caches), the decode and score CLIs
import dataclasses, yaml
from agacs_tpu_torch.decode.joint_beam import decode_conformer_batch
from agacs_tpu_torch.models import conformer_asr, lm as tlm
from agacs_tpu_torch.models.checkpoint import numpy_from_conformer_params, numpy_from_lm_params
from agacs_tpu_torch.utils.config import task_from_dict
from agacs_tpu_torch.bin import decode, score
from agacs_tpu_torch.ops import decode_attn, relpos_flash

conf = {"encoder": "conformer", "normalize": "global_mvn",
        "encoder_conf": {"output_size": 128, "attention_heads": 2, "linear_units": 256,
                         "num_blocks": 2},
        "decoder_conf": {"attention_heads": 2, "linear_units": 256, "num_blocks": 1}}
ccfg = task_from_dict(conf, compute_dtype=torch.bfloat16).cfg
csd = conformer_asr.init_conformer_asr_params(torch.Generator().manual_seed(7), ccfg)
cmodel = conformer_asr.ConformerASR.from_state_dict(ccfg, csd)
lcfg = tlm.TransformerLMConfig(d_model=128, attention_heads=2, linear_units=256, num_blocks=1)
lsd = tlm.init_lm_params(torch.Generator().manual_seed(8), lcfg)
lmod = tlm.TransformerLM.from_state_dict(lcfg, lsd)
rows, sc = decode_conformer_batch(cmodel, lmod, torch.randn(2, 40000) * 0.1,
                                  torch.tensor([40000, 36000]), beam_size=3, max_steps=3)
assert len(rows) == 2 and bool(torch.isfinite(sc).all())
assert relpos_flash.LAUNCHES == decode_attn.F32_LAUNCHES == decode_attn.LAUNCHES == 0
np.savez(os.path.join(tmp, "c.params.npz"), **numpy_from_conformer_params(csd, ccfg))
os.makedirs(os.path.join(tmp, "lm"))
np.savez(os.path.join(tmp, "lm", "valid.loss.ave.params.npz"), **numpy_from_lm_params(lsd, lcfg))
with open(os.path.join(tmp, "lm", "config.yaml"), "w") as f:
    yaml.safe_dump({"lm_conf": {"d_model": 128, "attention_heads": 2, "linear_units": 256,
                                "num_blocks": 1}}, f)
with open(os.path.join(tmp, "conformer.yaml"), "w") as f:
    yaml.safe_dump(conf, f)
res = decode.main(["--config", os.path.join(tmp, "conformer.yaml"), "--params",
                   os.path.join(tmp, "c.params.npz"), "--data_dir", tmp, "--output_dir",
                   os.path.join(tmp, "dec"), "--lm_exp", os.path.join(tmp, "lm"),
                   "--beam_size", "2", "--max_steps", "2", "--device", "cpu"])
assert set(res["hyps"]) == {"a", "b"}
rep = score.main(["--ref", os.path.join(tmp, "dec", "ref.trn"), "--hyp",
                  os.path.join(tmp, "dec", "hyp.trn"), "--output_dir", os.path.join(tmp, "sc"),
                  "--per_bucket"])
assert rep["mer"]["utts"] == 2

# the conformer recipe's training: a bf16 step (K5 forward and backward,
# K4 forward, dx and dw: their plain versions here) with SpecAug and dropout
from agacs_tpu_torch.ops import vocab_lse
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import make_train_step

tmodel = conformer_asr.ConformerASR.from_state_dict(ccfg, csd, param_dtype=torch.float32)
opt, sched = build_optimizer(tmodel.parameters(), OptimConfig(optim="adam"))
stats = make_train_step(tmodel, ccfg, opt, sched, grad_clip=5.0,
                        generator=torch.Generator().manual_seed(0),
                        loss_fn=conformer_asr.forward)([
    {"speech": torch.randn(2, 40000) * 0.1, "speech_lengths": torch.tensor([40000, 36000]),
     "text": torch.tensor([[1000, 1001, 1001, -1], [2000, 2001, -1, -1]])}])
assert torch.isfinite(stats["loss"]) and float(stats["loss_ctc"]) > 0
assert relpos_flash.LAUNCHES == relpos_flash.BWD_LAUNCHES == 0
assert vocab_lse.FWD_LAUNCHES == vocab_lse.DX_LAUNCHES == vocab_lse.DW_LAUNCHES == 0

# the recipe's data path: a segments dir of FLAC recordings -> format_data
# flac.ark -> perturb -> ASRDataset, and an OpenAI-layout .pt as init_param
from agacs_tpu_torch.bin import format_data
from agacs_tpu_torch.bin.train import load_init_params
from agacs_tpu_torch.data.dataset import ASRDataset
from agacs_tpu_torch.data.flac import read_flac, write_flac
from agacs_tpu_torch.data.io import write_scp
from agacs_tpu_torch.data.perturb import perturb_data_dir

seg = os.path.join(tmp, "seg")
write_flac(os.path.join(seg, "rec.flac"), rng.randn(40000).astype(np.float32) * 0.1)
assert np.array_equal(read_flac(os.path.join(seg, "rec.flac"))[0],
                      read_flac(os.path.join(seg, "rec.flac"), native=False)[0])
write_scp(os.path.join(seg, "wav.scp"), {"rec": os.path.join(seg, "rec.flac")})
write_scp(os.path.join(seg, "segments"), {"x-rec-1": "rec 0.0 1.0", "x-rec-2": "rec 1.0 2.4"})
write_scp(os.path.join(seg, "text"), {"x-rec-1": "我们 go", "x-rec-2": "hello"})
format_data.main(["--data_dir", seg, "--outdir", os.path.join(tmp, "ark")])
perturb_data_dir(os.path.join(tmp, "ark"), os.path.join(tmp, "sp"))
ds = ASRDataset(os.path.join(tmp, "sp"))
assert len(ds) == 6 and len(ds["x-rec-2"]["speech"]) == 22400
wcfg = tw.make_config("test", adapter=True)
wsd = tw.init_whisper_params(torch.Generator().manual_seed(0), wcfg)
torch.save({"dims": {"n_audio_state": 64, "n_audio_head": 2, "n_audio_layer": 2,
                     "n_text_state": 64, "n_text_head": 2, "n_text_layer": 2},
            "model_state_dict": {k: v for k, v in wsd.items() if "adapter" not in k}},
           os.path.join(tmp, "w.pt"))
_, names = load_init_params(os.path.join(tmp, "w.pt"), wsd, ASRModelConfig(whisper=wcfg))
assert len(names) == sum("adapter" not in k for k in wsd)

# the train CLI: one folded epoch with estimate_c, then --resume to a second
from agacs_tpu_torch.bin import train

recipe = "recipes/seame/conf/train_asr_whisper_small_adapter_csloss_2stage.yaml"
argv = ["--config", recipe, "--train_dir", tmp, "--valid_dir", tmp, "--exp_dir",
        os.path.join(tmp, "exp"), "--batch_type", "folded", "--device", "cpu",
        "--compute_dtype", "float32", "--num_att_plot", "0", "--override",
        "encoder_conf.whisper_model=test", "decoder_conf.whisper_model=test",
        "decoder_conf.estimate_c=true", "batch_size=1"]
out = train.main(argv + ["max_epoch=1"])
assert np.isfinite(out["history"][1]["train"]["loss"])
out = train.main(["--resume"] + argv + ["max_epoch=2"])
assert sorted(out["history"]) == [1, 2]  # 2 batches, accum_grad 4: one step an epoch
assert json.load(open(os.path.join(tmp, "exp", "checkpoint_meta.json")))["step"] == 2
tmp_dir.cleanup()
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("OK", len(mods))
"""


def test_port_tokenizer_trn_and_error_calculator_match_jax():
    """The port's copies of `agacs_tpu.text`, the .trn writer and the
    ErrorCalculator give the JAX package's ids, texts, files and rates."""
    from agacs_tpu.eval.scoring import read_trn as jax_read_trn
    from agacs_tpu.eval.scoring import write_trn as jax_write_trn
    from agacs_tpu.text import TextCleaner as JaxCleaner
    from agacs_tpu.text import WhisperTokenIdConverter as JaxConverter
    from agacs_tpu.text import WhisperTokenizer as JaxTokenizer
    from agacs_tpu.train.error_calculator import ErrorCalculator as JaxErrorCalculator
    from agacs_tpu_torch.eval.scoring import read_trn, write_trn
    from agacs_tpu_torch.text import TextCleaner, WhisperTokenIdConverter, WhisperTokenizer
    from agacs_tpu_torch.train.error_calculator import ErrorCalculator

    texts = ["我们 go", "hello 你", "好 ok", "去 shop", "that 是 right", "嗯 ok lah",
             "我 think so", "走 了 bye", "hello 你好", "Ça, c'est 好的!"]
    tok, ref = WhisperTokenizer(), JaxTokenizer()
    conv, jconv = WhisperTokenIdConverter(tok), JaxConverter(ref)
    for t in texts:
        ids = tok.encode(t)
        assert ids == ref.encode(t) and tok.decode(ids) == ref.decode(ids) == t
        assert tok.text2tokens(t) == ref.text2tokens(t)
        assert conv.tokens2ids(tok.text2tokens(t)) == jconv.tokens2ids(ref.text2tokens(t))
        assert TextCleaner("whisper_basic")(t) == JaxCleaner("whisper_basic")(t)
    utts = {f"u{i}": t for i, t in enumerate(texts)}
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        write_trn(os.path.join(tmp, "a.trn"), utts)
        jax_write_trn(os.path.join(tmp, "b.trn"), utts)
        assert open(os.path.join(tmp, "a.trn")).read() == open(os.path.join(tmp, "b.trn")).read()
        assert read_trn(os.path.join(tmp, "a.trn")) == jax_read_trn(os.path.join(tmp, "b.trn"))
    ids = [conv.tokens2ids(tok.text2tokens(t)) for t in texts[:4]]
    ys = np.full((4, max(map(len, ids))), -1)
    for i, row in enumerate(ids):
        ys[i, : len(row)] = row
    hat = np.roll(np.where(ys < 0, 50257, ys), 1, axis=1)
    assert ErrorCalculator(tok.id_to_token)(hat, ys) == JaxErrorCalculator(ref.id_to_token)(hat, ys)


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
    anc = torch.zeros(2, 16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        decode_attn.decode_cache_attention(x[:, 0], x, x, 3, 2, anc_local=anc, beam=2)
    with pytest.raises(ValueError):
        decode_attn.decode_shared_cache_attention(x[:, 0], x[:1], x[:1], 3, 2, 2)
    with pytest.raises(ValueError):
        decode_attn.decode_cache_attention(x[:, 0], x, x, 3, 2, q_cs=x[:, 0], k_cs=x,
                                           gate=torch.empty(2, device="meta"))
    x8 = torch.empty(2, 32, 128, device="meta", dtype=torch.int8)
    sc = torch.empty(128, device="meta")
    with pytest.raises(ValueError):
        decode_attn.decode_cache_attention(x[:, 0], x8, x8, 3, 2, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError):
        decode_attn.decode_shared_cache_attention(x[:, 0], x8[:1], x8[:1], 3, 2, 2,
                                                  k_scale=sc, v_scale=sc)
    xq = torch.empty(32, 128, device="meta", dtype=torch.int8)
    w_q = torch.empty(128, 256, device="meta", dtype=torch.int8)
    s = torch.empty(256, device="meta")
    with pytest.raises(ValueError):
        int8_linear.int8_matmul(x[0], w_q, s)
    with pytest.raises(ValueError):
        int8_serve.w8a16_matmul(x[0], w_q, s)
    with pytest.raises(ValueError):
        decode_attn.decode_cache_attention(x[:, 0, :96], x[..., :96].contiguous(),
                                           x[..., :96].contiguous(), 3, 2)
    with pytest.raises(ValueError):
        int8_linear.int8_gemm(xq, torch.empty(32, 1, device="meta"), w_q, s)
    with pytest.raises(ValueError):
        int8_mlp.int8_mlp(x[0], w_q, s, s, w_q.t(), s[:128], s[:128])
    x64 = torch.empty(2, 64, 128, device="meta", dtype=torch.bfloat16)
    pe = torch.empty(128, 128, device="meta", dtype=torch.bfloat16)
    mask = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError):
        relpos_flash.relpos_mha(x64, x64, x64, x64, pe, mask, 2)
    xg = x64.clone().requires_grad_()
    with pytest.raises(ValueError):  # K5 under autograd (its backward's forward)
        relpos_flash.relpos_mha(xg, x64, x64, x64, pe, mask, 2)
    stat = torch.empty(2, 2, 64, device="meta")
    with pytest.raises(ValueError):
        relpos_flash._launch_bwd(x64, x64, x64, x64, pe, mask, x64, x64, stat, stat, 2)
    xk = torch.empty(40, 128, device="meta", dtype=torch.bfloat16)
    wk = torch.empty(128, 300, device="meta", dtype=torch.bfloat16)
    bk = torch.empty(300, device="meta")
    with pytest.raises(ValueError):
        vocab_lse.streaming_lse(xk, wk, bk)
    with pytest.raises(ValueError):
        vocab_lse._launch_dx(xk, wk, bk, bk[:40], bk[:40])
    with pytest.raises(ValueError):
        vocab_lse._launch_dw(xk, wk, bk, bk[:40], bk[:40])
    xf = torch.empty(2, 16, 128, device="meta")
    with pytest.raises(ValueError):
        decode_attn.decode_cache_attention(xf[:, 0], xf, xf, 3, 2)


DECODE_COUNTERS = ("LAUNCHES", "ANC_LAUNCHES", "PE_LAUNCHES", "ANC_PE_LAUNCHES",
                   "I8_LAUNCHES", "ANC_I8_LAUNCHES", "SHARED_LAUNCHES", "SHARED_I8_LAUNCHES",
                   "F32_LAUNCHES", "D48_LAUNCHES")


def test_launch_counters_stay_zero_on_cpu():
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    for name in DECODE_COUNTERS:
        setattr(decode_attn, name, 0)
    int8_linear.QUANT_LAUNCHES = int8_linear.LAUNCHES = int8_linear.DGRAD_LAUNCHES = 0
    int8_mlp.FWD_LAUNCHES = int8_mlp.BWD_LAUNCHES = 0
    int8_serve.LAUNCHES = 0
    relpos_flash.LAUNCHES = relpos_flash.BWD_LAUNCHES = 0
    vocab_lse.FWD_LAUNCHES = vocab_lse.DX_LAUNCHES = vocab_lse.DW_LAUNCHES = 0
    cfg = tw.make_config("test", adapter=True)
    model = tw.Whisper.from_state_dict(
        cfg, tw.init_whisper_params(torch.Generator().manual_seed(1), cfg))
    model.quantize_frozen_()
    audio = np.random.RandomState(1).randn(1, 8000).astype(np.float32) * 0.1
    for beam in (1, 3):
        out = Speech2Text(model, ASRModelConfig(whisper=cfg), beam_size=beam,
                          max_steps=3)(audio)
        assert len(out[0].tokens) >= 6
    cfg = tw.make_config("test", pe_decoder=True, cross_kv_int8=True)
    model = tw.Whisper.from_state_dict(
        cfg, tw.init_whisper_params(torch.Generator().manual_seed(2), cfg))
    for beam in (1, 3):
        Speech2Text(model, ASRModelConfig(whisper=cfg), beam_size=beam, max_steps=3)(audio)
    cfg = tw.make_config("test", side_network=tw.SideNetworkConfig(96, 2, (0, 1)))
    model = int8_serve.quantize_for_serving(tw.Whisper.from_state_dict(
        cfg, tw.init_whisper_params(torch.Generator().manual_seed(3), cfg)))
    Speech2Text(model, ASRModelConfig(whisper=cfg), max_steps=3)(audio)
    assert int8_serve.LAUNCHES == 0
    assert flash_train.LAUNCHES == 0 and flash_train.BWD_LAUNCHES == 0
    assert all(getattr(decode_attn, name) == 0 for name in DECODE_COUNTERS)
    assert int8_linear.QUANT_LAUNCHES == int8_linear.LAUNCHES == 0
    assert int8_mlp.FWD_LAUNCHES == 0
    _conformer_serving_on_cpu()
    assert relpos_flash.LAUNCHES == 0
    assert all(getattr(decode_attn, name) == 0 for name in DECODE_COUNTERS)
    _conformer_training_on_cpu()
    assert relpos_flash.LAUNCHES == relpos_flash.BWD_LAUNCHES == 0
    assert vocab_lse.FWD_LAUNCHES == vocab_lse.DX_LAUNCHES == vocab_lse.DW_LAUNCHES == 0


def _conformer_serving_on_cpu():
    """A bf16 conformer (K5's path) with a float32 LM (K3-f32's) on the CPU."""
    from agacs_tpu_torch.decode.joint_beam import decode_conformer_batch
    from agacs_tpu_torch.models import conformer_asr, lm as tlm
    from agacs_tpu_torch.utils.config import task_from_dict

    conf = {"encoder": "conformer",
            "encoder_conf": {"output_size": 128, "attention_heads": 2, "linear_units": 128,
                             "num_blocks": 1},
            "decoder_conf": {"attention_heads": 2, "linear_units": 128, "num_blocks": 1}}
    ccfg = task_from_dict(conf, compute_dtype=torch.bfloat16).cfg
    model = conformer_asr.ConformerASR.from_state_dict(
        ccfg, conformer_asr.init_conformer_asr_params(torch.Generator().manual_seed(3), ccfg))
    lcfg = tlm.TransformerLMConfig(d_model=128, attention_heads=2, linear_units=128,
                                   num_blocks=1)
    lm = tlm.TransformerLM.from_state_dict(
        lcfg, tlm.init_lm_params(torch.Generator().manual_seed(4), lcfg))
    rows, _ = decode_conformer_batch(model, lm, torch.randn(1, 36000) * 0.1,
                                     torch.tensor([36000]), beam_size=2, max_steps=2)
    assert len(rows) == 1


def _conformer_training_on_cpu():
    """A bf16 conformer train step on the CPU: K5's and K4's paths, forward
    and backward, in their plain versions."""
    from agacs_tpu_torch.models import conformer_asr
    from agacs_tpu_torch.utils.config import task_from_dict

    conf = {"encoder": "conformer",
            "encoder_conf": {"output_size": 128, "attention_heads": 2, "linear_units": 128,
                             "num_blocks": 1, "conv_norm": "batch"},
            "decoder_conf": {"attention_heads": 2, "linear_units": 128, "num_blocks": 1}}
    cfg = task_from_dict(conf, compute_dtype=torch.bfloat16).cfg
    model = conformer_asr.ConformerASR.from_state_dict(
        cfg, conformer_asr.init_conformer_asr_params(torch.Generator().manual_seed(3), cfg),
        param_dtype=torch.float32)
    batch = {"speech": torch.randn(1, 36000) * 0.1, "speech_lengths": torch.tensor([36000]),
             "text": torch.tensor([[1000, 1001]])}
    loss, _ = conformer_asr.forward(model, cfg, batch, generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())


def test_ctc_lattice_does_not_use_torch_ctc_loss():
    """F.ctc_loss's backward assumes log-softmax inputs; the lattice's
    planes are not normalised over a class axis."""
    import ast
    import inspect

    from agacs_tpu_torch.train import losses

    tree = ast.parse(inspect.getsource(losses.ctc_loss_from_planes))
    called = {getattr(n.func, "attr", getattr(n.func, "id", None))
              for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert called and not called & {"ctc_loss", "ctc_loss_streaming"}


@pytest.mark.parametrize("kernel", ["K3a", "K3s", "K3-PE", "K3-int8", "K3s-int8", "K3-f32",
                                    "K5", "K5 backward", "K4", "K6", "K3 d_head 48"])
def test_cuda_request_to_a_beam_kernel_without_a_card_raises(kernel):
    """A CUDA-device request never falls back to the plain version: on a
    machine without a card it raises before anything runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        q = torch.zeros(6, 128, dtype=torch.bfloat16, device="cuda")
        kv = torch.zeros(6, 32, 128, dtype=torch.bfloat16, device="cuda")
        kv8 = torch.zeros(2, 32, 128, dtype=torch.int8, device="cuda")
        sc = torch.ones(128, device="cuda")
        if kernel == "K3a":
            decode_attn.decode_cache_attention(
                q, kv, kv, 3, 2, beam=3,
                anc_local=torch.zeros(6, 32, dtype=torch.int32, device="cuda"))
        elif kernel == "K3-PE":
            decode_attn.decode_cache_attention(q, kv, kv, 3, 2, q_cs=q, k_cs=kv,
                                               gate=torch.zeros(2, device="cuda"))
        elif kernel == "K3-int8":
            decode_attn.decode_cache_attention(q[:2], kv8, kv8, 3, 2, k_scale=sc, v_scale=sc)
        elif kernel == "K3s-int8":
            decode_attn.decode_shared_cache_attention(q, kv8, kv8, 3, 2, 3, k_scale=sc,
                                                      v_scale=sc)
        elif kernel == "K3-f32":
            decode_attn.decode_cache_attention(q.float(), kv.float(), kv.float(), 3, 2)
        elif kernel in ("K5", "K5 backward"):
            x = torch.zeros(2, 64, 128, dtype=torch.bfloat16, device="cuda",
                            requires_grad=kernel == "K5 backward")
            relpos_flash.relpos_mha(x, x, x, x, x[0], torch.zeros(2, 64, device="cuda"), 2)
        elif kernel == "K4":
            x = torch.zeros(8, 128, dtype=torch.bfloat16, device="cuda")
            vocab_lse.streaming_lse(x, x.t().contiguous(), torch.zeros(8, device="cuda"))
        elif kernel == "K6":
            int8_serve.w8a16_matmul(q, torch.zeros(128, 512, dtype=torch.int8, device="cuda"),
                                    torch.ones(512, device="cuda"))
        elif kernel == "K3 d_head 48":
            decode_attn.decode_cache_attention(q[:, :96], kv[..., :96], kv[..., :96], 3, 2)
        else:
            decode_attn.decode_shared_cache_attention(q, kv[:2], kv[:2], 3, 2, 3)


@pytest.mark.parametrize("kw", [dict(beam_size=2, ctc_weight=0.3), dict(ctc_weight=0.3),
                                dict(lm_weight=0.5), dict(ngram_weight=0.1),
                                dict(beam_size=4, lm_weight=0.3)])
def test_unported_decoding_raises(kw):
    cfg = tw.make_config("test")
    model = tw.Whisper(cfg)
    with pytest.raises(NotImplementedError):
        Speech2Text(model, ASRModelConfig(whisper=cfg), **kw)


def test_composed_beam_with_ngram_raises():
    def step(cur, pos, state):
        return torch.zeros(cur.shape[0], 8), state

    with pytest.raises(NotImplementedError):
        composed_beam_decode(step, torch.zeros(1, 2), batch=1, vocab=8, beam_size=2,
                             primer=(1,), max_steps=3, eot=0, max_pos=8,
                             ngram_step_fn=lambda toks, pos: torch.zeros(2, 8),
                             ngram_weight=0.3)


@pytest.mark.parametrize("what", ["transducer", "ngram_cli"])
def test_unported_conformer_family_parts_raise(what, tmp_path):
    """The transducer family and `bin.decode --ngram_file` raise."""
    from agacs_tpu_torch.bin import decode
    from agacs_tpu_torch.utils.config import task_from_dict

    conf_dir = os.path.join(REPO, "recipes", "seame", "conf")
    with pytest.raises(NotImplementedError):
        if what == "transducer":
            task_from_dict({"encoder": "conformer", "decoder": "transducer"})
        else:
            decode.main(["--config", os.path.join(conf_dir, "train_asr_conformer.yaml"),
                         "--params", "p.npz", "--data_dir", str(tmp_path), "--output_dir",
                         str(tmp_path / "out"), "--ngram_file", "lm.npz", "--device", "cpu"])


@pytest.mark.parametrize("flags", [
    ["--tensor_parallel", "2"], ["--optim_state_shard"], ["--ckpt_backend", "orbax"],
    ["--override", "freeze_quant=int8", "freeze_param=null"], ["--override", "freeze_quant=int4"],
], ids=str)
def test_unported_train_cli_options_raise(flags, tmp_path):
    from agacs_tpu_torch.bin import train

    conf = os.path.join(REPO, "recipes", "seame", "conf",
                        "train_asr_whisper_small_adapter_csloss_2stage.yaml")
    with pytest.raises((NotImplementedError, ValueError)):
        train.main(["--config", conf, "--train_dir", str(tmp_path), "--valid_dir",
                    str(tmp_path), "--exp_dir", str(tmp_path / "exp"), "--device", "cpu",
                    *flags])


def test_failed_flac_build_raises(tmp_path, monkeypatch):
    """A codec that does not build raises, in every reader that needs it;
    nothing falls back to the Python decoder."""
    from agacs_tpu_torch.data import flac, io

    good = flac.encode_flac(np.zeros(100, np.int16), 16000)
    path = tmp_path / "a.flac"
    path.write_bytes(good)
    monkeypatch.setattr(flac, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(flac, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(flac, "_LIB", None)
    for call in (lambda: flac.decode_flac(good), lambda: io.read_wav(str(path)),
                 lambda: flac.encode_flac(np.zeros(10, np.int16), 16000)):
        with pytest.raises(RuntimeError, match="no-such-compiler"):
            call()
    assert not list((tmp_path / "build").glob("*.so"))
    assert flac.decode_flac(good, native=False)[0].shape == (100, 1)
