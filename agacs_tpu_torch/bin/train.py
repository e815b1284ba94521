"""Training CLI (counterpart of `agacs_tpu/bin/train.py`): the whisper
family and the conformer recipe's hybrid CTC/attention model
(`recipes/seame/run_conformer.sh` stage 3).

  python -m agacs_tpu_torch.bin.train \\
      --config recipes/seame/conf/train_asr_whisper_small_adapter_csloss_2stage.yaml \\
      --train_dir data/train --valid_dir data/valid --exp_dir exp/x \\
      [--init_param exp/stage1/valid.acc.ave.params.npz] [--max_epoch N] \\
      [--batch_bins N] [--override model_conf.cs_weight=0.02 ...] \\
      [--freeze_param adapter] [--compute_dtype bfloat16] [--device cuda]

One process, one device. Per epoch: numel batches (shuffled by seed +
epoch), one optimizer step per `accum_grad` consecutive batches (a
shorter group at the epoch's end steps with what it has), then a valid
pass with CER/WER from the teacher-forced argmax. Writes `config.yaml`
(the resolved config, which `agacs_tpu_torch.bin.decode --config` reads),
`{n}epoch.params.npz` kept for the n best `valid.acc`, their average
`valid.acc.ave.params.npz`, and `train_history.json`. The npz files hold
the JAX package's flat layout, so `agacs_tpu` loads them too.

The whisper model is built in float32; the freeze preset's frozen parameters
(linears, conv stem, layer norms, embeddings, PE gates) are then stored in
the compute dtype, as JAX's `cast_frozen_params` stores them, the
trainable ones stay float32 masters. The TMECS PE recipes (`pe_whisper`,
presets `whisper_pe` / `freeze_decoder_pe`) train as any other. With `freeze_quant: int8` (and a freeze preset) the frozen
trunk projections are then quantised to int8 (`Whisper.quantize_frozen_`,
from the stored weights, as JAX does) and run kernels K8 and K2; the
checkpoints hold them as `w_q`/`w_s`, which the decode CLI loads.

The conformer family (`encoder: conformer`, e.g.
recipes/seame/conf/train_asr_conformer.yaml) trains every parameter as a
float32 master under the compute dtype, with SpecAug, dropout and the
hybrid loss of `models/conformer_asr.forward` (kernels K5 and K4 on the
card); `normalize_conf.stats_file` (stage 1's feats_stats.npz) seeds the
global MVN. With `conv_norm: batch` the BatchNorm running statistics are
recalibrated after each epoch's training from the first <= 8 train batches
(JAX :520-578). Checkpoints hold the JAX conformer layout, which both
packages' decode CLIs load.

`--init_param` takes JAX's spec `path[:src[:dst[:exclude,...]]]` over a
`.params.npz` or, for the whisper family, an OpenAI `.pt`
(`models/checkpoint.read_torch_whisper`, its leaves put in the npz layout
first): the keys under `src` load into `dst`, the leaves under an
`exclude` prefix are skipped, and what is missing or mismatched keeps its
init. Raw-bf16 (`V2`) leaves are read as bf16, a `token_emb` with another
row count is cut or zero-padded to the model's.

Not ported, and raising NotImplementedError: --resume, --tensor_parallel > 1,
--optim_state_shard, --ckpt_backend orbax, batch types other than numel,
a freeze preset on the conformer family, and the transducer family.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import time

import numpy as np
import torch

from agacs_tpu_torch.train.error_calculator import ErrorCalculator
from agacs_tpu_torch.data.collate import collate_batch, to_device
from agacs_tpu_torch.data.dataset import ASRDataset
from agacs_tpu_torch.data.sampler import num_elements_batches
from agacs_tpu_torch.models.asr_model import check_trainable
from agacs_tpu_torch.models.checkpoint import (
    conformer_params_from_numpy,
    numpy_from_conformer_params,
    numpy_from_params,
    params_from_numpy,
    read_torch_whisper,
)
from agacs_tpu_torch.models.conformer import apply_bn_stats
from agacs_tpu_torch.models.conformer_asr import ConformerASR, bn_calibration_stats
from agacs_tpu_torch.models.whisper import Whisper
from agacs_tpu_torch.train.checkpoint import CheckpointManager
from agacs_tpu_torch.train.freeze import apply_freeze
from agacs_tpu_torch.train.optim import build_optimizer
from agacs_tpu_torch.train.trainer import EpochMean, make_eval_step, make_train_step
from agacs_tpu_torch.utils.config import (
    apply_overrides,
    dump_resolved,
    load_yaml,
    optim_config_from_dict,
    task_from_dict,
    trainer_config_from_dict,
)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--valid_dir", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--freeze_param", default=None)
    p.add_argument("--init_param", default=None,
                   help=".params.npz checkpoint (JAX layout) or OpenAI .pt file, "
                        "as path[:src[:dst[:exclude,...]]]")
    p.add_argument("--resume", action="store_true", help="not ported: raises")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--batch_bins", type=int, default=None)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tensor_parallel", type=int, default=1, help="not ported")
    p.add_argument("--optim_state_shard", action="store_true", help="not ported")
    p.add_argument("--batch_type", default=None)
    p.add_argument("--ckpt_backend", default="npz", choices=["npz", "orbax"])
    return p


def check_supported(args, tcfg) -> None:
    """Raise for the options this slice leaves unported."""
    unported = {
        "--resume": args.resume,
        "--tensor_parallel > 1": args.tensor_parallel != 1,
        "--optim_state_shard": args.optim_state_shard or tcfg.optim_state_shard,
        "--ckpt_backend orbax": args.ckpt_backend == "orbax",
        f"batch_type {args.batch_type or tcfg.batch_type!r}":
            (args.batch_type or tcfg.batch_type) != "numel",
    }
    for what, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


def _bf16_as_f32(arr: np.ndarray) -> np.ndarray:
    """A legacy raw-saved bf16 leaf (numpy dtype V2) -> its float32 values."""
    return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def load_init_params(spec: str, sd: dict, cfg, kind: str = "whisper"
                     ) -> tuple[dict, list[str]]:
    """--init_param with --ignore_init_mismatch semantics (JAX
    `load_init_params`, abs_task.py:1317-1325): (the state dict with what
    the checkpoint holds loaded, the names loaded). The spec is
    `path[:src_prefix[:dst_prefix[:exclude1,exclude2]]]` (espnet2
    load_pretrained_model) over the JAX layout's flat keys."""
    path, src, dst, exclude = (spec.split(":") + ["", "", ""])[:4]
    exclude = tuple(e for e in exclude.split(",") if e)
    if path.endswith((".pt", ".pth")):
        if kind != "whisper":
            raise ValueError(f"{path}: an OpenAI .pt initialises the whisper family only")
        data = numpy_from_params(read_torch_whisper(path, cfg.whisper)[0])
    else:
        with np.load(path) as npz:
            data = {k: npz[k] for k in npz.files}
    if src or dst:
        src_p, dst_p = src + "/" if src else "", dst + "/" if dst else ""
        data = {dst_p + k[len(src_p):]: v for k, v in data.items()
                if not src_p or k == src or k.startswith(src_p)}
    data = {k: _bf16_as_f32(v) if v.dtype.kind == "V" and v.dtype.itemsize == 2 else v
            for k, v in data.items()
            if not any(k == e or k.startswith(e + "/") for e in exclude)}
    if kind == "conformer":
        loaded = conformer_params_from_numpy(data, cfg, strict=False)
    else:
        emb, rows = data.get("decoder/token_emb"), cfg.whisper.n_vocab
        if emb is not None and emb.shape[1:] == (cfg.whisper.n_text_state,) \
                and emb.shape[0] < rows:  # params_from_numpy cuts the longer
            data["decoder/token_emb"] = np.pad(emb, [(0, rows - emb.shape[0]), (0, 0)])
        loaded = params_from_numpy(data, cfg.whisper, strict=False)
    out = dict(sd)
    names = [name for name, t in loaded.items()
             if name in out and out[name].shape == t.shape]
    out.update({name: loaded[name] for name in names})
    logging.info("init_param: loaded %d/%d parameters from %s", len(names), len(sd), path)
    return out, names


@torch.no_grad()
def recalibrate(model: ConformerASR, batches) -> None:
    """Conv BatchNorm running statistics := the mean over `batches` of
    their batch statistics (no SpecAug, no dropout)."""
    stats = [bn_calibration_stats(model, b["speech"], b["speech_lengths"]) for b in batches]
    if stats:
        apply_bn_stats(model.encoder, sum(m for m, _ in stats) / len(stats),
                       sum(v for _, v in stats) / len(stats))


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    raw = apply_overrides(load_yaml(args.config), args.override)
    tcfg = trainer_config_from_dict(raw)
    check_supported(args, tcfg)
    dtype = getattr(torch, args.compute_dtype)
    device = torch.device(args.device)
    task = task_from_dict(raw, compute_dtype=dtype)
    cfg = task.cfg
    optim_cfg = optim_config_from_dict(raw)
    max_epoch = args.max_epoch if args.max_epoch is not None else tcfg.max_epoch
    batch_bins = args.batch_bins if args.batch_bins is not None else tcfg.batch_bins
    freeze = args.freeze_param or tcfg.freeze_param
    if task.kind == "conformer" and freeze:
        raise NotImplementedError("a freeze preset on the conformer family is not ported")
    if task.kind == "whisper":
        check_trainable(cfg)
    if tcfg.freeze_quant not in (None, "none") and not (
            freeze and tcfg.freeze_quant == "int8"):
        raise ValueError(f"unknown freeze_quant {tcfg.freeze_quant!r}"
                         if tcfg.freeze_quant != "int8"
                         else "freeze_quant=int8 requires freeze_param")
    if freeze:
        raw = {**raw, "freeze_param": freeze}
    os.makedirs(args.exp_dir, exist_ok=True)
    dump_resolved(os.path.join(args.exp_dir, "config.yaml"), raw)

    train_ds, valid_ds = ASRDataset(args.train_dir), ASRDataset(args.valid_dir)
    train_lens = {u: train_ds.num_samples(u) for u in train_ds.utt_ids}
    valid_batches = num_elements_batches(
        {u: valid_ds.num_samples(u) for u in valid_ds.utt_ids}, batch_bins)
    logging.info("train: %d utts, valid: %d utts (%d batches)", len(train_ds),
                 len(valid_ds), len(valid_batches))

    sd = task.init_fn(torch.Generator().manual_seed(tcfg.seed), cfg)
    init_param = args.init_param or tcfg.init_param
    init_loaded: list[str] = []
    if init_param:
        sd, init_loaded = load_init_params(init_param, sd, cfg, task.kind)
    if task.kind == "conformer":
        model = ConformerASR.from_state_dict(cfg, sd, device=device,
                                             param_dtype=torch.float32)
        params = list(model.parameters())
        to_numpy = functools.partial(numpy_from_conformer_params, cfg=cfg)
    else:
        model = Whisper.from_state_dict(cfg.whisper, sd, device=device,
                                        param_dtype=torch.float32)
        params = apply_freeze(model, freeze)
        model.cast_frozen_(dtype)
        if tcfg.freeze_quant == "int8":
            model.quantize_frozen_()
            logging.info("freeze_quant=int8: frozen trunk linears quantized")
        to_numpy = numpy_from_params
    logging.info("freeze_param=%s: %.2fM / %.2fM trainable", freeze,
                 sum(p.numel() for p in params) / 1e6,
                 sum(p.numel() for p in model.parameters()) / 1e6)
    optimizer, scheduler = build_optimizer(params, optim_cfg)
    train_step = make_train_step(
        model, cfg, optimizer, scheduler, grad_clip=optim_cfg.grad_clip,
        generator=torch.Generator().manual_seed(tcfg.seed + 1), loss_fn=task.loss_fn)
    eval_step = make_eval_step(model, cfg, loss_fn=task.loss_fn)
    err_calc = ErrorCalculator(train_ds.tokenizer.id_to_token)
    mgr = CheckpointManager(args.exp_dir, keep_nbest=tcfg.keep_nbest_models,
                            criterion=tcfg.best_model_criterion, to_numpy=to_numpy)
    recalibrate_bn = task.kind == "conformer" and cfg.encoder.conv_norm == "batch"

    def batch_of(ds, utts):
        return to_device(collate_batch([ds[u] for u in utts]), device)

    history: dict = {}
    nonfinite = 0  # skipped steps so far (the step's cumulative counter)
    for epoch in range(1, max_epoch + 1):
        t0 = time.time()
        batches = num_elements_batches(train_lens, batch_bins, shuffle_batches=True,
                                       seed=tcfg.seed + epoch)
        train = EpochMean()
        n_steps, nonfinite_before = 0, nonfinite
        for i in range(0, len(batches), tcfg.accum_grad):
            group = batches[i: i + tcfg.accum_grad]
            stats = train_step([batch_of(train_ds, utts) for utts in group])
            nonfinite = int(stats["grad_nonfinite_total"])
            n_steps += 1
            train.add(stats, sum(len(u) for u in group))
            if n_steps % tcfg.log_interval == 0:
                logging.info("train epoch %d step %d: %s", epoch, n_steps,
                             ", ".join(f"{k}={float(v):.4g}" for k, v in sorted(stats.items())))
        if n_steps and nonfinite - nonfinite_before >= n_steps:
            raise RuntimeError(f"epoch {epoch}: all {n_steps} steps had non-finite "
                               "gradients; aborting (check lr/data)")
        if recalibrate_bn:
            recalibrate(model, (batch_of(train_ds, u) for u in batches[:8]))

        valid = EpochMean()
        for utts in valid_batches:
            stats, (ys_hat, ys_out) = eval_step(batch_of(valid_ds, utts))
            stats = {k: float(v) for k, v in stats.items()}
            cer, wer = err_calc(ys_hat.cpu().numpy(), ys_out.cpu().numpy())
            if cer is not None:
                stats["cer"] = cer
            if wer is not None:
                stats["wer"] = wer
            valid.add(stats, len(utts))
        history[epoch] = {"train": train.result(), "valid": valid.result()}
        mgr.save_epoch(epoch, model, history)
        logging.info("epoch %d done in %.1fs: valid %s", epoch, time.time() - t0,
                     ", ".join(f"{k}={v:.4g}" for k, v in sorted(history[epoch]["valid"].items())))
        if tcfg.patience is not None:
            best = mgr.best_epoch(history)
            if best is not None and epoch - best >= int(tcfg.patience):
                logging.info("early stop: no improvement for %s epochs", tcfg.patience)
                break

    ave = mgr.average_nbest(history)
    with open(os.path.join(args.exp_dir, "train_history.json"), "w") as f:
        json.dump({str(k): v for k, v in history.items()}, f, indent=1)
    logging.info("done; n-best average written to %s", ave)
    return {"history": history, "exp_dir": args.exp_dir, "ave": ave,
            "init_loaded": init_loaded}


if __name__ == "__main__":
    main()
