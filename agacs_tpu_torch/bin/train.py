"""Training CLI (counterpart of `agacs_tpu/bin/train.py`): the whisper
family and the conformer recipe's hybrid CTC/attention model
(`recipes/seame/run_conformer.sh` stage 3).

  python -m agacs_tpu_torch.bin.train \\
      --config recipes/seame/conf/train_asr_whisper_small_adapter_csloss_2stage.yaml \\
      --train_dir data/train --valid_dir data/valid --exp_dir exp/x \\
      [--init_param exp/stage1/valid.acc.ave.params.npz] [--max_epoch N] \\
      [--batch_bins N] [--override model_conf.cs_weight=0.02 ...] \\
      [--freeze_param adapter] [--compute_dtype bfloat16] [--device cuda]

One process, one device. Per epoch: the train set's batches (`--batch_type`
numel, sorted, unsorted, folded, length or fixed_shapes, JAX's samplers;
shuffled by seed + epoch), padded as JAX's CLI pads them (speech to the
sampler's bucket of the longest utterance, text to a multiple of 8), read,
augmented and collated up to 2 batches ahead by `data/prefetch.py` (on the
card into pinned memory, copied on a side stream); one optimizer step per
`accum_grad` consecutive batches (a shorter group at the epoch's end steps
with what it has); then a valid pass with CER/WER from the teacher-forced
argmax. `train/reporter.Reporter` keeps each phase's weighted means and
its `iter_time` / `step_time` (`step_time` closes once the step's stats
are host floats). After each epoch: `{n}epoch.params.npz` kept for the n
best `valid.acc`, the resume point (`checkpoint.params.npz`,
`checkpoint.opt.npz`, `checkpoint_meta.json`, JAX's layout), TensorBoard
scalars (`tensorboard/`), `metrics.jsonl`, history curves (`images/`) and
`--num_att_plot` attention maps (`att_ws/`; plots need matplotlib, and
without it are skipped with one log line). At the end: the n-best average
`valid.acc.ave.params.npz` and `train_history.json`. `config.yaml` is the
resolved config, which `agacs_tpu_torch.bin.decode --config` reads. The
npz files hold the JAX package's flat layout, so `agacs_tpu` loads them
too, and `--resume` continues an exp_dir either package wrote.

The config's `rir_scp` / `noise_scp` / `noise_db_range` /
`speech_volume_normalize` keys turn on the train set's RIR and noise
augmentation (`data/augment.py`); its batches are then built in one
thread, so the augmentation's draws follow the batch order.
`--print_config` prints the resolved config and exits; `--detect_anomaly`
runs autograd's anomaly detection.

`--init_param` takes JAX's spec `path[:src[:dst[:exclude,...]]]` over a
`.params.npz` or, for the whisper family, an OpenAI `.pt`
(`models/checkpoint.read_torch_whisper`, its leaves put in the npz layout
first): the keys under `src` load into `dst`, the leaves under an
`exclude` prefix are skipped, and what is missing or mismatched keeps its
init. Raw-bf16 (`V2`) leaves are read as bf16, a `token_emb` with another
row count is cut or zero-padded to the model's.

Not ported, and raising NotImplementedError: the multi-device options
--tensor_parallel > 1, --optim_state_shard and --ckpt_backend orbax; a
freeze preset on the conformer family, and the transducer family.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import logging
import os
import time

import numpy as np
import torch

from agacs_tpu_torch.data.augment import augment_from_dict
from agacs_tpu_torch.data.collate import collate_batch, to_device
from agacs_tpu_torch.data.dataset import ASRDataset
from agacs_tpu_torch.data.prefetch import HostToDevice, prefetch_batches
from agacs_tpu_torch.data.sampler import (
    bucket_length,
    fixed_shape_batches,
    folded_batches,
    geometric_s_buckets,
    length_batches,
    num_elements_batches,
    sorted_batches,
    unsorted_batches,
)
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
from agacs_tpu_torch.train.checkpoint import CheckpointManager, TrainState
from agacs_tpu_torch.train.error_calculator import ErrorCalculator
from agacs_tpu_torch.train.freeze import apply_freeze
from agacs_tpu_torch.train.observability import (
    TensorboardWriter,
    WandbSink,
    plot_attention_epoch,
    plot_history,
)
from agacs_tpu_torch.train.optim import build_optimizer
from agacs_tpu_torch.train.reporter import Reporter
from agacs_tpu_torch.train.trainer import make_eval_step, make_train_step
from agacs_tpu_torch.utils.config import (
    apply_overrides,
    dump_resolved,
    load_yaml,
    optim_config_from_dict,
    task_from_dict,
    trainer_config_from_dict,
)

BATCH_TYPES = ("numel", "sorted", "unsorted", "folded", "length", "fixed_shapes")
# JAX's single-device batch-size grid (agacs_tpu/bin/train.py:236), which
# fixed_shapes' closed (B, S) set is built on; numel packs with grid 1
FIXED_SHAPES_B_GRID = 8
LOOKAHEAD = 2  # batches built ahead of the step (JAX's prefetch_batches)


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
    p.add_argument("--resume", action="store_true",
                   help="continue exp_dir from its last epoch (checkpoint.params.npz, "
                        "checkpoint.opt.npz, checkpoint_meta.json; written by this "
                        "package or the JAX one)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--batch_bins", type=int, default=None)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="multi-device: not ported, raises above 1")
    p.add_argument("--optim_state_shard", action="store_true",
                   help="multi-device: not ported, raises")
    p.add_argument("--batch_type", default=None, choices=BATCH_TYPES,
                   help="overrides the config's batch_type: numel (padded-numel "
                        "packing under batch_bins), sorted / unsorted (batch_size "
                        "utterances), folded (batch_size shrunk by fold_length), "
                        "length (summed lengths under batch_bins), fixed_shapes "
                        "(geometric speech buckets at shape_ratio, B from the bucket)")
    p.add_argument("--print_config", action="store_true",
                   help="print the resolved config (abs_task.py:1019-1024) and exit")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): fail at the op "
                        "that makes a NaN (abs_task.py:1140-1142)")
    p.add_argument("--ckpt_backend", default="npz", choices=["npz", "orbax"],
                   help="orbax (sharded multi-host checkpoints): not ported, raises")
    p.add_argument("--num_att_plot", type=int, default=3,
                   help="attention-map PNGs per eval epoch (trainer.py:802+; 0 "
                        "disables)")
    return p


def check_supported(args, tcfg) -> None:
    """Raise for the multi-device options, which this port leaves out."""
    unported = {
        "--tensor_parallel > 1": args.tensor_parallel != 1,
        "--optim_state_shard": args.optim_state_shard or tcfg.optim_state_shard,
        "--ckpt_backend orbax": args.ckpt_backend == "orbax",
    }
    for what, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


def resolved_config(raw: dict, compute_dtype: torch.dtype) -> dict:
    """The config `--print_config` prints (JAX :178-201): the raw config and
    `_resolved_model_config`, the model config's fields, each value that is
    no str, number, bool or None as its str()."""
    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        if isinstance(x, (str, int, float, bool)) or x is None:
            return x
        return str(x)

    cfg = task_from_dict(raw, compute_dtype=compute_dtype).cfg
    return {**raw, "_resolved_model_config": clean(
        dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else str(cfg))}


def batch_sampler(batch_type: str, tcfg, batch_bins: int):
    """(sample_epoch(ds, lens, shuffle, seed) -> batches, s_pad_of(longest
    utterance) -> padded speech length), JAX's CLI's pair (:246-326)."""
    if batch_type not in BATCH_TYPES:
        raise ValueError(f"unknown batch_type {batch_type!r}; have {BATCH_TYPES}")
    if batch_type == "fixed_shapes":
        buckets = geometric_s_buckets(ratio=tcfg.shape_ratio)

        def sample_epoch(ds, lens, shuffle=False, seed=0):
            return fixed_shape_batches(lens, batch_bins, b_grid=FIXED_SHAPES_B_GRID,
                                       shuffle_batches=shuffle, seed=seed,
                                       ratio=tcfg.shape_ratio)

        def s_pad_of(mx):
            return next((s for s in buckets if mx <= s), buckets[-1])

        return sample_epoch, s_pad_of
    if batch_type == "numel":
        def sample_epoch(ds, lens, shuffle=False, seed=0):
            return num_elements_batches(lens, batch_bins, shuffle_batches=shuffle, seed=seed)
    else:
        def sample_epoch(ds, lens, shuffle=False, seed=0):
            if batch_type == "sorted":
                batches = sorted_batches(lens, tcfg.batch_size)
            elif batch_type == "unsorted":
                batches = unsorted_batches(list(lens), tcfg.batch_size)
            else:
                tok_lens = {u: ds.num_tokens(u) for u in lens}
                if batch_type == "folded":
                    batches = folded_batches([lens, tok_lens], tcfg.batch_size,
                                             list(tcfg.fold_length))
                else:
                    batches = length_batches([lens, tok_lens], batch_bins)
            if shuffle:
                np.random.RandomState(seed).shuffle(batches)
            return batches

    def s_pad_of(mx):
        return bucket_length(mx, 16000, 30 * 16000)

    return sample_epoch, s_pad_of


def make_batch(ds: ASRDataset, utts: list[str], s_pad_of, feeder: HostToDevice):
    """A batch as JAX's CLI pads it (:442-471): speech to s_pad_of(the
    longest utterance), text to a multiple of 8, from the length tables."""
    s_pad = s_pad_of(max(ds.num_samples(u) for u in utts))
    t_pad = bucket_length(max(ds.num_tokens(u) for u in utts), 8, None)
    return feeder.collate([ds[u] for u in utts], pad_to=(s_pad, t_pad))


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
    dtype = getattr(torch, args.compute_dtype)
    if args.print_config:
        import yaml

        print(yaml.safe_dump(resolved_config(raw, dtype), allow_unicode=True,
                             default_flow_style=False, sort_keys=False))
        return {"printed": True}
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    tcfg = trainer_config_from_dict(raw)
    check_supported(args, tcfg)
    device = torch.device(args.device)
    task = task_from_dict(raw, compute_dtype=dtype)
    cfg = task.cfg
    optim_cfg = optim_config_from_dict(raw)
    max_epoch = args.max_epoch if args.max_epoch is not None else tcfg.max_epoch
    batch_bins = args.batch_bins if args.batch_bins is not None else tcfg.batch_bins
    batch_type = args.batch_type or tcfg.batch_type
    freeze = args.freeze_param or tcfg.freeze_param
    if task.kind == "conformer" and freeze:
        raise NotImplementedError("a freeze preset on the conformer family is not ported")
    if tcfg.freeze_quant not in (None, "none") and not (
            freeze and tcfg.freeze_quant == "int8"):
        raise ValueError(f"unknown freeze_quant {tcfg.freeze_quant!r}"
                         if tcfg.freeze_quant != "int8"
                         else "freeze_quant=int8 requires freeze_param")
    if freeze:
        raw = {**raw, "freeze_param": freeze}
    os.makedirs(args.exp_dir, exist_ok=True)
    dump_resolved(os.path.join(args.exp_dir, "config.yaml"), raw)

    cs_mode = getattr(cfg, "cs_loss_type", "attention")
    augment = augment_from_dict(raw, seed=tcfg.seed)
    train_ds = ASRDataset(args.train_dir, augment=augment, cs_label_mode=cs_mode)
    valid_ds = ASRDataset(args.valid_dir, cs_label_mode=cs_mode)
    train_lens = {u: train_ds.num_samples(u) for u in train_ds.utt_ids}
    valid_lens = {u: valid_ds.num_samples(u) for u in valid_ds.utt_ids}
    sample_epoch, s_pad_of = batch_sampler(batch_type, tcfg, batch_bins)
    valid_batches = sample_epoch(valid_ds, valid_lens)
    logging.info("train: %d utts, valid: %d utts (%d batches), batch_type %s%s",
                 len(train_ds), len(valid_ds), len(valid_batches), batch_type,
                 ", RIR/noise augmentation (one batch thread)" if augment else "")

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
        from_numpy = functools.partial(conformer_params_from_numpy, cfg=cfg)
    else:
        model = Whisper.from_state_dict(cfg.whisper, sd, device=device,
                                        param_dtype=torch.float32)
        params = apply_freeze(model, freeze)
        model.cast_frozen_(dtype)
        if tcfg.freeze_quant == "int8":
            model.quantize_frozen_()
            logging.info("freeze_quant=int8: frozen trunk linears quantized")
        to_numpy = numpy_from_params
        from_numpy = functools.partial(params_from_numpy, cfg=cfg.whisper)
    logging.info("freeze_param=%s: %.2fM / %.2fM trainable", freeze,
                 sum(p.numel() for p in params) / 1e6,
                 sum(p.numel() for p in model.parameters()) / 1e6)
    optimizer, scheduler = build_optimizer(params, optim_cfg)
    state = TrainState(optimizer, scheduler,
                       {n: p for n, p in model.named_parameters() if p.requires_grad},
                       optim_cfg, torch.Generator().manual_seed(tcfg.seed + 1), tcfg.seed)
    mgr = CheckpointManager(args.exp_dir, keep_nbest=tcfg.keep_nbest_models,
                            criterion=tcfg.best_model_criterion, to_numpy=to_numpy,
                            from_numpy=from_numpy)
    start_epoch, history = 1, {}
    if args.resume:
        start_epoch, history = mgr.resume(model, state)
        logging.info("resumed at epoch %d (step %d)", start_epoch, state.step)
    train_step = make_train_step(
        model, cfg, optimizer, scheduler, grad_clip=optim_cfg.grad_clip,
        generator=state.generator, loss_fn=task.loss_fn, nonfinite=state.nonfinite)
    eval_step = make_eval_step(model, cfg, loss_fn=task.loss_fn)
    err_calc = ErrorCalculator(train_ds.tokenizer.id_to_token)
    recalibrate_bn = task.kind == "conformer" and cfg.encoder.conv_norm == "batch"

    tb = TensorboardWriter(os.path.join(args.exp_dir, "tensorboard"))
    wandb_sink = WandbSink(args.exp_dir)
    att_utts = valid_ds.utt_ids[: max(args.num_att_plot, 0)]
    plots = True  # False once matplotlib fails to import
    reporter = Reporter()
    reporter.history = history
    feeder = HostToDevice(device)

    def run_batches(ds, batch_ids, sub, train, threads):
        groups = ([batch_ids[i: i + tcfg.accum_grad]
                   for i in range(0, len(batch_ids), tcfg.accum_grad)]
                  if train else [[u] for u in batch_ids])

        def make_group(group):
            return [make_batch(ds, utts, s_pad_of, feeder) for utts in group]

        made_groups = prefetch_batches(make_group, groups, lookahead=LOOKAHEAD,
                                       num_threads=threads)
        for n, (group, made) in enumerate(zip(groups, made_groups), 1):
            with sub.measure_time("iter_time"):
                with sub.measure_time("step_time"):
                    if train:
                        stats = train_step([feeder.ready(m) for m in made])
                        preds = None
                    else:
                        stats, preds = eval_step(feeder.ready(made[0]))
                    stats = {k: float(v) for k, v in stats.items()}
            if train:
                state.step += 1
                state.nonfinite = int(stats["grad_nonfinite_total"])
            else:
                ys_hat, ys_out = preds
                cer, wer = err_calc(ys_hat.cpu().numpy(), ys_out.cpu().numpy())
                if cer is not None:
                    stats["cer"] = cer
                if wer is not None:
                    stats["wer"] = wer
            sub.register(stats, weight=sum(len(u) for u in group))
            if n % tcfg.log_interval == 0:
                logging.info("%s epoch %d step %d/%d: %s", sub.phase, sub.epoch, n,
                             len(groups), ", ".join(f"{k}={v:.4g}"
                                                    for k, v in sorted(stats.items())))
        return len(groups)

    for epoch in range(start_epoch, max_epoch + 1):
        t0 = time.time()
        batches = sample_epoch(train_ds, train_lens, shuffle=True, seed=tcfg.seed + epoch)
        sub = reporter.start_epoch("train", epoch)
        nonfinite_before = state.nonfinite
        n_steps = run_batches(train_ds, batches, sub, True, 1 if augment else 2)
        reporter.finish_epoch(sub)
        if n_steps and state.nonfinite - nonfinite_before >= n_steps:
            raise RuntimeError(f"epoch {epoch}: all {n_steps} steps had non-finite "
                               "gradients; aborting (check lr/data)")
        if recalibrate_bn:
            recalibrate(model, (to_device(collate_batch([train_ds[u] for u in utts]), device)
                                for utts in batches[:8]))
        sub = reporter.start_epoch("valid", epoch)
        run_batches(valid_ds, valid_batches, sub, False, 2)
        reporter.finish_epoch(sub)
        mgr.save_epoch(epoch, model, history, state)

        # observability sinks (trainer.py:254-265, 802+; reporter plots)
        tb.add_scalars(epoch, {f"{ph}/{k}": v for ph, d in history[epoch].items()
                               for k, v in d.items()})
        wandb_sink.log_epoch(epoch, history[epoch])
        if plots:
            try:
                plot_history(history, os.path.join(args.exp_dir, "images"))
            except ImportError as e:
                plots = False
                logging.info("plots skipped: %s", e)
        if plots and att_utts and task.kind == "whisper":
            try:
                plot_attention_epoch(model, cfg, valid_ds, att_utts, args.exp_dir, epoch)
            except Exception as e:  # plotting must never kill training
                logging.warning("attention plots failed: %s", e)
        logging.info("epoch %d done in %.1fs: valid %s", epoch, time.time() - t0,
                     ", ".join(f"{k}={v:.4g}" for k, v in sorted(history[epoch]["valid"].items())))
        if tcfg.patience is not None:
            best = mgr.best_epoch(history)
            if best is not None and epoch - best >= int(tcfg.patience):
                logging.info("early stop: no improvement for %s epochs", tcfg.patience)
                break

    tb.close()
    ave = mgr.average_nbest(history)
    reporter.dump(os.path.join(args.exp_dir, "train_history.json"))
    wandb_sink.log_artifact(ave, kind="model")
    logging.info("done; n-best average written to %s", ave)
    return {"history": history, "exp_dir": args.exp_dir, "ave": ave,
            "init_loaded": init_loaded}


if __name__ == "__main__":
    main()
