"""LM training CLI (counterpart of `agacs_tpu/bin/lm_train.py`; the
conformer recipe's stage 2, `recipes/seame/run_conformer.sh`): the
transformer LM that joint decoding fuses.

  python -m agacs_tpu_torch.bin.lm_train --train_text data/train/text \\
      --valid_text data/valid/text --exp_dir exp/lm \\
      [--d_model 512 --num_blocks 16 --max_epoch 15 ...] [--device cuda]

Texts are tokenized to Whisper ids with the dual-language prompt, sorted
longest first and packed into batches of at most `batch_tokens` padded
tokens (widths rounded up to 8), as JAX's `_batches`. One AdamW step per
batch (WarmupLR, clip 1.0, the non-finite skip: `train/trainer.py`), the
float32 masters under the compute dtype, then a valid pass. Writes
`config.yaml` (`lm_conf`, what `bin.decode --lm_exp` reads), the 3 best
`{n}epoch.params.npz` by valid loss, their average
`valid.loss.ave.params.npz` (JAX's layout: both packages load it) and
`train_history.json`.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os

import numpy as np
import torch

from agacs_tpu_torch.data.io import read_scp
from agacs_tpu_torch.models.checkpoint import numpy_from_lm_params
from agacs_tpu_torch.models.lm import TransformerLM, TransformerLMConfig, init_lm_params, lm_loss
from agacs_tpu_torch.text.tokenizer import WhisperTokenIdConverter, WhisperTokenizer
from agacs_tpu_torch.train.checkpoint import CheckpointManager
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import EpochMean, make_eval_step, make_train_step
from agacs_tpu_torch.utils.config import dump_resolved


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train_text", required=True)
    p.add_argument("--valid_text", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--attention_heads", type=int, default=8)
    p.add_argument("--linear_units", type=int, default=2048)
    p.add_argument("--num_blocks", type=int, default=16)
    p.add_argument("--max_epoch", type=int, default=15)
    p.add_argument("--batch_tokens", type=int, default=8192)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup_steps", type=int, default=25000)
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    return p


def text_batches(path: str, conv: WhisperTokenIdConverter, tok: WhisperTokenizer,
                 batch_tokens: int) -> list[np.ndarray]:
    """(B, T) int64 -1-padded id arrays (JAX `_batches`)."""
    seqs = [conv.tokens2ids(tok.text2tokens(t)) for t in read_scp(path).values() if t.strip()]
    seqs.sort(key=len, reverse=True)
    batches, cur, cur_max = [], [], 0
    for s in seqs:
        m = max(cur_max, len(s))
        if cur and m * (len(cur) + 1) > batch_tokens:
            batches.append(cur)
            cur, cur_max, m = [], 0, len(s)
        cur.append(s)
        cur_max = m
    if cur:
        batches.append(cur)
    out = []
    for b in batches:
        t = -(-max(len(s) for s in b) // 8) * 8
        arr = np.full((len(b), t), -1, np.int64)
        for i, s in enumerate(b):
            arr[i, : len(s)] = s[:t]
        out.append(arr)
    return out


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = torch.device(args.device)
    cfg = TransformerLMConfig(d_model=args.d_model, attention_heads=args.attention_heads,
                              linear_units=args.linear_units, num_blocks=args.num_blocks,
                              compute_dtype=getattr(torch, args.compute_dtype))
    os.makedirs(args.exp_dir, exist_ok=True)
    dump_resolved(os.path.join(args.exp_dir, "config.yaml"), {"lm_conf": {
        "d_model": cfg.d_model, "attention_heads": cfg.attention_heads,
        "linear_units": cfg.linear_units, "num_blocks": cfg.num_blocks,
        "vocab_size": cfg.vocab_size}})
    tok = WhisperTokenizer()
    conv = WhisperTokenIdConverter(tok)
    train_b = text_batches(args.train_text, conv, tok, args.batch_tokens)
    valid_b = text_batches(args.valid_text, conv, tok, args.batch_tokens)
    logging.info("train %d batches, valid %d batches", len(train_b), len(valid_b))

    sd = init_lm_params(torch.Generator().manual_seed(args.seed), cfg)
    model = TransformerLM.from_state_dict(cfg, sd, device=device, param_dtype=torch.float32)
    optim_cfg = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps)
    optimizer, scheduler = build_optimizer(model.parameters(), optim_cfg)
    step = make_train_step(model, cfg, optimizer, scheduler, grad_clip=optim_cfg.grad_clip,
                           loss_fn=lm_loss)
    evaluate = make_eval_step(model, cfg, loss_fn=lm_loss, return_preds=False)
    mgr = CheckpointManager(args.exp_dir, keep_nbest=3, criterion=("valid", "loss", "min"),
                            to_numpy=functools.partial(numpy_from_lm_params, cfg=cfg))

    def batch(arr):
        return {"text": torch.from_numpy(arr).to(device)}

    history: dict = {}
    for epoch in range(1, args.max_epoch + 1):
        train, valid = EpochMean(), EpochMean()
        for arr in train_b:
            stats = step([batch(arr)])
            train.add(stats, len(arr))
        for arr in valid_b:
            valid.add(evaluate(batch(arr)), len(arr))
        history[epoch] = {"train": train.result(), "valid": valid.result()}
        mgr.save_epoch(epoch, model, history)
        logging.info("epoch %d: train loss %.4f, valid loss %.4f", epoch,
                     history[epoch]["train"]["loss"], history[epoch]["valid"]["loss"])
    ave = mgr.average_nbest(history)
    with open(os.path.join(args.exp_dir, "train_history.json"), "w") as f:
        json.dump({str(k): v for k, v in history.items()}, f, indent=1)
    return {"history": history, "ave": ave}


if __name__ == "__main__":
    main()
