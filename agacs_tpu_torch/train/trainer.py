"""Train and eval steps (counterpart of `agacs_tpu/train/trainer.py`
`make_train_step` / `make_eval_step`, the reference Trainer's semantics,
`espnet2/train/trainer.py:479-748`):

  * one optimizer step per call over a list of micro-batches: their
    gradients are summed and divided by their count (the JAX step averages
    over its accum_grad axis);
  * only parameters with requires_grad (the freeze preset's trainable set)
    get a gradient: autograd computes none for the frozen trunk;
  * the global gradient norm is the stat `grad_norm`; a step whose norm is
    not finite is skipped (no update, schedule not advanced) and counted
    in `grad_nonfinite_total`; otherwise clip to `grad_clip`, AdamW step,
    schedule step.

The int8 frozen trunk: JAX's `quantize_frozen_linears` (:94-129) is
`Whisper.quantize_frozen_`, run in place after `cast_frozen_`; the
trainable set, and so the optimizer, is unchanged. `dequantize_params` is
its inverse on a state dict (JAX :132-148).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.whisper import Whisper
from agacs_tpu_torch.ops.int8_linear import dequantize_weight
from agacs_tpu_torch.train.optim import clip_by_global_norm_, global_norm


def dequantize_params(state_dict: dict) -> dict:
    """Every `*.weight_q` / `*.weight_s` pair becomes a float32 `*.weight`
    in nn.Linear's (out, in) layout; everything else passes through."""
    out = {}
    for name, t in state_dict.items():
        if name.endswith(".weight_q"):
            base = name[: -len("_q")]
            out[base] = dequantize_weight(t, state_dict[base + "_s"]).t().contiguous()
        elif not name.endswith(".weight_s"):
            out[name] = t
    return out


def make_train_step(
    model: Whisper,
    cfg: ASRModelConfig,
    optimizer: torch.optim.Optimizer,
    scheduler,
    grad_clip: float = 1.0,
    generator: torch.Generator | None = None,
    loss_fn: Callable | None = None,
) -> Callable[[list[dict]], dict]:
    """step(micro_batches) -> stats (0-dim tensors on the model's device:
    the means over micro-batches of the loss function's stats, plus
    grad_norm and grad_nonfinite_total). `generator` draws SpecAug (and
    seeds dropout); `loss_fn` is the task's (JAX `loss_fn`; default the
    whisper `asr_model.forward`)."""
    fwd = loss_fn or asr_model.forward
    params = [p for group in optimizer.param_groups for p in group["params"]]
    nonfinite = [0]

    def step(micro_batches: list[dict]) -> dict:
        for p in params:
            p.grad = None
        totals: dict = {}
        for mb in micro_batches:
            loss, stats = fwd(model, cfg, mb, train=True, generator=generator)
            loss.backward()
            for k, v in stats.items():
                totals[k] = totals.get(k, 0.0) + v.detach().float()
        n = len(micro_batches)
        for p in params:
            if p.grad is None:  # a trainable leaf the loss does not reach
                p.grad = torch.zeros_like(p)
            elif n > 1:
                p.grad.div_(n)
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        norm = float(gnorm)  # the step's one wait for the device
        if math.isfinite(norm):
            if grad_clip:
                clip_by_global_norm_(grads, grad_clip, norm)
            optimizer.step()
            scheduler.step()
        else:
            nonfinite[0] += 1
        stats = {k: v / n for k, v in totals.items()}
        stats["grad_norm"] = gnorm
        stats["grad_nonfinite_total"] = torch.tensor(nonfinite[0])
        return stats

    return step


def make_eval_step(model: Whisper, cfg: ASRModelConfig, loss_fn: Callable | None = None,
                   return_preds: bool = True) -> Callable:
    """step(batch) -> (stats, (argmax ids, ys_out)), or stats alone without
    `return_preds`; no gradient, no SpecAug."""
    fwd = loss_fn or asr_model.forward

    @torch.no_grad()
    def step(batch: dict):
        if not return_preds:
            return fwd(model, cfg, batch, train=False)[1]
        _, stats, preds = fwd(model, cfg, batch, train=False, return_preds=True)
        return stats, preds

    return step


class EpochMean:
    """Per-epoch weighted means of step stats (weights: utterances), as
    JAX's Reporter keeps them."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.weight = 0

    def add(self, stats: dict, weight: int) -> None:
        for k, v in stats.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * weight
        self.weight += weight

    def result(self) -> dict:
        return {k: v / max(self.weight, 1) for k, v in self.sums.items()}
