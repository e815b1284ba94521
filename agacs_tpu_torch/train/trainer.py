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

On a mesh (`parallel/mesh.Parallel`) each data rank runs its row block:
the loss function is handed `par` (global token accuracy, global batch
statistics, SpecAug drawn at the global batch), the trainable gradients
are averaged over "data" in one all-reduce, the global norm counts each
tensor-parallel shard once (their squares summed over "model"), every
rank takes the same skip decision (an all-reduce of the non-finite flag),
the step's stats are averaged over "data" (acc is global already), and
with ZeRO-1 (`parallel/zero.Zero1`) the optimizer steps this rank's
slices and the parameters are all-gathered.

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
from agacs_tpu_torch.parallel.mesh import SINGLE, Parallel
from agacs_tpu_torch.train.optim import clip_by_global_norm_, global_norm, sum_squares

GLOBAL_STATS = ("acc",)  # computed over the global batch by the loss function


def mean_stats(stats: dict, par: Parallel) -> dict:
    """A step's stats averaged over the data ranks (one all-reduce); those
    in GLOBAL_STATS are every rank's already."""
    if par.mesh is None:
        return stats
    keys = [k for k in stats if k not in GLOBAL_STATS]
    if keys:
        vec = torch.stack([torch.as_tensor(stats[k]).float() for k in keys])
        par.all_reduce(vec, "data", "mean")
        stats = {**stats, **dict(zip(keys, vec.unbind()))}
    return stats


def all_reduce_grads(grads: list[torch.Tensor], par: Parallel) -> None:
    """The gradients averaged over "data", in one flat all-reduce."""
    if par.mesh is None or not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    par.all_reduce(flat, "data", "mean")
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def parallel_global_norm(grads: list[torch.Tensor], sharded: list[bool],
                         par: Parallel) -> torch.Tensor:
    """`global_norm` with each tensor-parallel shard counted once: the
    sharded gradients' squares summed over "model", the replicated ones
    taken once."""
    if par.mesh is None or not any(sharded):
        return global_norm(grads)
    sq_rep = sum_squares([g for g, s in zip(grads, sharded) if not s]).to(grads[0].device)
    sq_shd = sum_squares([g for g, s in zip(grads, sharded) if s]).reshape(1)
    return (sq_rep + par.all_reduce(sq_shd, "model")[0]).sqrt().float()


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
    nonfinite: int = 0,
    par: Parallel = SINGLE,
    zero=None,
) -> Callable[[list[dict]], dict]:
    """step(micro_batches) -> stats (0-dim tensors on the model's device:
    the means over micro-batches of the loss function's stats, plus
    grad_norm and grad_nonfinite_total, the skipped steps so far counted
    from `nonfinite` (a resumed run's)). `generator` draws SpecAug (and
    seeds dropout); `loss_fn` is the task's (JAX `loss_fn`; default the
    whisper `asr_model.forward`). `par`: the mesh (each micro-batch this
    rank's rows); `zero`: a `parallel/zero.Zero1` whose slices `optimizer`
    steps."""
    fwd = loss_fn or asr_model.forward
    params = (list(zero.named.values()) if zero is not None
              else [p for group in optimizer.param_groups for p in group["params"]])
    tp_ids = {id(p) for n, p in model.named_parameters() if n in getattr(model, "tp_dims", {})}
    sharded = [id(p) in tp_ids for p in params]
    kw = {} if par.mesh is None else {"par": par}
    nonfinite = [nonfinite]

    def step(micro_batches: list[dict]) -> dict:
        for p in params:
            p.grad = None
        totals: dict = {}
        for mb in micro_batches:
            loss, stats = fwd(model, cfg, mb, train=True, generator=generator, **kw)
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
        all_reduce_grads(grads, par)
        gnorm = parallel_global_norm(grads, sharded, par)
        norm = float(gnorm)  # the step's one wait for the device
        skip = not math.isfinite(norm)
        if par.mesh is not None:  # every rank takes the same decision
            flag = torch.tensor([float(skip)], device=gnorm.device)
            skip = bool(par.all_reduce(flag, "world", "max").item())
        if not skip:
            if grad_clip:
                clip_by_global_norm_(grads, grad_clip, norm)
            if zero is not None:
                zero.load_grads()
            optimizer.step()
            if zero is not None:
                zero.publish()
            scheduler.step()
        else:
            nonfinite[0] += 1
        stats = mean_stats({k: v / n for k, v in totals.items()}, par)
        stats["grad_norm"] = gnorm
        stats["grad_nonfinite_total"] = torch.tensor(nonfinite[0])
        return stats

    return step


def make_eval_step(model: Whisper, cfg: ASRModelConfig, loss_fn: Callable | None = None,
                   return_preds: bool = True, par: Parallel = SINGLE) -> Callable:
    """step(batch) -> (stats, (argmax ids, ys_out)), or stats alone without
    `return_preds`; no gradient, no SpecAug. On a mesh the stats are
    averaged over "data" as the train step's are; the predictions stay
    this rank's rows."""
    fwd = loss_fn or asr_model.forward
    kw = {} if par.mesh is None else {"par": par}

    @torch.no_grad()
    def step(batch: dict):
        if not return_preds:
            return mean_stats(fwd(model, cfg, batch, train=False, **kw)[1], par)
        _, stats, preds = fwd(model, cfg, batch, train=False, return_preds=True, **kw)
        return mean_stats(stats, par), preds

    return step


class EpochMean:
    """Per-epoch weighted means of step stats (weights: utterances), as
    JAX's Reporter keeps them (the LM trainer's; `bin.train` keeps
    `train/reporter.Reporter`)."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.weight = 0

    def add(self, stats: dict, weight: int) -> None:
        for k, v in stats.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * weight
        self.weight += weight

    def result(self) -> dict:
        return {k: v / max(self.weight, 1) for k, v in self.sums.items()}
