"""Optimizer, LR schedule and gradient clipping (counterpart of
`agacs_tpu/train/optim.py`, the optax chain the JAX trainer builds):

  * WarmupLR (espnet `schedulers/warmup_lr.py:11-50`) as a LambdaLR:
    lr · warmup^0.5 · min(step^-0.5, step · warmup^-1.5), step 1-based;
  * AdamW over the trainable parameters only (the JAX chain masks the
    frozen leaves out);
  * clip by global norm as optax computes it: g · max / ‖g‖ when
    ‖g‖ ≥ max (no +1e-6 in the denominator, unlike torch's clip);
  * the trainer skips a step whose norm is not finite and then advances
    neither the optimizer nor the schedule (optax rolls back its whole
    inner state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optim: str = "adamw"
    lr: float = 1.0e-3
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.99)
    eps: float = 1.0e-6
    scheduler: str = "warmuplr"
    warmup_steps: int = 500
    grad_clip: float = 1.0


def warmup_lr(warmup_steps: int = 25000) -> Callable[[int], float]:
    """LambdaLR factor of WarmupLR; `count` is the number of optimizer
    steps taken so far (0 for the first step), so step = count + 1."""
    def factor(count: int) -> float:
        step = count + 1.0
        return warmup_steps ** 0.5 * min(step ** -0.5, step * warmup_steps ** -1.5)

    return factor


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimConfig):
    """(optimizer, scheduler) over the trainable parameters."""
    params = list(params)
    if cfg.optim == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.lr, betas=tuple(cfg.betas),
                                eps=cfg.eps, weight_decay=cfg.weight_decay)
    elif cfg.optim == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.eps)
    else:
        raise ValueError(f"unknown optimizer {cfg.optim}")
    if cfg.scheduler == "warmuplr":
        factor = warmup_lr(cfg.warmup_steps)
    elif cfg.scheduler in (None, "none", "constant"):
        def factor(count):
            return 1.0
    else:
        raise ValueError(f"unknown scheduler {cfg.scheduler}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def sum_squares(grads: list[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of every gradient as a float64 0-dim tensor: the
    per-tensor norms accumulated in float64 (a float32 sum over a 3.3M-row
    embedding gradient is off by ~5e-5 relative; XLA's pairwise reduction,
    which JAX's norm takes, is not), a few launches."""
    if not grads:
        return torch.zeros((), dtype=torch.float64)
    return torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64)).square().sum()


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, a float32 0-dim tensor."""
    return sum_squares(grads).sqrt().float()


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: float) -> None:
    """optax.clip_by_global_norm, in place: (g / norm) · max when
    norm ≥ max, else unchanged."""
    if norm >= max_norm:
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, max_norm)
