"""Sequence losses of the attention decoder (counterpart of
`agacs_tpu/train/losses.py`): `add_sos_eos`, the KL-form label-smoothed
CE, token accuracy. Same formulas, same ignore/eos padding."""

from __future__ import annotations

import math

import torch

IGNORE_ID = -1


def add_sos_eos(ys_pad: torch.Tensor, sos: int, eos: int,
                ignore_id: int = IGNORE_ID) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T) ignore-padded targets -> (ys_in, ys_out), each (B, T+1):
    ys_in = [sos, y...] with ignore positions replaced by eos; ys_out =
    [y..., eos] padded with ignore_id. Each row's valid tokens are a
    prefix."""
    b, t = ys_pad.shape
    valid = ys_pad != ignore_id
    lens = valid.sum(1)
    sos_col = torch.full((b, 1), sos, dtype=ys_pad.dtype, device=ys_pad.device)
    ys_in = torch.cat([sos_col, torch.where(valid, ys_pad, eos)], dim=1)
    ys_out = torch.cat([ys_pad, torch.full_like(sos_col, ignore_id)], dim=1)
    pos = torch.arange(t + 1, device=ys_pad.device)[None, :]
    ys_out = torch.where(pos == lens[:, None], eos, ys_out)
    ys_out = torch.where(pos > lens[:, None], ignore_id, ys_out)
    return ys_in, ys_out


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1, ignore_id: int = IGNORE_ID,
                         normalize_length: bool = False) -> torch.Tensor:
    """KL(true_dist || softmax(logits)) summed over classes and tokens,
    true_dist = smoothing/(V-1) off-target and 1-smoothing on it, divided
    by the batch size (or the valid token count). Expanded with the lse
    (JAX :49-88), so no (N, V) log-softmax is kept for the backward:
    sum_c log_softmax(x)_c = sum_c x_c - V lse(x)."""
    b, t, v = logits.shape
    x = logits.reshape(-1, v)
    tgt = targets.reshape(-1)
    ignore = tgt == ignore_id
    tgt_safe = torch.where(ignore, 0, tgt)
    off = smoothing / (v - 1)
    conf = 1.0 - smoothing
    entropy = (v - 1) * off * math.log(off) + conf * math.log(conf)
    lse = torch.logsumexp(x, dim=-1)
    row_sum = x.sum(-1)
    x_t = x.gather(-1, tgt_safe[:, None]).squeeze(-1)
    cross = off * (row_sum - v * lse) + (conf - off) * (x_t - lse)
    kl = torch.where(ignore, 0.0, entropy - cross)
    denom = max(int((~ignore).sum()), 1) if normalize_length else b
    return kl.sum() / denom


def th_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Argmax accuracy over the non-ignored positions."""
    mask = targets != ignore_id
    correct = ((logits.argmax(-1) == targets) & mask).sum()
    return correct / mask.sum().clamp(min=1)
