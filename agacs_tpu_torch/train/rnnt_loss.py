"""RNN-Transducer loss (counterpart of `agacs_tpu/train/rnnt_loss.py`, the
reference's warprnnt criterion, `espnet2/asr/espnet_model.py:122-130`).

The forward variable obeys

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1])

For a fixed label row u that is a first-order linear recurrence along time
in the log semiring, x_t = logaddexp(x_{t-1} + c_t, b_t), whose closed form
is x_t = C_t + logcumsumexp_t(b - C) with C = cumsum(c). So each row is one
`torch.cumsum` and one `torch.logcumsumexp` over T, and the loss is a loop
over the U+1 label rows (a handful of launches a row), not over the T x U
lattice cells or the T frames. Gradients come from autograd.

`fastemit_lambda` > 0 is FastEmit (Yu et al. 2021) with warprnnt's
semantics: the forward-identity term emit + λ (emit - emit.detach()) leaves
the loss value as it is and scales the emission arcs' gradients by 1 + λ.
"""

from __future__ import annotations

import torch


def rnnt_alpha(log_probs: torch.Tensor, targets: torch.Tensor, blank: int = 0,
               fastemit_lambda: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward lattice of joint log-probs (B, T, U+1, V) and targets
    (B, U) (blank-padded past each row's length) -> (alpha (U+1, B, T),
    blank_lp (B, T, U+1))."""
    b, _, u_rows, _ = log_probs.shape
    u_max = u_rows - 1
    if targets.shape != (b, u_max):
        raise ValueError(f"targets {tuple(targets.shape)}, want {(b, u_max)}")
    blank_lp = log_probs[..., blank]
    emit = log_probs[:, :, :u_max].gather(3, targets[:, None, :, None].expand(
        -1, log_probs.shape[1], -1, 1))[..., 0]
    return rnnt_alpha_from_blank_emit(blank_lp, emit, fastemit_lambda)


def _row_prefix(c: torch.Tensor) -> torch.Tensor:
    """[0, c_0, c_0 + c_1, ...]: the sum of c over the frames before t."""
    return torch.cat([torch.zeros_like(c[:, :1]), torch.cumsum(c[:, :-1], 1)], 1)


def rnnt_alpha_from_blank_emit(blank_lp: torch.Tensor, emit: torch.Tensor,
                               fastemit_lambda: float = 0.0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward lattice from the two planes the recursion reads, blank_lp
    (B, T, U+1) and emit (B, T, U), so that a caller need not form the
    (B, T, U+1, V) joint -> (alpha (U+1, B, T), blank_lp)."""
    if fastemit_lambda:
        emit = emit + fastemit_lambda * (emit - emit.detach())
    rows = [_row_prefix(blank_lp[..., 0])]
    for u in range(emit.shape[2]):
        c = _row_prefix(blank_lp[..., u + 1])
        rows.append(c + torch.logcumsumexp(rows[-1] + emit[..., u] - c, 1))
    return torch.stack(rows), blank_lp


def rnnt_loss(logits: torch.Tensor, targets: torch.Tensor, t_lens: torch.Tensor,
              u_lens: torch.Tensor, blank: int = 0, fastemit_lambda: float = 0.0,
              reduction: str = "mean") -> torch.Tensor:
    """Negative log-likelihood of the RNN-T lattice of joint logits (B, T,
    U+1, V) (pre-softmax), targets (B, U), t_lens and u_lens (B,):
    warprnnt's conventions (per-sequence NLL, 'mean' over the batch)."""
    log_probs = torch.log_softmax(logits.float(), -1)
    alpha, blank_lp = rnnt_alpha(log_probs, targets, blank, fastemit_lambda)
    return _nll_from_alpha(alpha, blank_lp, t_lens, u_lens, reduction)


def rnnt_loss_from_blank_emit(blank_lp: torch.Tensor, emit: torch.Tensor,
                              t_lens: torch.Tensor, u_lens: torch.Tensor,
                              fastemit_lambda: float = 0.0,
                              reduction: str = "mean") -> torch.Tensor:
    """`rnnt_loss` from the blank and emit log-prob planes (see
    `rnnt_alpha_from_blank_emit`): the memory-bounded entry point."""
    alpha, blank_lp = rnnt_alpha_from_blank_emit(blank_lp, emit, fastemit_lambda)
    return _nll_from_alpha(alpha, blank_lp, t_lens, u_lens, reduction)


def _nll_from_alpha(alpha, blank_lp, t_lens, u_lens, reduction):
    bi = torch.arange(blank_lp.shape[0], device=blank_lp.device)
    # a zero-length encoder sequence has no path: clamp its last frame (so
    # 0 does not wrap to the end) and zero its NLL
    t_last = (t_lens - 1).clamp(min=0)
    ll = alpha[u_lens, bi, t_last] + blank_lp[bi, t_last, u_lens]
    nll = torch.where(t_lens > 0, -ll, 0.0)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll
