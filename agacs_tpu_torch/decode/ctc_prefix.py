"""CTC prefix scoring for joint CTC/attention beam search (counterpart of
`agacs_tpu/decode/ctc_prefix.py`, espnet's CTCPrefixScorer): the
incremental log p_CTC(prefix . c | X) of candidate next tokens, with the
blank/non-blank forward recursion (blank id 0)

  phi[t]   = r_b[t] (+) (r_nb[t] if c != last else -inf)
  r_nb'[t] = (r_nb'[t-1] (+) phi[t-1]) + x[t, c]
  r_b'[t]  = (r_b'[t-1] (+) r_nb'[t-1]) + x[t, blank]
  psi      = (+)_t (phi[t-1] + x[t, c])         (eos: r_b[T] (+) r_nb[T])

(+) being log-add-exp. JAX scans the frames with `lax.scan`; here the
recursion is vectorised over hypotheses x candidates and loops over time on
the host, one frame per iteration of a few elementwise launches, writing
each frame's state straight into the output buffers. Frames where every
row is valid skip the validity select, and frames past every row's length
stop the loop (their state is the last valid frame's, filled at once),
which changes no value. It is not a Pallas kernel in JAX and has no
hand-written kernel here: its cost is host launches (PERF.md, Where the
time goes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1.0e30


class CTCPrefixState(NamedTuple):
    r_nb: torch.Tensor  # (N, T) log prob the prefix ends non-blank at frame t
    r_b: torch.Tensor  # (N, T)
    last: torch.Tensor  # (N,) last non-blank token of the prefix (-1 if empty)
    score: torch.Tensor  # (N,) current prefix score psi


def ctc_prefix_init(logp: torch.Tensor, blank: int = 0) -> CTCPrefixState:
    """State of the empty prefix. logp: (N, T, V) frame log-probs."""
    n, t, _ = logp.shape
    return CTCPrefixState(
        r_nb=torch.full((n, t), NEG_INF, device=logp.device),
        r_b=torch.cumsum(logp[:, :, blank], 1),  # the all-blank path
        last=torch.full((n,), -1, dtype=torch.long, device=logp.device),
        score=torch.zeros(n, device=logp.device),
    )


def ctc_prefix_score(
    logp: torch.Tensor,
    state: CTCPrefixState,
    cands: torch.Tensor,
    frame_lens: torch.Tensor | None = None,
    blank: int = 0,
    rows: torch.Tensor | None = None,
    valid_frames: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, CTCPrefixState]:
    """Score candidate extensions and build their successor states.

    logp: (B, T, V) frame log-probs; `rows` (N,) maps each state row to
    its logp row (default: the identity, B == N), so beam rows can share
    their utterance's frames without repeating them. state: N rows; cands
    (N, C) token ids; frame_lens (N,) valid frames (None: all T).
    `valid_frames` = (min, max) of frame_lens when the caller knows them on
    the host (saves a device read).

    Returns psi (N, C), the total prefix scores (psi - state.score[:, None]
    is the incremental scorer value), and the successor state with (N, T,
    C) r_nb / r_b (a view of (T, N, C) buffers), last = cands, score = psi;
    select along C after pruning."""
    n, c = cands.shape
    t = logp.shape[1]
    dev = logp.device
    if rows is None:
        rows = torch.arange(n, device=dev)
    x_c = logp[rows[:, None], :, cands].permute(2, 0, 1).contiguous()  # (T, N, C)
    x_b = logp[rows, :, blank].t().contiguous()  # (T, N)

    same_as_last = cands == state.last[:, None]
    phi = torch.logaddexp(
        state.r_b.t()[:, :, None],
        torch.where(same_as_last[None], NEG_INF, state.r_nb.t()[:, :, None]))  # (T, N, C)
    # frame 0's phi_{-1}: 0 for the empty prefix, else impossible
    phi_m1 = torch.where(state.last[:, None] == -1, 0.0, NEG_INF).expand(n, c)
    phi_prev = torch.cat([phi_m1[None], phi[:-1]], 0)  # (T, N, C)
    phix = phi_prev + x_c  # psi's terms

    if frame_lens is None:
        lo = hi = t
    elif valid_frames is not None:
        lo, hi = valid_frames
    else:
        lo, hi = int(frame_lens.min()), int(frame_lens.max())
    hi = min(max(hi, 0), t)
    r_nb_all = torch.empty(t, n, c, device=dev)
    r_b_all = torch.empty(t, n, c, device=dev)
    r_nb = torch.full((n, c), NEG_INF, device=dev)
    r_b = torch.full((n, c), NEG_INF, device=dev)
    psi = torch.full((n, c), NEG_INF, device=dev)
    tmp = torch.empty(n, c, device=dev)
    for f in range(hi):
        if f < lo:  # every row valid: no select
            torch.logaddexp(r_nb, phi_prev[f], out=tmp)
            torch.logaddexp(r_b, r_nb, out=r_b_all[f])
            r_b_all[f].add_(x_b[f][:, None])
            torch.add(tmp, x_c[f], out=r_nb_all[f])
            psi = torch.logaddexp(psi, phix[f])
        else:
            valid = (f < frame_lens)[:, None]
            r_nb_all[f] = torch.where(valid, torch.logaddexp(r_nb, phi_prev[f]) + x_c[f], r_nb)
            r_b_all[f] = torch.where(valid, torch.logaddexp(r_b, r_nb) + x_b[f][:, None], r_b)
            psi = torch.where(valid, torch.logaddexp(psi, phix[f]), psi)
        r_nb, r_b = r_nb_all[f], r_b_all[f]
    if hi < t:  # frames past every length keep the last valid state
        r_nb_all[hi:] = r_nb
        r_b_all[hi:] = r_b
    new_state = CTCPrefixState(r_nb=r_nb_all.permute(1, 0, 2), r_b=r_b_all.permute(1, 0, 2),
                               last=cands, score=psi)
    return psi, new_state


def ctc_prefix_select(state: CTCPrefixState, idx: torch.Tensor) -> CTCPrefixState:
    """Keep one candidate per row: idx (N,) -> a state with (N, ...) fields."""
    r = torch.arange(idx.shape[0], device=idx.device)
    return CTCPrefixState(
        r_nb=state.r_nb[r, :, idx] if state.r_nb.dim() == 3 else state.r_nb,
        r_b=state.r_b[r, :, idx] if state.r_b.dim() == 3 else state.r_b,
        last=state.last[r, idx],
        score=state.score[r, idx],
    )


def ctc_eos_score(state: CTCPrefixState, frame_lens: torch.Tensor | None = None) -> torch.Tensor:
    """psi(prefix . eos) = the prefix's total CTC prob = r_b[T] (+) r_nb[T]."""
    if frame_lens is None:
        return torch.logaddexp(state.r_nb[..., -1], state.r_b[..., -1])
    idx = torch.clamp(frame_lens - 1, min=0)[:, None]
    return torch.logaddexp(state.r_nb.gather(1, idx)[:, 0], state.r_b.gather(1, idx)[:, 0])
