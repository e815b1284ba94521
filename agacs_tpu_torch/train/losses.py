"""Sequence losses (counterpart of `agacs_tpu/train/losses.py`):
`add_sos_eos`, the KL-form label-smoothed CE and token accuracy of the
attention decoder, and the CTC losses of the CTC heads. Same formulas, same
ignore/eos padding.

CTC: `ctc_loss_streaming` is what the models train with. It never forms the
(B, T, V) logits: the per-frame normaliser is `ops/vocab_lse.streaming_lse`
(kernel K4 on the card) and the lattice reads only the blank and label
columns, gathered from W and multiplied in float32, so the lattice
(`ctc_loss_from_planes`, an alpha recursion over frames vectorised over
(B, S)) gets two log-probability planes that are NOT normalised over a class
axis. That is why it is not `F.ctc_loss`, whose backward assumes
log-softmax inputs. `ctc_loss` (dense logits, log_softmax, `F.ctc_loss`) is
kept as the oracle the tests hold the streaming loss against."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
                         normalize_length: bool = False, par=None) -> torch.Tensor:
    """KL(true_dist || softmax(logits)) summed over classes and tokens,
    true_dist = smoothing/(V-1) off-target and 1-smoothing on it, divided
    by the batch size (or the valid token count). Expanded with the lse
    (JAX :49-88), so no (N, V) log-softmax is kept for the backward:
    sum_c log_softmax(x)_c = sum_c x_c - V lse(x).

    On a mesh (`par`, this rank's rows) the mean over ranks must be the
    global loss: dividing by the rank's B is (equal row blocks), dividing
    by the token count is not, so with `normalize_length` the divisor is
    the global count over the number of data ranks."""
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
    if not normalize_length:
        return kl.sum() / b
    if par is None or par.mesh is None:
        return kl.sum() / max(int((~ignore).sum()), 1)
    count = par.all_reduce((~ignore).sum().float().reshape(1), "data")[0]
    return kl.sum() / (count.clamp(min=1.0) / par.n_data)


def th_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                ignore_id: int = IGNORE_ID, par=None) -> torch.Tensor:
    """Argmax accuracy over the non-ignored positions; on a mesh (`par`)
    over the global batch: the correct and valid counts summed over the
    data ranks, one ratio (every rank's)."""
    mask = targets != ignore_id
    correct = ((logits.argmax(-1) == targets) & mask).sum()
    total = mask.sum()
    if par is not None and par.mesh is not None:
        counts = par.all_reduce(torch.stack([correct, total]).float(), "data")
        correct, total = counts[0], counts[1]
    return correct / total.clamp(min=1)


def ctc_loss(logits: torch.Tensor, logit_lens: torch.Tensor, labels: torch.Tensor,
             label_lens: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Batch-mean CTC loss of dense (B, T, V) logits (JAX `ctc_loss`):
    log_softmax, then `F.ctc_loss` with infeasible utterances zeroed
    (reference `espnet2/asr/ctc.py`, zero_infinity)."""
    lp = torch.log_softmax(logits.float(), -1).transpose(0, 1)
    labels = torch.where(labels == IGNORE_ID, 0, labels)
    per = F.ctc_loss(lp, labels, logit_lens, label_lens, blank=blank_id, reduction="none",
                     zero_infinity=True)
    return torch.where(label_lens <= logit_lens, per, 0.0).mean()


NEG_LL = -1e30  # log-domain "impossible" (finite: -inf - -inf would NaN)


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(torch.stack([a, b, c]), 0)


class _CTCLattice(torch.autograd.Function):
    """The CTC lattice over emissions em (B, T, S) -> per-utterance
    negative log-likelihood (B,), in float64: the alpha recursion forward
    (the log-probability of the prefix paths ending in state s at frame t)
    and, for the backward, the beta recursion from the end and the state
    occupancies exp(alpha + beta - ll), which are -d nll / d em. A frame's
    step is a handful of launches each way, where autograd through the
    recursion records three times as many; float64 because an occupancy
    subtracts log-likelihoods of ~1e2 to reach values of ~1e-1."""

    @staticmethod
    def forward(ctx, em, skip_ok, logit_lens, label_lens):
        b, t_max, s_max = em.shape
        em64 = em.double()
        # alphas[t, :, 2:] is alpha at frame t; columns 0-1 stay impossible,
        # so alpha shifted by one and by two states are views
        alphas = torch.full((t_max, b, s_max + 2), NEG_LL, dtype=torch.float64,
                            device=em.device)
        first = torch.arange(s_max, device=em.device)[None] < 2
        alphas[0, :, 2:] = torch.where(first & (logit_lens[:, None] > 0), em64[:, 0], NEG_LL)
        valid = (torch.arange(t_max, device=em.device)[:, None] < logit_lens[None])[..., None]
        for t in range(1, t_max):
            prev = alphas[t - 1]
            lse = _lse3(prev[:, 2:], prev[:, 1:-1], torch.where(skip_ok, prev[:, :-2], NEG_LL))
            torch.where(valid[t], em64[:, t] + lse, prev[:, 2:], out=alphas[t, :, 2:])
        end = alphas[-1, :, 2:]
        s_end = (2 * label_lens)[:, None]
        a_end = end.gather(1, s_end)[:, 0]
        a_last = end.gather(1, (s_end - 1).clamp(min=0))[:, 0]
        ll = torch.where(label_lens > 0, torch.logaddexp(a_end, a_last), a_end)
        ctx.save_for_backward(em64, skip_ok, logit_lens, label_lens, alphas, ll)
        return (-ll).to(em.dtype)

    @staticmethod
    def backward(ctx, g):
        em64, skip_ok, logit_lens, label_lens, alphas, ll = ctx.saved_tensors
        b, t_max, s_max = em64.shape
        dev = em64.device
        s_ids = torch.arange(s_max, device=dev)[None]
        s_end = (2 * label_lens)[:, None]
        term = torch.where((s_ids == s_end) | ((s_ids == s_end - 1) & (label_lens[:, None] > 0)),
                           0.0, NEG_LL).double()
        # state s continues to s, s+1, and to s+2 where the skip into s+2 is
        # allowed
        skip_from = torch.cat([skip_ok[:, 2:], torch.zeros_like(skip_ok[:, :2])], 1)
        betas = torch.empty(t_max, b, s_max, dtype=torch.float64, device=dev)
        betas[-1] = term
        nxt = torch.full((b, s_max + 2), NEG_LL, dtype=torch.float64, device=dev)
        before_last = (torch.arange(t_max, device=dev)[:, None] < logit_lens[None] - 1)[..., None]
        for t in range(t_max - 2, -1, -1):
            torch.add(betas[t + 1], em64[:, t + 1], out=nxt[:, :s_max])
            lse = _lse3(nxt[:, :s_max], nxt[:, 1:-1], torch.where(skip_from, nxt[:, 2:], NEG_LL))
            torch.where(before_last[t], lse, term, out=betas[t])
        occ = torch.exp(alphas[:, :, 2:] + betas - ll[None, :, None]).transpose(0, 1)
        feasible = (label_lens <= logit_lens) & (logit_lens > 0)
        frames = (torch.arange(t_max, device=dev)[None] < logit_lens[:, None])[..., None]
        grad = torch.where(frames & feasible[:, None, None], -g.double()[:, None, None] * occ, 0.0)
        return grad.to(g.dtype), None, None, None


def ctc_loss_from_planes(lp_blank: torch.Tensor, lp_label: torch.Tensor,
                         logit_lens: torch.Tensor, labels: torch.Tensor,
                         label_lens: torch.Tensor) -> torch.Tensor:
    """Batch-mean CTC negative log-likelihood from the two planes the
    lattice reads, lp_blank (B, T) and lp_label (B, T, U) (JAX
    `ctc_loss_from_planes`, :133-231): the alpha recursion over the
    extended sequence [blank, l1, blank, ..., lU, blank] (S = 2U+1), the
    skip into label u allowed iff labels[u] != labels[u-1], rows frozen past
    `logit_lens`, infeasible rows and utterances without frames zeroed.
    The lattice is `_CTCLattice` (one step per frame, vectorised over
    (B, S)); the emissions are gathered from the planes under autograd."""
    b, t_max, u_max = lp_label.shape
    s_max = 2 * u_max + 1
    s_ids = torch.arange(s_max, device=lp_label.device)
    u_of_s = ((s_ids - 1) // 2).clamp(min=0)
    lab_s = labels.gather(1, u_of_s.expand(b, s_max))
    lab_prev = labels.gather(1, (u_of_s - 1).clamp(min=0).expand(b, s_max))
    skip_ok = ((s_ids % 2) == 1)[None] & (s_ids >= 3)[None] & (lab_s != lab_prev)
    # emissions: even s -> blank, odd s = 2u+1 -> label u
    em = torch.where((s_ids % 2) == 1, lp_label.gather(2, u_of_s.expand(b, t_max, s_max)),
                     lp_blank[..., None])
    nll = _CTCLattice.apply(em, skip_ok, logit_lens, label_lens)
    feasible = (label_lens <= logit_lens) & (logit_lens > 0)
    return torch.where(feasible, nll, 0.0).mean()


def ctc_loss_streaming(enc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       logit_lens: torch.Tensor, labels: torch.Tensor,
                       label_lens: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """CTC loss straight from the encoder output (B, T, d) and the head's
    (d, V) weight and (V,) bias (JAX `ctc_loss_streaming`, :234-276): the
    row lse from `streaming_lse` over w in enc's dtype, the blank and label
    columns W[:, cols] gathered and multiplied in float32 (exact for bf16
    values, as JAX's preferred_element_type product), then the lattice."""
    from agacs_tpu_torch.ops.vocab_lse import streaming_lse

    b, t, d = enc.shape
    labels_safe = torch.where(labels == IGNORE_ID, 0, labels)
    cols = torch.cat([torch.full((b, 1), blank_id, dtype=labels.dtype, device=labels.device),
                      labels_safe], 1)  # (B, U+1)
    wc = w.to(enc.dtype).contiguous()
    lse = streaming_lse(enc.reshape(b * t, d), wc, bias.float()).reshape(b, t)
    w_g = wc.t()[cols].transpose(1, 2)  # (B, d, U+1)
    zg = enc.float() @ w_g.float() + bias[cols].float()[:, None, :]
    return ctc_loss_from_planes(zg[..., 0] - lse, zg[..., 1:] - lse[..., None], logit_lens,
                                labels_safe, label_lens)
