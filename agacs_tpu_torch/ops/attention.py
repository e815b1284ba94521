"""Plain head-split attention (counterpart of `agacs_tpu/ops/attention.py`
`einsum_mha` and `streaming_lse`): the reference numerics the kernels are
held against, the decoder's causal self-attention, the two language-column
scores the CS loss reads (`agacs_tpu/models/whisper.py:436-446`) and the
row log-sum-exp that turns them into probabilities for head counting. JAX
computes all of these with XLA einsums, outside any Pallas kernel; so does
this port."""

from __future__ import annotations

import torch


def einsum_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float = 1.0,
    causal: bool = False,
) -> torch.Tensor:
    """(B, h, Tq, d) x (B, h, Tk, d) -> (B, h, Tq, d): scores in the input
    dtype, float32 softmax, weights cast back for the value product
    (reference whisper/model.py:102-109). `causal` adds -inf above the
    diagonal (key column > query row), as JAX's `triu` mask does."""
    qk = (torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale).float()
    if causal:
        t_q, t_k = qk.shape[-2:]
        qk = qk + torch.full((t_q, t_k), float("-inf"), device=qk.device).triu(1)
    w = torch.softmax(qk, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def streaming_lse(q: torch.Tensor, k: torch.Tensor, causal: bool = False,
                  block: int = 512) -> torch.Tensor:
    """Per-row float32 log-sum-exp of q.k^T over key blocks of `block`,
    with a running max and denominator (JAX `streaming_lse`
    :93-142), so no (Tq, Tk) score tensor is kept. q, k (B, h, T, d)
    pre-scaled; `causal` masks key column > query row. -> (B, h, Tq)."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    rows = torch.arange(tq, device=q.device)
    m = torch.full((b, h, tq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    for c0 in range(0, tk, min(block, tk)):
        kb = k[:, :, c0:c0 + block]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kb).float()
        if causal:
            cols = c0 + torch.arange(kb.shape[2], device=q.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        new_m = torch.maximum(m, s.amax(-1))
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        l = (l * torch.exp(m - safe_m) * torch.isfinite(m)
             + torch.exp(s - safe_m[..., None]).sum(-1))
        m = new_m
    return m + torch.log(torch.clamp(l, min=1e-38))


def lang_col_scores(qh: torch.Tensor, kh: torch.Tensor, lo: int = 1,
                    hi: int = 3) -> torch.Tensor:
    """Pre-softmax causal self-attention scores at key columns [lo, hi):
    (B, h, T, hi - lo) float32 from the scaled (B, h, T, d) q and k, with
    -inf where the column is past the row (the causal mask). The CS loss
    reads columns 1:3, the <|zh|> / <|en|> prompt positions."""
    cols = torch.einsum("bhqd,bhkd->bhqk", qh, kh[:, :, lo:hi]).float()
    rows = torch.arange(qh.shape[2], device=qh.device)
    masked = torch.arange(lo, hi, device=qh.device)[None, :] > rows[:, None]
    return cols.masked_fill(masked, float("-inf"))


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, h*d) -> (B, h, T, d)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, h, T, d) -> (B, T, h*d)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def packed_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int
) -> torch.Tensor:
    """(B, Tq, D) q over (B, Tk, D) k/v -> (B, Tq, D), packed layout in and
    out (JAX `flash_train._einsum_ref`): head split, d_head**-0.25 on q and
    k, `einsum_mha`, heads merged back."""
    sc = (q.shape[-1] // n_head) ** -0.25
    return merge_heads(einsum_mha(split_heads(q, n_head) * sc,
                                  split_heads(k, n_head) * sc,
                                  split_heads(v, n_head)))
