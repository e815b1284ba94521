"""Plain head-split attention (counterpart of `agacs_tpu/ops/attention.py`
`einsum_mha`): the reference numerics the kernels are held against."""

from __future__ import annotations

import torch


def einsum_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """(B, h, Tq, d) x (B, h, Tk, d) -> (B, h, Tq, d): scores in the input
    dtype, float32 softmax, weights cast back for the value product
    (reference whisper/model.py:102-109). Non-causal: the serving path has
    no causal full-sequence attention."""
    qk = (torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale).float()
    w = torch.softmax(qk, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, h*d) -> (B, h, T, d)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def packed_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int
) -> torch.Tensor:
    """(B, Tq, D) q over (B, Tk, D) k/v -> (B, Tq, D), packed layout in and
    out (JAX `flash_train._einsum_ref`): head split, d_head**-0.25 on q and
    k, `einsum_mha`, heads merged back."""
    b, t, d = q.shape
    sc = (d // n_head) ** -0.25
    o = einsum_mha(split_heads(q, n_head) * sc, split_heads(k, n_head) * sc,
                   split_heads(v, n_head))
    return o.transpose(1, 2).reshape(b, t, d)
