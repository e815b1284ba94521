"""Per-head language-attribution counting and head selection (counterpart
of `agacs_tpu/adapt/head_selection.py`).

A head is a "language head" for an utterance when its total attention on
the <|zh|>/<|en|> prompt columns exceeds its attention everywhere else,
judged on the post-softmax distribution, where each row sums to 1:

    sum_rows sum_{c in {zh,en}} p[row, c]  >  sum_rows sum_{c not in {zh,en}} p[row, c]
                                          <=>  2 * sum p_cols > n_rows

so only the two probability columns are needed (`p_cols` of
`whisper_decode(need_probs=True)`). `count_language_heads_topk` is the
reference's old top-k formulation over full maps. The counters are torch
(they run on the model's device); `select_heads`, `save_counts` and
`load_counts` are numpy, copied because the JAX module imports `jax`.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from agacs_tpu_torch.decode.composed_beam import top_k


def count_language_heads(p_cols: torch.Tensor,
                         n_rows: torch.Tensor | None = None) -> torch.Tensor:
    """(L, B, h, T, 2) post-softmax mass on the zh/en columns -> (L, h)
    int32 counts of the utterances for which each head attends more to the
    language columns than elsewhere. n_rows (B,) valid row counts; None
    counts every T row (the reference sums over every row, eos padding
    included)."""
    lang_mass = p_cols.float().sum(dim=(-1, -2))  # (L, B, h)
    if n_rows is None:
        total = torch.full((lang_mass.shape[1],), float(p_cols.shape[3]),
                           device=p_cols.device)
    else:
        total = n_rows.float()
    return (2.0 * lang_mass > total[None, :, None]).int().sum(1, dtype=torch.int32)


def count_language_heads_topk(maps: torch.Tensor, k: int = 2,
                              lang_cols: tuple[int, int] = (1, 2)) -> torch.Tensor:
    """The reference's old top-k criterion (espnet_model.py:312-363) on
    (L, B, h, T, T) pre-softmax maps (aux["maps"]): a head qualifies for
    an utterance when the zh/en columns are the two most frequent members
    of the rows' top-k columns. -> (L, h) int32 counts.

    The per-row top-k ranks equal scores by the lower column, as
    `jax.lax.top_k` does; it matters: row 0 of a causal map has one finite
    entry and T - 1 entries of -inf, and JAX then picks column 1 (the
    <|zh|> column) as its second, which the histogram counts. The
    histogram's own top-k also breaks ties toward the smaller column."""
    t = maps.shape[-1]
    _, idx = top_k(maps, k)  # (L, B, h, T, k)
    hist = torch.zeros(maps.shape[:-1], device=maps.device)  # (L, B, h, T)
    hist.scatter_add_(-1, idx.flatten(-2), torch.ones(idx.flatten(-2).shape,
                                                      device=maps.device))
    order_key = hist * t - torch.arange(t, dtype=torch.float32, device=maps.device)
    _, top_cols = top_k(order_key, k)  # (L, B, h, k)
    # a column with count 0 never enters the reference's dict: require
    # presence in the histogram as well as in the top-k
    qualifies = torch.ones(hist.shape[:-1], dtype=torch.bool, device=maps.device)
    for c in lang_cols:
        qualifies &= (top_cols == c).any(-1) & (hist[..., c] > 0)
    return qualifies.int().sum(1, dtype=torch.int32)


def select_heads(counts: np.ndarray, head_percentage: float = 100.0,
                 base_pool: int | None = None) -> np.ndarray:
    """Binary head mask from accumulated counts (espnet_model.py:198-219):
    the top int(base_pool * head_percentage / 100) heads by count (stable
    order), count > 0 only; base_pool defaults to the number of heads with
    nonzero counts. Returns (L, h) float32 0/1."""
    counts = np.asarray(counts)
    n_layers, n_heads = counts.shape
    flat = [(layer, head, counts[layer, head])
            for layer in range(n_layers) for head in range(n_heads)]
    flat.sort(key=lambda x: x[2], reverse=True)
    pool = base_pool if base_pool is not None else int((counts > 0).sum())
    n_sel = int(pool * head_percentage / 100.0)
    mask = np.zeros((n_layers, n_heads), np.float32)
    for layer, head, c in flat[:n_sel]:
        if c > 0:
            mask[layer, head] = 1.0
    return mask


def save_counts(path: str, counts: np.ndarray) -> None:
    """Counts as JSON (the reference's pickle artifact's replacement)."""
    counts = np.asarray(counts)
    with open(path, "w") as f:
        json.dump({"shape": list(counts.shape), "counts": counts.astype(int).tolist()}, f)


def load_counts(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray(json.load(f)["counts"], dtype=np.int64)
