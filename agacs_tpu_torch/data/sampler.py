"""numel batch-bins packing (counterpart of `agacs_tpu/data/sampler.py`
`num_elements_batches`, the reference `NumElementsBatchSampler`):
utterances sorted by length, packed greedily so that batch size x longest
length stays under `batch_bins`; optional rounding of batch sizes to a
grid, and a seeded shuffle of the batch order. The other batch types
(sorted, folded, length, fixed_shapes) are not ported.

The port's train CLI packs with the grid at 1 (`bin/train.py`), as the
reference's sampler does. JAX's train CLI rounds every batch size to a
multiple of `b_grid = 8` (`agacs_tpu/bin/train.py:236`), which bounds the
shapes XLA compiles and keeps a batch shardable over its data axis; eager
PyTorch on one card needs neither, so the two CLIs can form different
batches from the same data dir and batch_bins."""

from __future__ import annotations

import numpy as np


def bucket_length(n: int, grid: int = 16000, max_len: int | None = None) -> int:
    """Round n up to the bucket grid (default 1 s of samples)."""
    b = ((n + grid - 1) // grid) * grid
    return min(b, max_len) if max_len else b


def round_batches_to_grid(batches: list[list[str]], b_grid: int) -> list[list[str]]:
    """Round every batch size down to a multiple of b_grid, carrying the
    remainder into the next batch; only the final batch may be off-grid."""
    if b_grid <= 1:
        return list(batches)
    out: list[list[str]] = []
    carry: list[str] = []
    for b in batches:
        cur = carry + b
        keep = (len(cur) // b_grid) * b_grid
        if keep == 0:
            carry = cur
            continue
        out.append(cur[:keep])
        carry = cur[keep:]
    if carry:
        out.append(carry)
    return out


def num_elements_batches(
    lengths: dict[str, int],
    batch_bins: int,
    sort_in_batch: str = "descending",
    min_batch_size: int = 1,
    max_batch_size: int | None = None,
    shuffle_batches: bool = False,
    seed: int = 0,
    b_grid: int = 1,
) -> list[list[str]]:
    """utt_id -> sample count  ==>  a list of utt_id batches."""
    items = sorted(lengths.items(), key=lambda kv: kv[1], reverse=True)
    if sort_in_batch == "ascending":
        items = items[::-1]
    batches: list[list[str]] = []
    cur: list[str] = []
    cur_max = 0
    for utt, n in items:
        new_max = max(cur_max, n)
        if cur and (new_max * (len(cur) + 1) > batch_bins
                    or (max_batch_size and len(cur) >= max_batch_size)):
            batches.append(cur)
            cur, new_max = [], n
        cur.append(utt)
        cur_max = new_max
    if cur:
        batches.append(cur)
    if len(batches) > 1 and len(batches[-1]) < min_batch_size:
        batches[-2].extend(batches.pop())
    if b_grid > 1:
        batches = round_batches_to_grid(batches, b_grid)
    if shuffle_batches:
        np.random.RandomState(seed).shuffle(batches)
    return batches
