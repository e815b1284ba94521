"""Batch samplers (counterpart of `agacs_tpu/data/sampler.py`, the
reference's `build_batch_sampler` types):

  numel         `num_elements_batches`, the reference NumElementsBatchSampler:
                utterances sorted by length, packed greedily so that batch
                size x longest length stays under `batch_bins`;
  sorted        `sorted_batches`, constant batch size over sorted keys;
  unsorted      `unsorted_batches`, constant batch size in key order;
  folded        `folded_batches`, batch size shrunk by length folds;
  length        `length_batches`, packing under a summed-length budget;
  fixed_shapes  `fixed_shape_batches`, numel packing with a closed (B, S)
                set: S from `geometric_s_buckets`, B from the bucket.

Every function is JAX's, line for line, and gives its batch lists
(`tests/test_torch_trainer_options.py`). The port's train CLI packs numel
with the grid at 1 (`bin/train.py`), as the reference's sampler does.
JAX's train CLI rounds every numel batch size to a multiple of `b_grid = 8`
(`agacs_tpu/bin/train.py:236`), which bounds the shapes XLA compiles and
keeps a batch shardable over its data axis; eager PyTorch on one card
needs neither, so the two CLIs can form different numel batches from the
same data dir and batch_bins. `fixed_shapes` exists for its closed shape
set, so the port's CLI gives it JAX's grid of 8 and forms JAX's batches."""

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


def _even_split(keys: list[str], batch_size: int, drop_last: bool) -> list[list[str]]:
    n = max(len(keys) // batch_size, 1)
    if not drop_last:
        return [
            list(keys[i * len(keys) // n : (i + 1) * len(keys) // n])
            for i in range(n)
        ]
    return [list(keys[i * batch_size : (i + 1) * batch_size]) for i in range(n)]


def _check_sort(name: str, value: str) -> None:
    if value not in ("ascending", "descending"):
        raise ValueError(f"{name} must be ascending or descending: {value}")


def sorted_batches(
    lengths: dict[str, int],
    batch_size: int,
    sort_in_batch: str = "descending",
    sort_batch: str = "ascending",
    drop_last: bool = False,
) -> list[list[str]]:
    """`batch_type: sorted` — constant batch size over length-sorted keys
    (`espnet2/samplers/sorted_batch_sampler.py:20-78`): keys sorted by
    length per `sort_in_batch`, split as evenly as possible (or into
    fixed-size batches with `drop_last`), list reversed when the two sort
    directions differ."""
    _check_sort("sort_in_batch", sort_in_batch)
    keys = sorted(
        lengths, key=lambda k: lengths[k],
        reverse=sort_in_batch == "descending",
    )
    if not keys:
        raise RuntimeError("0 utterances")
    batches = _even_split(keys, batch_size, drop_last)
    if sort_in_batch != sort_batch:
        _check_sort("sort_batch", sort_batch)
        batches.reverse()
    return batches


def unsorted_batches(
    keys: list[str],
    batch_size: int,
    drop_last: bool = False,
    utt2category: dict[str, str] | None = None,
) -> list[list[str]]:
    """`batch_type: unsorted` — constant batch size in given key order,
    no length information (`samplers/unsorted_batch_sampler.py:23-76`);
    optional per-category batching (each category batched separately —
    without the reference's `len(keys)`-vs-`len(category_keys)` slicing
    bug, which mis-sizes batches whenever there is more than one
    category)."""
    if not keys:
        raise RuntimeError("0 utterances")
    if utt2category is None:
        return _even_split(list(keys), batch_size, drop_last)
    cat2utt: dict[str, list[str]] = {}
    for k in keys:
        cat2utt.setdefault(utt2category[k], []).append(k)
    out: list[list[str]] = []
    for cat_keys in cat2utt.values():
        out.extend(_even_split(cat_keys, batch_size, drop_last))
    return out


def folded_batches(
    lengths_list: list[dict[str, int]],
    batch_size: int,
    fold_lengths: list[int],
    min_batch_size: int = 1,
    sort_in_batch: str = "descending",
    sort_batch: str = "ascending",
    drop_last: bool = False,
    utt2category: dict[str, str] | None = None,
) -> list[list[str]]:
    """`batch_type: folded` — variable batch size shrunk by length folds
    (`samplers/folded_batch_sampler.py:10-136`): per batch, bs =
    max(min_batch_size, batch_size // (1 + max_i(len_i // fold_i)));
    an undersized final batch is redistributed over the others."""
    _check_sort("sort_in_batch", sort_in_batch)
    _check_sort("sort_batch", sort_batch)
    first = lengths_list[0]
    for d in lengths_list[1:]:
        if set(d) != set(first):
            raise RuntimeError("keys mismatched between length dicts")
    keys = sorted(first, key=lambda k: first[k])  # ascending
    if not keys:
        raise RuntimeError("0 utterances")

    cat2utt: dict[str, list[str]] = {}
    if utt2category is None:
        cat2utt["default"] = keys
    else:
        for k in keys:
            cat2utt.setdefault(utt2category[k], []).append(k)

    out: list[list[str]] = []
    for cat_keys in cat2utt.values():
        start = 0
        batch_sizes: list[int] = []
        while True:
            k = cat_keys[start]
            factor = max(
                int(d[k] / m) for d, m in zip(lengths_list, fold_lengths)
            )
            bs = max(min_batch_size, int(batch_size / (1 + factor)))
            if drop_last and start + bs > len(cat_keys) and batch_sizes:
                break
            bs = min(len(cat_keys) - start, bs)
            batch_sizes.append(bs)
            start += bs
            if start >= len(cat_keys):
                break
        # redistribute an undersized tail over the earlier batches
        # (folded_batch_sampler.py:98-101 — note the -2 offset: the tail
        # fills from the second-to-last batch backwards)
        if len(batch_sizes) > 1 and batch_sizes[-1] < min_batch_size:
            for i in range(batch_sizes.pop(-1)):
                batch_sizes[-(i % len(batch_sizes)) - 2] += 1
        cur: list[list[str]] = []
        start = 0
        for bs in batch_sizes:
            mb = cat_keys[start : start + bs]
            start += bs
            if sort_in_batch == "descending":
                mb = mb[::-1]
            cur.append(list(mb))
        if sort_batch == "descending":
            cur.reverse()
        out.extend(cur)
    return out


def length_batches(
    lengths_list: list[dict[str, int]],
    batch_bins: int,
    min_batch_size: int = 1,
    sort_in_batch: str = "descending",
    sort_batch: str = "ascending",
    drop_last: bool = False,
    padding: bool = True,
) -> list[list[str]]:
    """`batch_type: length` — pack under a summed-length budget
    (`samplers/length_batch_sampler.py:10-126`). With `padding` the bin
    count is sum over length dicts of B x current-key length (ascending
    scan, so the current key is the batch max); without it, the raw sum
    of member lengths."""
    _check_sort("sort_in_batch", sort_in_batch)
    _check_sort("sort_batch", sort_batch)
    first = lengths_list[0]
    for d in lengths_list[1:]:
        if set(d) != set(first):
            raise RuntimeError("keys mismatched between length dicts")
    keys = sorted(first, key=lambda k: first[k])  # ascending
    if not keys:
        raise RuntimeError("0 utterances")

    batch_sizes: list[int] = []
    cur: list[str] = []
    for key in keys:
        cur.append(key)
        if padding:
            bins = sum(len(cur) * d[key] for d in lengths_list)
        else:
            bins = sum(d[k] for k in cur for d in lengths_list)
        if bins > batch_bins and len(cur) >= min_batch_size:
            batch_sizes.append(len(cur))
            cur = []
    if cur and (not drop_last or not batch_sizes):
        batch_sizes.append(len(cur))
    if len(batch_sizes) > 1 and batch_sizes[-1] < min_batch_size:
        for i in range(batch_sizes.pop(-1)):
            batch_sizes[-(i % len(batch_sizes)) - 1] += 1

    out: list[list[str]] = []
    it = iter(batch_sizes)
    bs = next(it)
    mb: list[str] = []
    for key in keys:
        mb.append(key)
        if len(mb) == bs:
            if sort_in_batch == "descending":
                mb = mb[::-1]
            out.append(mb)
            mb = []
            try:
                bs = next(it)
            except StopIteration:
                break
    if sort_batch == "descending":
        out.reverse()
    return out


def geometric_s_buckets(
    min_s: int = 16000, max_s: int = 30 * 16000, ratio: float = 1.3,
    grid: int = 16000,
) -> list[int]:
    """Geometric padded-length buckets (~13 values for 1-30 s at ratio
    1.3): the speech axis of the fixed-shape batch policy."""
    out = [min_s]
    while out[-1] < max_s:
        nxt = bucket_length(int(out[-1] * ratio), grid, max_s)
        if nxt <= out[-1]:
            nxt = out[-1] + grid
        out.append(min(nxt, max_s))
    return out


def fixed_shape_batches(
    lengths: dict[str, int],
    batch_bins: int,
    b_grid: int = 8,
    shuffle_batches: bool = False,
    seed: int = 0,
    ratio: float = 1.3,
    max_s: int = 30 * 16000,
) -> list[list[str]]:
    """numel packing with a CLOSED shape set: pad lengths to geometric
    buckets and derive the batch size from the bucket (B =
    floor(batch_bins / S_bucket), rounded down to b_grid) — every batch
    whose longest utterance falls in bucket S gets the SAME (B, S), so a
    whole epoch compiles one train step per occupied bucket (~13) instead
    of one per batch-size/length combination (~100+, tools/shape_census.py).

    Same contract as NumElementsBatchSampler (padded numel ≤ batch_bins,
    length-sorted batches); deviations: B is bucket-determined rather
    than greedy-maximal, and B is floored at b_grid for mesh
    shardability, which can overshoot batch_bins when
    batch_bins/S < b_grid (raise batch_bins or accept the overshoot).
    The final batch per bucket run may be smaller than B (ragged tail)."""
    buckets = geometric_s_buckets(max_s=max_s, ratio=ratio)
    items = sorted(lengths.items(), key=lambda kv: kv[1], reverse=True)

    def s_bucket(n: int) -> int:
        for s in buckets:
            if n <= s:
                return s
        return buckets[-1]

    batches: list[list[str]] = []
    i = 0
    while i < len(items):
        # the batch's shape comes from its LONGEST utterance's bucket;
        # later (shorter) members just pad up to it, so only the one
        # global tail batch is ever ragged
        s = s_bucket(items[i][1])
        b = max(b_grid, (batch_bins // s) // b_grid * b_grid)
        batches.append([u for u, _ in items[i : i + b]])
        i += b

    if shuffle_batches:
        rng = np.random.RandomState(seed)
        rng.shuffle(batches)
    return batches
