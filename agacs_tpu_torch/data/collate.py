"""Batch collation (counterpart of `agacs_tpu/data/collate.py`): speech
zero-padded to a 1 s grid, text padded with -1 (ignore_id) to a grid of 8,
cs_labels padded with LANG_PAD; lengths emitted. numpy out, in arrays
from `alloc` (default numpy; `data/prefetch.PinnedArrays` collates into
pinned host memory); `to_device` makes the step's tensors."""

from __future__ import annotations

import numpy as np
import torch

from agacs_tpu_torch.adapt.cs_loss import LANG_PAD
from agacs_tpu_torch.data.sampler import bucket_length


def _numpy_full(name: str, shape: tuple, dtype, fill) -> np.ndarray:
    return np.full(shape, fill, dtype)


def collate_batch(items: list[dict], speech_grid: int = 16000, text_grid: int = 8,
                  max_speech: int | None = 30 * 16000,
                  pad_to: tuple[int, int] | None = None, alloc=_numpy_full) -> dict:
    """`pad_to` (s_pad, t_pad) forces the padded shapes (JAX's train CLI pads
    to the sampler's buckets); `alloc(name, shape, dtype, fill)` makes
    each output array."""
    b = len(items)
    if pad_to is not None:
        s_pad, t_pad = pad_to
    else:
        s_pad = bucket_length(max(len(it["speech"]) for it in items), speech_grid,
                              max_speech)
        t_pad = bucket_length(max(len(it["text"]) for it in items), text_grid, None)
    speech = alloc("speech", (b, s_pad), np.float32, 0)
    speech_lengths = alloc("speech_lengths", (b,), np.int32, 0)
    text = alloc("text", (b, t_pad), np.int32, -1)
    text_lengths = alloc("text_lengths", (b,), np.int32, 0)
    has_labels = all("cs_labels" in it for it in items)
    cs_labels = alloc("cs_labels", (b, t_pad + 1), np.int8, LANG_PAD) if has_labels else None
    for i, it in enumerate(items):
        s = it["speech"][:s_pad]
        speech[i, : len(s)] = s
        speech_lengths[i] = len(s)
        ids = it["text"][:t_pad]
        text[i, : len(ids)] = ids
        text_lengths[i] = len(ids)
        if has_labels:
            lab = it["cs_labels"][: t_pad + 1]
            cs_labels[i, : len(lab)] = lab
    out = {"speech": speech, "speech_lengths": speech_lengths, "text": text,
           "text_lengths": text_lengths, "utt_ids": [it["utt_id"] for it in items]}
    if has_labels:
        out["cs_labels"] = cs_labels
    return out


def to_device(batch: dict, device) -> dict:
    """The step's tensors of a collated batch: speech float32, lengths and
    text int64, cs_labels int8."""
    out = {}
    for k in ("speech", "speech_lengths", "text", "cs_labels"):
        if k in batch:
            t = torch.from_numpy(np.asarray(batch[k]))
            if k in ("speech_lengths", "text"):
                t = t.long()
            out[k] = t.to(device, non_blocking=True)
    return out
