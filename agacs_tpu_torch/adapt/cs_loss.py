"""Attention-guided code-switching loss from the two language columns
(counterpart of `agacs_tpu/adapt/cs_loss.py`, the shipped column-MSE loss
of the reference `espnet_model.py:463-530`).

The decoder emits the pre-softmax self-attention scores at the <|zh|> /
<|en|> prompt columns (`whisper_decode(collect_lang_cols=True)` ->
`qk_cols` (L, B, h, T, 2)); the loss pushes them toward c_val at the
token's own language column. The per-token language labels are computed
on the host with the tokenizer (`attention_target_labels`, numpy). The
tokenizer is this package's copy (`text/tokenizer.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from agacs_tpu_torch.text.tokenizer import WhisperTokenizer

# per-row language labels (host-computed, device-consumed)
LANG_NONE = 0  # target [0, 0]
LANG_ZH = 1    # target [c, 0]
LANG_EN = 2    # target [0, c]
LANG_BOTH = 3  # target [c, c] (space-only tokens, first <|endoftext|>)
LANG_PAD = 4   # target [inf, inf] -> masked

# The shipped hardcoded 50%-of-heads mask (espnet_model.py:514-527);
# layers 0-2 are fully off.
REFERENCE_50PCT_HEAD_MASK = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1, 1],
        [0, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0],
        [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0],
        [1, 1, 1, 1, 0, 0, 1, 0, 0, 0, 1, 0],
        [1, 1, 1, 1, 1, 0, 1, 0, 1, 0, 0, 1],
        [0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1],
    ],
    dtype=np.float32,
)


def attention_target_labels(ys_in: np.ndarray, tokenizer: WhisperTokenizer,
                            prompt_len: int = 5) -> np.ndarray:
    """(B, T) sos-prefixed, eos-padded decoder inputs -> (B, T) int8 labels
    (the shipped `create_attention_pattern` semantics, espnet_model.py:
    236-275): the prompt rows get [NONE, ZH, EN, NONE, NONE]; a token is EN
    when all its characters are ASCII letters after removing the byte-level
    space marker, BOTH when it is space-only, ZH otherwise (punctuation
    included); the first <|endoftext|> is BOTH and everything after it
    PAD. The `lid_ce` label mode is not ported."""
    ys_in = np.asarray(ys_in)
    b, t = ys_in.shape
    labels = np.full((b, t), LANG_PAD, dtype=np.int8)
    prompt_labels = [LANG_NONE, LANG_ZH, LANG_EN, LANG_NONE, LANG_NONE]
    eot = tokenizer.special.eot
    for i in range(b):
        labels[i, : min(prompt_len, t)] = prompt_labels[: min(prompt_len, t)]
        for j in range(prompt_len, t):
            tid = int(ys_in[i, j])
            if tid == eot:
                labels[i, j] = LANG_BOTH
                break
            tok = tokenizer.id_to_token(tid)
            if tok.replace("Ġ", "") == "":
                labels[i, j] = LANG_BOTH
            elif WhisperTokenizer.token_is_english(tok):
                labels[i, j] = LANG_EN
            else:
                labels[i, j] = LANG_ZH
    return labels


def targets_from_labels(labels: torch.Tensor, c_val: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """labels (B, T) -> (targets (B, T, 2) float32, valid (B, T) float32)."""
    c = float(c_val)
    lut = torch.tensor([[0.0, 0.0], [c, 0.0], [0.0, c], [c, c], [0.0, 0.0]],
                       device=labels.device)
    labels = labels.long()
    return lut[labels], (labels != LANG_PAD).float()


def cs_attention_loss(qk_cols: torch.Tensor, labels: torch.Tensor,
                      head_mask: torch.Tensor, c_val: float = 0.6,
                      layer_offset: int = 0) -> torch.Tensor:
    """The shipped CS loss from score columns (JAX :144-195).

    qk_cols (L, B, h, T, 2) pre-softmax scores with -inf where causally
    masked; labels (B, T); head_mask (L, h) 0/1; `layer_offset` is the
    absolute index of qk_cols' first layer. Absolute layers 0-1 get the
    reference's early-layer pattern: zero targets at every row, pad rows
    not zeroed. Later layers zero map and target at pad rows. Returns the
    batch mean of the head-masked sum over (layer, head) of each head's
    mean over its nonzero rows of sum_cols (map - target)^2; a head with
    no nonzero row contributes 0 (the reference divides by zero there)."""
    targets, valid = targets_from_labels(labels, c_val)
    maps = qk_cols.permute(1, 0, 2, 3, 4)  # (B, L, h, T, 2)
    tgt = targets[:, None, None]
    row_valid = valid[:, None, None, :, None]
    early = (torch.arange(maps.shape[1], device=maps.device) + layer_offset < 2
             )[None, :, None, None, None]
    maps = torch.where(torch.isfinite(maps), maps, 0.0)
    maps = torch.where(early, maps, maps * row_valid)
    tgt = torch.where(early, 0.0, tgt * row_valid)
    row_loss = ((maps - tgt) ** 2).sum(-1)  # (B, L, h, T)
    nonzero = (row_loss != 0.0).float().sum(-1)
    total = row_loss.sum(-1)
    per_head = torch.where(nonzero > 0, total / nonzero.clamp(min=1.0), 0.0)
    return (per_head * head_mask.to(per_head)[None]).sum((-1, -2)).mean()
