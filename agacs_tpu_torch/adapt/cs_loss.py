"""Attention-guided code-switching losses (counterpart of
`agacs_tpu/adapt/cs_loss.py`): the shipped column-MSE loss of the reference
`espnet_model.py:463-530` from the two language columns, and the lid-CE
loss over full attention rows (`cs_loss_type: lid_ce`, :364-461).

The decoder emits the pre-softmax self-attention scores at the <|zh|> /
<|en|> prompt columns (`whisper_decode(collect_lang_cols=True)` ->
`qk_cols` (L, B, h, T, 2)); the loss pushes them toward c_val at the
token's own language column. The per-token language labels are computed
on the host with the tokenizer (`attention_target_labels`, numpy). The
tokenizer is this package's copy (`text/tokenizer.py`). `cs_lid_ce_loss`
reads the full pre-softmax maps (`whisper_decode(collect_full_maps=True)`
-> `maps` (L, B, h, T, T)) and lid-mode labels.
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
                            prompt_len: int = 5, mode: str = "attention") -> np.ndarray:
    """(B, T) sos-prefixed, eos-padded decoder inputs -> (B, T) int8 labels.
    mode "attention": the shipped `create_attention_pattern` semantics
    (espnet_model.py:236-275): the prompt rows get [NONE, ZH, EN, NONE,
    NONE]; a token is EN when all its characters are ASCII letters after
    removing the byte-level space marker, BOTH when it is space-only, ZH
    otherwise (punctuation included); the first <|endoftext|> is BOTH and
    everything after it PAD. mode "lid_ce" (`getlid`, :364-390): the prompt
    rows get [PAD, ZH, EN, PAD, PAD], space-only tokens are EN and the
    first <|endoftext|> is PAD too."""
    ys_in = np.asarray(ys_in)
    b, t = ys_in.shape
    lid = mode == "lid_ce"
    labels = np.full((b, t), LANG_PAD, dtype=np.int8)
    prompt_labels = ([LANG_PAD, LANG_ZH, LANG_EN, LANG_PAD, LANG_PAD] if lid
                     else [LANG_NONE, LANG_ZH, LANG_EN, LANG_NONE, LANG_NONE])
    eot = tokenizer.special.eot
    for i in range(b):
        labels[i, : min(prompt_len, t)] = prompt_labels[: min(prompt_len, t)]
        for j in range(prompt_len, t):
            tid = int(ys_in[i, j])
            if tid == eot:
                if not lid:
                    labels[i, j] = LANG_BOTH
                break
            tok = tokenizer.id_to_token(tid)
            if tok.replace("Ġ", "") == "":
                labels[i, j] = LANG_EN if lid else LANG_BOTH
            elif WhisperTokenizer.token_is_english(tok):
                labels[i, j] = LANG_EN
            else:
                labels[i, j] = LANG_ZH
    return labels


def targets_from_labels(labels: torch.Tensor, c_val: float | torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """labels (B, T) -> (targets (B, T, 2) float32, valid (B, T) float32).
    `c_val` may be a 0-dim tensor (the learnable `estimated_c_val`); the
    targets then carry its gradient."""
    c = torch.as_tensor(c_val, dtype=torch.float32, device=labels.device)
    z = torch.zeros((), device=labels.device)
    lut = torch.stack([torch.stack(r) for r in ((z, z), (c, z), (z, c), (c, c), (z, z))])
    labels = labels.long()
    return lut[labels], (labels != LANG_PAD).float()


def cs_attention_loss(qk_cols: torch.Tensor, labels: torch.Tensor,
                      head_mask: torch.Tensor, c_val: float | torch.Tensor = 0.6,
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


def cs_lid_ce_loss(maps: torch.Tensor, labels: torch.Tensor, ys_in_lens: torch.Tensor,
                   head_mask: torch.Tensor, lsm_weight: float = 0.1) -> torch.Tensor:
    """The lid-CE CS loss (JAX :198-253, the reference's
    `calculate_cs_loss_lid_ce`, espnet_model.py:364-461): each valid row of a
    head's pre-softmax map is a distribution over key columns, pushed by a
    label-smoothed CE toward its own language-token column (1 for ZH, 2 for
    EN). +-inf entries become logit 0 before the log-softmax; a row is
    valid when its label is ZH or EN and it lies before ys_in_len - 1; per
    head the row sum, head-masked, summed over (layer, head), batch mean.

    maps (L, B, h, T, T) with -inf causal mask; labels (B, T) lid-mode;
    ys_in_lens (B,) = text length + 1; head_mask (L, h) 0/1."""
    m = maps.permute(1, 0, 2, 3, 4).float()
    m = torch.where(torch.isinf(m), 0.0, m)
    logp = torch.log_softmax(m, dim=-1)
    labels = labels.long()
    tcol = torch.where(labels == LANG_ZH, 1, torch.where(labels == LANG_EN, 2, 0))
    b, n_l, n_h, t = logp.shape[:4]
    nll = -torch.gather(logp, -1, tcol[:, None, None, :, None].expand(b, n_l, n_h, t, 1))[..., 0]
    ce = (1.0 - lsm_weight) * nll + lsm_weight * -logp.mean(-1)
    rows = torch.arange(labels.shape[1], device=labels.device)
    valid = ((labels == LANG_ZH) | (labels == LANG_EN)) & (rows[None] < ys_in_lens[:, None] - 1)
    per_head = (ce * valid[:, None, None].to(ce.dtype)).sum(-1)
    return (per_head * head_mask.to(per_head)[None]).sum((-1, -2)).mean()
