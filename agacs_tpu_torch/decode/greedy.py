"""Batched KV-cached greedy decoding (counterpart of
`agacs_tpu/decode/greedy.py` `greedy_decode`, `loop="scan"` semantics).

A Python loop over positions drives one `whisper_decode_step` per
position. The argmax, the forced primer, the eot padding and the
finished flags all stay on the device, so no step waits for the host;
the position is a host-side int, and the first host read is of the
finished token matrix.

The hypothesis primer is the dual-language prompt
`[50258, 50260, 50259, 50359, 50363]` (asr_inference.py:319-331).
"""

from __future__ import annotations

import torch

from agacs_tpu_torch.models.whisper import (
    Whisper,
    init_self_kv_cache,
    precompute_cross_kv,
    whisper_decode_step,
)

WHISPER_CS_PRIMER = (50258, 50260, 50259, 50359, 50363)


@torch.inference_mode()
def greedy_decode(
    model: Whisper,
    enc_out: torch.Tensor,
    primer: tuple[int, ...] = WHISPER_CS_PRIMER,
    max_steps: int = 200,
    eot: int = 50257,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode a batch of encoded utterances (B, T_enc, d).

    Runs min(total - 1, max_ctx - 1) steps, total = len(primer) +
    max_steps, max_ctx = min(n_text_ctx, total). Returns tokens
    (B, total) int64, with eot after each utterance's first eot, and
    lengths (B,) = first eot index + 1 (total when there is none)."""
    cfg = model.cfg
    b, dev = enc_out.shape[0], enc_out.device
    n_primer = len(primer)
    total = n_primer + max_steps
    max_ctx = min(cfg.n_text_ctx, total)

    cross_kv = precompute_cross_kv(model, enc_out)
    self_kv = init_self_kv_cache(cfg, b, max_ctx, device=dev)
    tokens = torch.zeros(b, total, dtype=torch.long, device=dev)
    tokens[:, :n_primer] = torch.tensor(primer, dtype=torch.long, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)

    for pos in range(min(total - 1, max_ctx - 1)):
        logits, _ = whisper_decode_step(model, tokens[:, pos], pos, self_kv, cross_kv)
        if pos + 1 < n_primer:
            continue  # the next token is forced and already in place
        nxt = torch.where(finished, eot, logits.argmax(dim=-1))
        tokens[:, pos + 1] = nxt
        finished |= nxt == eot

    steps = torch.arange(total, device=dev)[None, :]
    is_eot = (tokens == eot) & (steps >= n_primer)
    first_eot = torch.where(
        is_eot.any(dim=1), is_eot.int().argmax(dim=1),
        torch.full((b,), total - 1, device=dev),
    )
    return tokens, first_eot + 1
