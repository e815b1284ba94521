"""CTC greedy (best-path) decoding (counterpart of
`agacs_tpu/decode/ctc_greedy.py`): the argmax frame ids of a CTC head,
repeats collapsed and blanks removed. A library function, as in JAX: no
CLI calls it.
"""

from __future__ import annotations

import numpy as np
import torch


def ctc_best_path(ctc_logits: torch.Tensor, enc_lens: torch.Tensor) -> torch.Tensor:
    """(B, T, V) logits -> (B, T) argmax ids with pad positions = blank."""
    ids = ctc_logits.argmax(-1)
    valid = torch.arange(ids.shape[1], device=ids.device)[None, :] < enc_lens[:, None]
    return torch.where(valid, ids, 0)


def collapse_ctc(ids, blank: int = 0) -> list[list[int]]:
    """Collapse repeats then remove blanks, per utterance (host side)."""
    out = []
    for row in np.asarray(ids):
        prev = -1
        seq = []
        for t in row:
            t = int(t)
            if t != prev and t != blank:
                seq.append(t)
            prev = t
        out.append(seq)
    return out


@torch.inference_mode()
def ctc_greedy_decode(model, encode_fn, batch: dict, blank: int = 0) -> list[list[int]]:
    """Encode -> CTC head -> best path -> collapse.

    encode_fn(speech, speech_lengths) -> (enc_out, enc_lens); `model.ctc`
    is the head (an nn.Linear d -> V), applied in the encoder output's
    dtype, the logits then float32."""
    enc_out, enc_lens = encode_fn(batch["speech"], batch["speech_lengths"])
    head = model.ctc
    logits = torch.nn.functional.linear(enc_out, head.weight.to(enc_out.dtype),
                                        head.bias.to(enc_out.dtype)).float()
    return collapse_ctc(ctc_best_path(logits, enc_lens).cpu().numpy(), blank)
