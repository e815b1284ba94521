"""Whisper encoder as a frontend (counterpart of
`agacs_tpu/ops/frontend_whisper.py`, espnet2's WhisperFrontend): a
(typically frozen) Whisper encoder's output as the feature sequence of
another model. The encoder's self-attention is K1f on the card.
"""

from __future__ import annotations

import torch

from agacs_tpu_torch.models.whisper import Whisper, encoder_olens, whisper_encode
from agacs_tpu_torch.ops.logmel import log_mel_spectrogram


def whisper_frontend(
    model: Whisper,
    speech: torch.Tensor,
    speech_lengths: torch.Tensor,
    freeze: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) waveform -> ((B, T_enc, d_audio) features, olens).

    freeze=True (the reference's freeze_weights default) runs the encoder
    without gradient tracking and returns a detached output."""
    feats, flens = log_mel_spectrogram(speech, speech_lengths)
    if freeze:
        with torch.no_grad():
            out = whisper_encode(model, feats).detach()
    else:
        out = whisper_encode(model, feats)
    return out, encoder_olens(flens, model.cfg)
