"""ASR model config and encoder front half (counterpart of
`agacs_tpu/models/asr_model.py`), serving fields only: waveform ->
log-mel -> Whisper encoder. SpecAug, the losses and the CTC head belong
to the training path and are not ported yet."""

from __future__ import annotations

import dataclasses

import torch

from agacs_tpu_torch.models.whisper import Whisper, WhisperConfig, encoder_olens
from agacs_tpu_torch.ops.logmel import WhisperAudioConfig, log_mel_spectrogram


@dataclasses.dataclass(frozen=True)
class ASRModelConfig:
    whisper: WhisperConfig
    ctc_weight: float = 0.0
    sos: int = 50258
    eos: int = 50257
    audio: WhisperAudioConfig = WhisperAudioConfig()


def encode(
    model: Whisper,
    cfg: ASRModelConfig,
    speech: torch.Tensor,
    speech_lengths: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) waveform -> (encoder_out (B, T_enc, d), encoder_out_lens (B,)),
    the `train=False` path of the JAX `encode`."""
    feats, feat_lens = log_mel_spectrogram(speech, speech_lengths, cfg.audio)
    return model.encoder(feats), encoder_olens(feat_lens, cfg.whisper)
