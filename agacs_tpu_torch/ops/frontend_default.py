"""DefaultFrontend of the conformer track (counterpart of
`agacs_tpu/ops/frontend_default.py`): STFT -> power -> log-mel, then
utterance or global MVN.

Same numerics as the JAX frontend: hann(n_fft) centered reflect-padded
STFT (`ops/stft.py stft_power`), slaney mel filterbank, natural log with a
1e-20 floor, pad frames zeroed. The frame count KEEPS torch.stft's last
frame (1 + T // hop); only the whisper frontend drops it. The DFT and mel
products run in float32 with TF32 off (`logmel.full_fp32`), as JAX runs
them at Precision.HIGHEST.
"""

from __future__ import annotations

import dataclasses

import torch

from agacs_tpu_torch.ops.logmel import full_fp32, mel_filterbank
from agacs_tpu_torch.ops.stft import stft_power


@dataclasses.dataclass(frozen=True)
class DefaultFrontendConfig:
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    win_length: int | None = None  # None -> n_fft
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None
    normalize: str | None = "utterance_mvn"  # the ASR task's default


def _valid(feats: torch.Tensor, olens: torch.Tensor) -> torch.Tensor:
    """(B, F, 1) mask of the frames below each utterance's length."""
    return (torch.arange(feats.shape[1], device=feats.device)[None, :]
            < olens[:, None])[..., None]


def default_frontend(
    audio: torch.Tensor,
    ilens: torch.Tensor,
    config: DefaultFrontendConfig = DefaultFrontendConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T) waveform -> (feats (B, F, n_mels) float32, olens (B,)), with
    olens = ilens // hop + 1 (torch.stft's center=True frame count)."""
    if audio.ndim == 1:
        audio = audio[None, :]
    n_fft, hop = config.n_fft, config.hop_length
    n_frames = audio.shape[1] // hop + 1
    mel_t = torch.from_numpy(
        mel_filterbank(config.fs, n_fft, config.n_mels, config.fmin, config.fmax).T.copy()
    ).to(audio.device)
    with full_fp32():
        power = stft_power(audio, n_fft, hop, win_length=config.win_length or n_fft,
                           n_frames=n_frames)
        mel = torch.matmul(power, mel_t)
    feats = torch.log(mel + 1e-20)
    olens = ilens // hop + 1
    feats = torch.where(_valid(feats, olens), feats, 0.0)
    if config.normalize == "utterance_mvn":
        feats = utterance_mvn(feats, olens)
    return feats, olens


def utterance_mvn(feats: torch.Tensor, olens: torch.Tensor, norm_vars: bool = False,
                  eps: float = 1.0e-20) -> torch.Tensor:
    """Per-utterance mean (and optional variance) normalisation over the
    valid frames (JAX `utterance_mvn`: norm_means on, norm_vars off)."""
    mask = _valid(feats, olens)
    n = torch.clamp(olens[:, None, None].float(), min=1.0)
    mean = torch.where(mask, feats, 0.0).sum(1, keepdim=True) / n
    out = torch.where(mask, feats - mean, 0.0)
    if norm_vars:
        var = torch.where(mask, (feats - mean) ** 2, 0.0).sum(1, keepdim=True) / n
        out = out * torch.rsqrt(torch.clamp(var, min=eps))
    return out


def global_mvn(feats: torch.Tensor, olens: torch.Tensor, mean: torch.Tensor,
               std: torch.Tensor) -> torch.Tensor:
    """GlobalMVN with corpus statistics (JAX `global_mvn`)."""
    return torch.where(_valid(feats, olens), (feats - mean) / torch.clamp(std, min=1e-20),
                       0.0)
