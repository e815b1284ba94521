"""Whisper log-mel frontend (counterpart of `agacs_tpu/ops/logmel.py`).

Same numerics as the JAX frontend: periodic hann(400), hop 160, centered
reflect-padded STFT with the last frame dropped, power spectrum, 80-bin
slaney mel filterbank, log10 clamped at 1e-10, floored at the per-utterance
max - 8, then (x + 4) / 4. Output layout (B, frames, n_mels).

The DFT and mel products are plain float32 matmuls; TF32 is switched off
around them (the JAX code uses Precision.HIGHEST there, and the log10 /
max - 8 floor is sensitive to it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


@dataclasses.dataclass(frozen=True)
class WhisperAudioConfig:
    sample_rate: int = SAMPLE_RATE
    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    n_mels: int = N_MELS


@contextlib.contextmanager
def full_fp32():
    """Run float32 matmuls and convolutions without TF32 inside the block
    (cuDNN enables TF32 for convolutions by default)."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window, matching torch.hann_window(n)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= 1000.0,
        min_log_mel + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
        f / f_sp,
    )


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, 1000.0 * np.exp(logstep * (m - min_log_mel)), f_sp * m
    )


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    n_mels: int = N_MELS,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalized mel filterbank (n_mels, n_fft//2+1), float32
    (librosa.filters.mel with htk=False)."""
    fmax = sample_rate / 2.0 if fmax is None else fmax
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.array(fmin)), _hz_to_mel_slaney(np.array(fmax)),
        n_mels + 2,
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel_spectrogram(
    audio: torch.Tensor,
    ilens: torch.Tensor | None = None,
    config: WhisperAudioConfig = WhisperAudioConfig(),
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, T) 16 kHz waveform -> ((B, T//hop, n_mels) float32, ilens//hop).

    The per-utterance "max - 8" floor is taken over the padded feature
    map, exactly like the JAX frontend and the reference."""
    from agacs_tpu_torch.ops.stft import stft_power

    if audio.ndim == 1:
        audio = audio[None, :]
    n_frames = audio.shape[1] // config.hop_length
    mel = torch.from_numpy(
        mel_filterbank(config.sample_rate, config.n_fft, config.n_mels).T.copy()
    ).to(audio.device)
    with full_fp32():
        power = stft_power(audio, config.n_fft, config.hop_length, n_frames=n_frames)
        mel_spec = torch.matmul(power, mel)  # (B, F, n_mels)
    log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
    per_utt_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, per_utt_max - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    olens = None if ilens is None else ilens // config.hop_length
    return log_spec, olens
