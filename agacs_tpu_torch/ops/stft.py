"""Power STFT as one matmul against windowed DFT bases (counterpart of
`agacs_tpu/ops/stft.py`). The JAX version splits frames into gcd-sized
chunks to avoid gathers on the TPU; here the frames are an `unfold` view
of the padded signal and the product is one (B·F, n_fft) x (n_fft,
2·n_bins) float32 matmul. Callers switch TF32 off around it
(`logmel.full_fp32`)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from agacs_tpu_torch.ops.logmel import hann_window


@functools.lru_cache(maxsize=None)
def _windowed_dft(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, 2*n_bins) windowed [cos | sin] DFT bases."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = np.zeros((n_fft, 1))
    off = (n_fft - win_length) // 2
    w[off : off + win_length, 0] = hann_window(win_length)
    return np.concatenate([np.cos(ang) * w, np.sin(ang) * w], axis=1).astype(
        np.float32
    )


def stft_power(
    audio: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int | None = None,
    n_frames: int | None = None,
) -> torch.Tensor:
    """(B, T) waveform -> (B, n_frames, n_bins) power spectrum, matching
    torch.stft(center=True, reflect). n_frames defaults to the full
    1 + T//hop; pass T//hop to drop the last frame (whisper)."""
    win_length = win_length or n_fft
    if audio.ndim == 1:
        audio = audio[None]
    t = audio.shape[1]
    n_frames = t // hop + 1 if n_frames is None else n_frames
    pad = n_fft // 2
    padded = F.pad(audio.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    needed = (n_frames - 1) * hop + n_fft
    if needed > padded.shape[1]:
        padded = F.pad(padded, (0, needed - padded.shape[1]))
    frames = padded[:, :needed].unfold(1, n_fft, hop)  # (B, F, n_fft)
    basis = torch.from_numpy(_windowed_dft(n_fft, win_length)).to(audio.device)
    out = torch.matmul(frames, basis)  # (B, F, 2*n_bins)
    n_bins = n_fft // 2 + 1
    re, im = out[..., :n_bins], out[..., n_bins:]
    return re * re + im * im
