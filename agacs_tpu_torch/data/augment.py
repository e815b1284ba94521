"""On-the-fly speech augmentation: RIR convolution + noise mixing
(counterpart of `agacs_tpu/data/augment.py`, host numpy, line for line).

Host-side per-utterance preprocessing, the equivalent of the
reference's `CommonPreprocessor._speech_process`
(`espnet2/train/preprocessor.py:139-320`): optional room-impulse-response
convolution (power-renormalized over non-silent samples) and additive
noise at a random SNR drawn from `noise_db_range`, followed by peak
clipping normalization. Like SpecAug this runs only in training; unlike
the reference it draws from an instance-owned RNG (reproducible per
seed) instead of the process-global `np.random`. The draws are made in
the order the utterances are read, so the train CLI reads an augmented
set's batches in one thread (`data/prefetch.py`); resuming does not
restore this RNG (JAX's does not either).

The `detect_non_silence` VAD mirrors `preprocessor.py:74-125` (boxcar
framed power vs 0.01x the utterance mean).
"""

from __future__ import annotations

import logging

import numpy as np

from agacs_tpu_torch.data.io import read_wav


def _framed(x: np.ndarray, frame_length: int, frame_shift: int) -> np.ndarray:
    """Non-centered end-padded framing of (..., T) -> (..., n, frame_length)
    (`preprocessor.py:31-72`, centered=False, padded=True)."""
    nadd = (-(x.shape[-1] - frame_length) % frame_shift) % frame_length
    pad = [(0, 0)] * (x.ndim - 1) + [(0, nadd)]
    x = np.pad(x, pad, mode="constant")
    n = (x.shape[-1] - frame_length) // frame_shift + 1
    shape = x.shape[:-1] + (n, frame_length)
    strides = x.strides[:-1] + (frame_shift * x.strides[-1], x.strides[-1])
    return np.lib.stride_tricks.as_strided(x, shape=shape, strides=strides)


def detect_non_silence(
    x: np.ndarray,
    threshold: float = 0.01,
    frame_length: int = 1024,
    frame_shift: int = 512,
) -> np.ndarray:
    """Power-based VAD over (..., T); returns a bool mask of x's shape."""
    if x.shape[-1] < frame_length:
        return np.full(x.shape, True, dtype=bool)
    if x.dtype.kind == "i":
        x = x.astype(np.float64)
    power = (_framed(x, frame_length, frame_shift) ** 2).mean(axis=-1)
    mean_power = power.mean(axis=-1, keepdims=True)
    if np.all(mean_power == 0):
        return np.full(x.shape, True, dtype=bool)
    frames = power / mean_power > threshold  # (..., n)
    detects = np.broadcast_to(
        frames[..., None], frames.shape + (frame_shift,)
    ).reshape(*frames.shape[:-1], -1)
    return np.pad(
        detects,
        [(0, 0)] * (x.ndim - 1) + [(0, x.shape[-1] - detects.shape[-1])],
        mode="edge",
    )


def _read_scp_paths(scp: str) -> list[str | None]:
    """rir/noise scp: one path per line, optionally 'key path'
    (`preprocessor.py:188-208`)."""
    out: list[str | None] = []
    with open(scp, encoding="utf-8") as f:
        for line in f:
            sps = line.strip().split(None, 1)
            if not sps:
                continue
            out.append(sps[0] if len(sps) == 1 else sps[1])
    return out


class SpeechAugment:
    """RIR + noise augmentation over (T,) float waveforms.

    Args mirror the reference's preprocessor flags (`preprocessor.py:
    139-158`): `noise_db_range` is "low_high" or a single value, in dB
    SNR relative to the non-silent speech power.
    """

    def __init__(
        self,
        rir_scp: str | None = None,
        rir_apply_prob: float = 1.0,
        noise_scp: str | None = None,
        noise_apply_prob: float = 1.0,
        noise_db_range: str = "3_10",
        short_noise_thres: float = 0.5,
        volume_normalize: float | None = None,
        seed: int = 0,
    ):
        self.rirs = _read_scp_paths(rir_scp) if rir_scp else None
        self.noises = _read_scp_paths(noise_scp) if noise_scp else None
        self.rir_apply_prob = rir_apply_prob
        self.noise_apply_prob = noise_apply_prob
        self.short_noise_thres = short_noise_thres
        self.volume_normalize = volume_normalize
        sps = str(noise_db_range).split("_")
        if len(sps) == 1:
            self.noise_db_low = self.noise_db_high = float(sps[0])
        elif len(sps) == 2:
            self.noise_db_low, self.noise_db_high = float(sps[0]), float(sps[1])
        else:
            raise ValueError(
                f"noise_db_range format error: {noise_db_range!r} "
                "(e.g. '-3_4' -> [-3 dB, 4 dB])"
            )
        self.rng = np.random.RandomState(seed)

    @property
    def active(self) -> bool:
        return bool(self.rirs or self.noises or self.volume_normalize)

    def _convolve_rir(self, speech: np.ndarray, power: float) -> np.ndarray:
        """speech (Nmic, T); full convolution truncated to T, power
        restored over the non-silent samples (`preprocessor.py:221-238`)."""
        path = self.rirs[self.rng.randint(len(self.rirs))]
        if path is None:
            return speech
        rir, _ = read_wav(path)
        rir = np.atleast_2d(np.asarray(rir, np.float64))  # (Nmic, T)
        out = np.stack(
            [
                np.convolve(speech[ch], rir[min(ch, rir.shape[0] - 1)])[
                    : speech.shape[1]
                ]
                for ch in range(speech.shape[0])
            ]
        )
        power2 = (out[detect_non_silence(out)] ** 2).mean()
        return np.sqrt(power / max(power2, 1e-10)) * out

    def _add_noise(self, speech: np.ndarray, power: float) -> np.ndarray:
        """speech (Nmic, T); noise wrapped/cropped to T, scaled to a
        uniform dB draw (`preprocessor.py:240-281`)."""
        nsamples = speech.shape[1]
        path = self.noises[self.rng.randint(len(self.noises))]
        if path is None:
            return speech
        noise_db = self.rng.uniform(self.noise_db_low, self.noise_db_high)
        audio, _ = read_wav(path)
        noise = np.atleast_2d(np.asarray(audio, np.float64)).T  # (T, Nmic)
        frames = noise.shape[0]
        if frames == nsamples:
            pass
        elif frames < nsamples:
            if frames / nsamples < self.short_noise_thres:
                logging.warning(
                    "Noise (%d) is much shorter than speech (%d) "
                    "in dynamic mixing", frames, nsamples,
                )
            offset = self.rng.randint(0, nsamples - frames)
            noise = np.pad(
                noise, [(offset, nsamples - frames - offset), (0, 0)],
                mode="wrap",
            )
        else:
            offset = self.rng.randint(0, frames - nsamples)
            noise = noise[offset : offset + nsamples]
        noise = noise.T  # (Nmic, T)
        noise_power = (noise**2).mean()
        scale = (
            10 ** (-noise_db / 20)
            * np.sqrt(power)
            / np.sqrt(max(noise_power, 1e-10))
        )
        return speech + scale * noise

    def __call__(self, speech: np.ndarray) -> np.ndarray:
        """Augment one waveform; returns the same shape/dtype family
        (float). Mirrors `_speech_process` (`preprocessor.py:283-320`)."""
        squeeze = speech.ndim == 1
        x = np.atleast_2d(np.asarray(speech, np.float64))  # (Nmic, T)
        if self.rirs is not None or self.noises is not None:
            power = (x[detect_non_silence(x)] ** 2).mean()
            if self.rirs is not None and self.rir_apply_prob >= self.rng.random():
                x = self._convolve_rir(x, power)
            if (
                self.noises is not None
                and self.noise_apply_prob >= self.rng.random()
            ):
                x = self._add_noise(x, power)
            ma = np.max(np.abs(x))
            if ma > 1.0:
                x = x / ma
        if self.volume_normalize is not None:
            ma = np.max(np.abs(x))
            if ma > 0:
                x = x * self.volume_normalize / ma
        out = x[0] if squeeze else x
        return out.astype(np.float32)


def augment_from_dict(d: dict, seed: int = 0) -> SpeechAugment | None:
    """Build from reference-schema config keys (`abs_task.py` flags
    rir_scp/rir_apply_prob/noise_scp/noise_apply_prob/noise_db_range/
    speech_volume_normalize); None when nothing is configured."""
    if not (
        d.get("rir_scp") or d.get("noise_scp")
        or d.get("speech_volume_normalize")
    ):
        return None
    return SpeechAugment(
        rir_scp=d.get("rir_scp"),
        rir_apply_prob=float(d.get("rir_apply_prob", 1.0)),
        noise_scp=d.get("noise_scp"),
        noise_apply_prob=float(d.get("noise_apply_prob", 1.0)),
        noise_db_range=str(d.get("noise_db_range", "3_10")),
        short_noise_thres=float(d.get("short_noise_thres", 0.5)),
        volume_normalize=d.get("speech_volume_normalize"),
        seed=seed,
    )
