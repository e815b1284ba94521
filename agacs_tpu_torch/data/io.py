"""Kaldi-style data-dir reading for decoding (counterpart of
`agacs_tpu/data/io.py` `read_scp` / `read_wav`). `agacs_tpu.data` itself
pulls in JAX through its package `__init__`, so the port reads wav.scp
and text here, with the stdlib `wave` module and numpy. Only plain WAV
entries are read; FLAC, SPHERE, kaldi-ark and `segments` data dirs are
not ported yet and raise."""

from __future__ import annotations

import os
import wave

import numpy as np


def read_scp(path: str) -> dict[str, str]:
    """'<utt_id> <value...>' lines -> ordered dict (wav.scp, text, ...)."""
    out: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(maxsplit=1)
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """PCM WAV -> (float32 mono waveform in [-1, 1], sample_rate)."""
    if not path.endswith(".wav"):
        raise NotImplementedError(f"{path}: only plain .wav entries are read")
    with wave.open(path, "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        width, ch = w.getsampwidth(), w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def wav_num_samples(path: str) -> int:
    with wave.open(path, "rb") as w:
        return w.getnframes()


class DataDir:
    """wav.scp + text of a data dir: the utterances `agacs_tpu.data.ASRDataset`
    yields for decoding (in both files, at most `max_samples` long)."""

    def __init__(self, data_dir: str, max_samples: int = 30 * 16000):
        if os.path.exists(os.path.join(data_dir, "segments")):
            raise NotImplementedError(f"{data_dir}: segments are not ported yet")
        self.wav = read_scp(os.path.join(data_dir, "wav.scp"))
        self.text = read_scp(os.path.join(data_dir, "text"))
        self._n = {u: wav_num_samples(p) for u, p in self.wav.items() if u in self.text}
        self.utt_ids = [u for u, n in self._n.items() if n <= max_samples]

    def num_samples(self, utt: str) -> int:
        return self._n[utt]

    def speech(self, utt: str) -> np.ndarray:
        data, sr = read_wav(self.wav[utt])
        if sr != 16000:
            raise ValueError(f"{utt}: sample rate {sr}, expected 16000")
        return data
