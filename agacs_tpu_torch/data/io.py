"""Kaldi-style data-dir IO (counterpart of `agacs_tpu/data/io.py` and of the
reading half of `agacs_tpu/data/dataset.py`): wav.scp / text / segments /
utt2num_samples, and the audio a wav.scp value points at.

A wav.scp value is read by its form, in JAX's order: `.npy` (a float
array at 16 kHz), an extended-ark entry `path:offset` (a FLAC or WAV blob,
`data/kaldi_ark.py`), `.flac` (the native codec, `data/flac.py`), `.sph`
(NIST SPHERE, `data/sph.py`), and anything else as a PCM WAV whatever its
name. `DataDir` keys utterances by `segments` when the dir has one
(wav.scp then keys recordings, and each utterance is a slice of its
recording) and takes lengths from `utt2num_samples` when the format stage
wrote one.
"""

from __future__ import annotations

import os
import wave

import numpy as np

from agacs_tpu_torch.data import flac, kaldi_ark, sph


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


def write_scp(path: str, entries: dict[str, str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for k, v in entries.items():
            f.write(f"{k} {v}\n")


def _is_ark_entry(path: str) -> bool:
    p, _, off = path.rpartition(":")
    return bool(p) and off.isdigit()


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """A wav.scp value -> (float32 mono waveform in [-1, 1], sample_rate)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32), 16000
    if _is_ark_entry(path):
        return kaldi_ark.read_ark_audio(path)
    if path.endswith(".flac"):
        return flac.read_flac(path)
    if path.endswith(".sph"):
        return sph.read_sph(path)
    return kaldi_ark.decode_wav(path)


def write_wav(path: str, data: np.ndarray, sr: int = 16000) -> None:
    """float32 waveform -> 16-bit PCM mono WAV (x 32767, clipped to [-1, 1])."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pcm16 = (np.clip(np.asarray(data, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())


def wav_num_samples(path: str) -> int:
    """A wav.scp value's length in samples, from its header (no decode)."""
    if path.endswith(".npy"):
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _, _ = np.lib.format._read_array_header(f, version)
        return int(np.prod(shape))
    if _is_ark_entry(path):
        return kaldi_ark.ark_num_samples(path)
    if path.endswith(".flac"):
        with open(path, "rb") as f:
            return flac.flac_info(f.read(65536))["total_samples"]
    if path.endswith(".sph"):
        return sph.sph_num_samples(path)
    with wave.open(path, "rb") as w:
        return w.getnframes()


class DataDir:
    """The utterances of a data dir that JAX's `ASRDataset` yields: those in
    `text` whose audio exists (with `segments`: whose recording is in
    wav.scp), in wav.scp's (or segments') order, kept when
    `min_samples <= n <= max_samples` (0 turns a bound off)."""

    def __init__(self, data_dir: str, min_samples: int = 0,
                 max_samples: int = 30 * 16000):
        self.wav = read_scp(os.path.join(data_dir, "wav.scp"))
        self.text = read_scp(os.path.join(data_dir, "text"))
        # kaldi segments: utterances are (recording, start_s, end_s) slices
        self.segments: dict[str, tuple[str, float, float]] = {}
        seg_path = os.path.join(data_dir, "segments")
        if os.path.exists(seg_path):
            for utt, v in read_scp(seg_path).items():
                rec, start, end = v.split()
                self.segments[utt] = (rec, float(start), float(end))
            utts = [u for u, (rec, _, _) in self.segments.items()
                    if u in self.text and rec in self.wav]
        else:
            utts = [u for u in self.wav if u in self.text]
        self._n: dict[str, int] = {}
        num_path = os.path.join(data_dir, "utt2num_samples")
        if os.path.exists(num_path):
            self._n = {u: int(n) for u, n in read_scp(num_path).items()}
        self._rec_cache: tuple[str, np.ndarray, int] | None = None
        self.utt_ids = [u for u in utts
                        if (not min_samples or self.num_samples(u) >= min_samples)
                        and (not max_samples or self.num_samples(u) <= max_samples)]

    def num_samples(self, utt: str) -> int:
        if utt not in self._n:
            if utt in self.segments:
                _, start, end = self.segments[utt]
                self._n[utt] = int(round((end - start) * 16000))
            else:
                self._n[utt] = wav_num_samples(self.wav[utt])
        return self._n[utt]

    def speech(self, utt: str) -> np.ndarray:
        if utt in self.segments:
            rec, start, end = self.segments[utt]
            # one-recording cache: split dirs are sorted by recording, so
            # consecutive utterances slice the same long recording
            if self._rec_cache is None or self._rec_cache[0] != rec:
                self._rec_cache = (rec, *read_wav(self.wav[rec]))
            _, audio, sr = self._rec_cache
            data = audio[int(round(start * sr)) : int(round(end * sr))]
        else:
            data, sr = read_wav(self.wav[utt])
        if sr != 16000:
            raise ValueError(f"{utt}: sample rate {sr}, expected 16000")
        return data
