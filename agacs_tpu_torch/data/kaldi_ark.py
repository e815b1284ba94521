"""Extended kaldi ark audio IO (counterpart of `agacs_tpu/data/kaldi_ark.py`):
the reference's dump-dir format.

The format stage (`egs2/TEMPLATE/asr1/pyscripts/audio/format_wav_scp.py:
152-160`, `asr.sh:529`) writes each utterance as `<uttid><space>` followed
by a complete FLAC (or WAV) file blob appended to `data_<name>.ark`, and a
`wav.scp` whose values are `<ark_path>:<byte_offset>` pointing at the
blob start. This module reads and writes that layout with the port's
native FLAC codec (`data/flac.py`); `native=False` reads FLAC blobs with
its plain Python decoder instead.
"""

from __future__ import annotations

import os
import struct
import wave as _wave
from io import BytesIO

import numpy as np

from agacs_tpu_torch.data import flac as _flac

_PROBE_BYTES = 64 * 1024
_CHUNK = 1 << 20  # initial blob read; doubled on truncation


def parse_entry(value: str) -> tuple[str, int | None]:
    """'path:offset' -> (path, offset); plain 'path' -> (path, None)."""
    if ":" in value:
        path, _, off = value.rpartition(":")
        if off.isdigit():
            return path, int(off)
    return value, None


def _read_blob(path: str, offset: int, size: int | None = None) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(size if size is not None else -1)


def _wav_blob_len(head: bytes) -> int:
    assert head[:4] == b"RIFF"
    return 8 + struct.unpack("<I", head[4:8])[0]


def decode_wav(src) -> tuple[np.ndarray, int]:
    """A PCM WAV (a path or a file object) -> (float32 mono waveform in
    [-1, 1], sample_rate). `data/io.read_wav` reads WAV files through it."""
    with _wave.open(src, "rb") as w:
        sr = w.getframerate()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {src}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def read_ark_audio(value: str, native: bool = True) -> tuple[np.ndarray, int]:
    """'ark_path:offset' -> (float32 mono waveform in [-1, 1], rate)."""
    path, offset = parse_entry(value)
    if offset is None:
        raise ValueError(f"not an ark entry: {value!r}")
    size = _CHUNK
    filesize = os.path.getsize(path)
    while True:
        blob = _read_blob(path, offset, size)
        if blob[:4] == b"RIFF":
            n = _wav_blob_len(blob)
            if n > len(blob) and offset + len(blob) < filesize:
                size = n
                continue
            return decode_wav(BytesIO(blob[:n]))
        if blob[:4] == b"fLaC":
            try:
                pcm, sr = _flac.decode_flac(blob, native=native)
            except _flac.FlacError as e:
                if "truncated" in str(e) and offset + len(blob) < filesize:
                    size *= 2
                    continue
                raise
            bps = _flac.flac_info(blob)["bps"]
            return _flac.pcm_to_float(pcm, bps), sr
        raise ValueError(
            f"unrecognized audio blob at {path}:{offset} "
            f"(magic {blob[:4]!r}; expected RIFF or fLaC)"
        )


def ark_num_samples(value: str) -> int:
    """Duration probe without full decode (shape collection)."""
    path, offset = parse_entry(value)
    head = _read_blob(path, offset or 0, _PROBE_BYTES)
    if head[:4] == b"fLaC":
        return _flac.flac_info(head)["total_samples"]
    if head[:4] == b"RIFF":
        with _wave.open(BytesIO(_read_blob(path, offset or 0,
                                           _wav_blob_len(head))), "rb") as w:
            return w.getnframes()
    raise ValueError(f"unrecognized audio blob in {value!r}")


class ArkWriter:
    """Append-mode extended-ark writer (format stage).

    >>> with ArkWriter("dump/raw/train", name="wav", fmt="flac") as w:
    ...     w.write("utt1", pcm16, 16000)
    writes dump/raw/train/data_wav.ark + wav.scp (+ utt2num_samples).
    """

    def __init__(self, outdir: str, name: str = "wav", fmt: str = "flac"):
        assert fmt in ("flac", "wav"), fmt
        os.makedirs(outdir, exist_ok=True)
        self.fmt = fmt
        self.ark_path = os.path.abspath(os.path.join(outdir, f"data_{name}.ark"))
        self.scp_path = os.path.join(outdir, f"{name}.scp")
        self.num_samples_path = os.path.join(outdir, "utt2num_samples")
        self._fark = open(self.ark_path, "wb")
        self._fscp = open(self.scp_path, "w", encoding="utf-8")
        self._fnum = open(self.num_samples_path, "w", encoding="utf-8")

    def write(self, uttid: str, pcm16: np.ndarray, sr: int) -> str:
        """pcm16: int16 (n,) or (n, ch<=2). Returns the scp value."""
        pcm16 = np.asarray(pcm16, np.int16)
        if self.fmt == "flac":
            blob = _flac.encode_flac(pcm16, sr)
        else:
            bio = BytesIO()
            arr = pcm16[:, None] if pcm16.ndim == 1 else pcm16
            with _wave.open(bio, "wb") as w:
                w.setnchannels(arr.shape[1])
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(np.ascontiguousarray(arr).tobytes())
            blob = bio.getvalue()
        self._fark.write(uttid.encode() + b" ")
        offset = self._fark.tell()
        self._fark.write(blob)
        value = f"{self.ark_path}:{offset}"
        self._fscp.write(f"{uttid} {value}\n")
        n = pcm16.shape[0]
        self._fnum.write(f"{uttid} {n}\n")
        return value

    def close(self):
        for f in (self._fark, self._fscp, self._fnum):
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_ark(path: str):
    """Sequential scan of an extended ark: yields (uttid, scp_value)."""
    filesize = os.path.getsize(path)
    with open(path, "rb") as f:
        while f.tell() < filesize:
            key = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key += c
            offset = f.tell()
            head = f.read(_PROBE_BYTES)
            if head[:4] == b"RIFF":
                blob_len = _wav_blob_len(head)
            elif head[:4] == b"fLaC":
                # decode to find the stream end (frames carry no length);
                # bounded reads, grown on truncation — not the whole tail
                size = _CHUNK
                while True:
                    f.seek(offset)
                    data = f.read(size)
                    try:
                        _, _, blob_len = _flac.decode_flac(
                            data, verify_md5=False, return_consumed=True
                        )
                        break
                    except _flac.FlacError as e:
                        if ("truncated" in str(e)
                                and offset + size < filesize):
                            size *= 2
                            continue
                        raise
            else:
                raise ValueError(f"unrecognized blob at {path}:{offset}")
            yield key.decode(), f"{path}:{offset}"
            f.seek(offset + blob_len)
