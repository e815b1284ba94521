"""NIST SPHERE (.sph) audio reader (counterpart of `agacs_tpu/data/sph.py`)
— the sph2pipe equivalent.

The reference builds sph2pipe from `tools/Makefile` for corpora shipped as
SPHERE files (SURVEY §2.6 row: "SPH audio conversion"). SEAME/TMECS are
FLAC/WAV so the recipes never exercise it, but data dirs pointing at .sph
should still load. This reads the documented SPHERE container: an ASCII
header ("NIST_1A\\n<size>\\n" + "key -type value" lines up to "end_head")
followed by raw samples in PCM (8/16/24/32-bit, either byte order) or
µ-law/A-law coding.

Shorten-compressed payloads ("pcm,embedded-shorten-*") are NOT supported —
that is a patented-era compressor only sph2pipe decodes; convert those
once with sph2pipe. The error message says so explicitly.
"""

from __future__ import annotations

import os

import numpy as np

_MAGIC = b"NIST_1A\n"


def _ulaw_table() -> np.ndarray:
    # ITU-T G.711 µ-law expansion
    u = np.arange(256, dtype=np.int32)
    u = ~u & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = ((mantissa << 3) + 0x84) << exponent
    sample = sample - 0x84
    return np.where(sign, -sample, sample).astype(np.int16)


def _alaw_table() -> np.ndarray:
    # ITU-T G.711 A-law expansion (Sun/CCITT alaw2linear): after the 0x55
    # unmasking a SET sign bit means POSITIVE, and segment 0 has no shift
    a = np.arange(256, dtype=np.int32) ^ 0x55
    sign = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = a & 0x0F
    shifted = ((mantissa << 4) + 0x108) << np.maximum(exponent - 1, 0)
    sample = np.where(exponent == 0, (mantissa << 4) + 8, shifted)
    return np.where(sign, sample, -sample).astype(np.int16)


_ULAW = _ulaw_table()
_ALAW = _alaw_table()


def read_sph_header(data: bytes) -> dict:
    """Parse the SPHERE ASCII header from the file's first bytes."""
    if data[:8] != _MAGIC:
        raise ValueError("not a NIST SPHERE file (missing NIST_1A magic)")
    header_size = int(data[8:16].decode("ascii").strip())
    fields: dict[str, object] = {"header_size": header_size}
    for raw in data[16:header_size].decode("ascii", "replace").splitlines():
        line = raw.strip()
        if not line or line.startswith(";"):
            continue
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) != 3:
            continue
        key, typ, val = parts
        if typ == "-i":
            fields[key] = int(val)
        elif typ == "-r":
            fields[key] = float(val)
        else:  # -sN string
            fields[key] = val
    return fields


def read_sph(path: str) -> tuple[np.ndarray, int]:
    """Returns (float32 mono waveform in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    h = read_sph_header(data)
    coding = str(h.get("sample_coding", "pcm")).lower()
    n_bytes = int(h.get("sample_n_bytes", 2))
    channels = int(h.get("channel_count", 1))
    rate = int(h.get("sample_rate", 16000))
    byte_format = str(h.get("sample_byte_format", "01" if n_bytes > 1 else "1"))
    payload = data[int(h["header_size"]):]
    count = h.get("sample_count")
    if "shorten" in coding:
        raise ValueError(
            f"{path}: SPHERE payload is shorten-compressed ({coding!r}); "
            "decode it once with sph2pipe — only PCM/ulaw/alaw SPHERE is "
            "supported natively"
        )
    if coding.startswith("ulaw") or coding.startswith("mu-law"):
        pcm = _ULAW[np.frombuffer(payload, np.uint8)]
        scale = 32768.0
    elif coding.startswith("alaw") or coding.startswith("a-law"):
        pcm = _ALAW[np.frombuffer(payload, np.uint8)]
        scale = 32768.0
    elif coding.startswith("pcm") or coding == "raw":
        if n_bytes == 1:
            pcm = np.frombuffer(payload, np.int8).astype(np.int16) << 8
            scale = 32768.0
        elif n_bytes in (2, 4):
            dt = np.dtype(np.int16 if n_bytes == 2 else np.int32)
            dt = dt.newbyteorder("<" if byte_format == "01" else ">")
            pcm = np.frombuffer(payload, dt)
            scale = 32768.0 if n_bytes == 2 else 2147483648.0
        elif n_bytes == 3:
            b = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            if byte_format == "10":  # big-endian: reverse to little
                b = b[:, ::-1]
            pcm = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            pcm = (pcm << 8) >> 8  # sign-extend 24 -> 32
            scale = 8388608.0
        else:
            raise ValueError(f"{path}: unsupported sample_n_bytes {n_bytes}")
    else:
        raise ValueError(f"{path}: unsupported sample_coding {coding!r}")
    out = pcm.astype(np.float32) / scale
    if channels > 1:
        out = out[: (out.size // channels) * channels]
        out = out.reshape(-1, channels).mean(axis=1)
    if count is not None:
        out = out[: int(count)]
    return out, rate


def sph_num_samples(path: str) -> int:
    with open(path, "rb") as f:
        head = f.read(4096)
    h = read_sph_header(head)
    if "sample_count" in h:
        return int(h["sample_count"])
    n_bytes = int(h.get("sample_n_bytes", 2))
    channels = int(h.get("channel_count", 1))
    payload = os.path.getsize(path) - int(h["header_size"])
    return payload // (n_bytes * channels)
