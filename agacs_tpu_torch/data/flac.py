"""FLAC read/write (counterpart of `agacs_tpu/data/flac.py`): the native
codec `native/flac.cpp` (RFC 9639: decode, and a fixed-predictor 16-bit
encoder), and a pure-Python decoder as its plain version.

The native codec is compiled with g++ on first use into
`build/agacs_tpu_torch/flac-<hash>.so` under the checkout (the hash
covers the source and the flags, so an edited source rebuilds) and loaded
with ctypes. A failed build raises; nothing falls back to the Python
decoder. That decoder runs only when a caller asks for it
(`native=False`), as the tests do to hold the codec against it. Every
decode checks the PCM against the MD5 that FLAC keeps in STREAMINFO.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from pathlib import Path

import numpy as np

from agacs_tpu_torch.utils import native

SRC = native.SRC_DIR / "flac.cpp"
BUILD_DIR = native.BUILD_DIR
CXX = os.environ.get("CXX", "g++")

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


class FlacError(ValueError):
    pass


def build() -> Path:
    """Compile native/flac.cpp (if its hashed .so is missing); return the .so."""
    return native.build_shared(SRC, BUILD_DIR, CXX)


def native_lib() -> ctypes.CDLL:
    """The codec, built and loaded on first use (a failed build raises, and
    the next call tries again)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.flac_decode.restype = ctypes.c_longlong
            lib.flac_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.flac_encode16.restype = ctypes.c_longlong
            lib.flac_encode16.argtypes = [
                ctypes.POINTER(ctypes.c_int16), ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
            ]
            _LIB = lib
        return _LIB


def flac_info(data: bytes) -> dict:
    """STREAMINFO fields: sample_rate, channels, bps, total_samples, md5."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream")
    p = 4
    while p + 4 <= len(data):
        hdr = data[p]
        blen = int.from_bytes(data[p + 1 : p + 4], "big")
        p += 4
        if (hdr & 0x7F) == 0:
            b = data[p : p + 34]
            if len(b) < 34:
                raise FlacError("truncated STREAMINFO")
            return {
                "sample_rate": (b[10] << 12) | (b[11] << 4) | (b[12] >> 4),
                "channels": ((b[12] >> 1) & 0x7) + 1,
                "bps": (((b[12] & 1) << 4) | (b[13] >> 4)) + 1,
                "total_samples": ((b[13] & 0x0F) << 32) | int.from_bytes(b[14:18], "big"),
                "md5": b[18:34],
            }
        p += blen
        if hdr & 0x80:
            break
    raise FlacError("no STREAMINFO block")


def decode_flac(data: bytes, verify_md5: bool = True, return_consumed: bool = False,
                native: bool = True):
    """FLAC bytes -> (int32 array (n, channels), sample_rate), through the
    native codec, or the Python decoder with `native=False`.

    With return_consumed=True also returns the stream's byte length —
    trailing bytes (e.g. the next entry of a concatenated ark) are ignored.
    Raises FlacError on malformed/truncated input or MD5 mismatch.
    """
    info = flac_info(data)
    n, ch, bps = info["total_samples"], info["channels"], info["bps"]
    if native:
        lib = native_lib()
        consumed = ctypes.c_longlong(0)
        out = np.empty((n * ch,), np.int32)
        rc = lib.flac_decode(data, len(data),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             ctypes.byref(consumed))
        if rc == -2:
            raise FlacError("truncated FLAC stream")
        if rc < 0:
            raise FlacError("malformed FLAC stream")
        pcm, consumed = out[: rc * ch].reshape(-1, ch), consumed.value
    else:
        pcm, consumed = decode_py(data, info)
    if verify_md5 and info["md5"] != b"\x00" * 16 and len(pcm) == n:
        if bps == 16:
            raw = pcm.astype("<i2").tobytes()
        elif bps == 8:
            raw = pcm.astype(np.int8).tobytes()
        elif bps == 24:
            le = pcm.astype("<i4").tobytes()
            raw = b"".join(le[i : i + 3] for i in range(0, len(le), 4))
        else:
            raw = None
        if raw is not None and hashlib.md5(raw).digest() != info["md5"]:
            raise FlacError("FLAC PCM MD5 mismatch (decoder bug or corrupt file)")
    if return_consumed:
        return pcm, info["sample_rate"], consumed
    return pcm, info["sample_rate"]


def encode_flac(pcm: np.ndarray, sample_rate: int) -> bytes:
    """int16 PCM (n,) or (n, channels<=2) -> FLAC bytes (fixed predictors)."""
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    if pcm.dtype != np.int16:
        raise ValueError(f"encode_flac wants int16, got {pcm.dtype}")
    n, ch = pcm.shape
    inter = np.ascontiguousarray(pcm).reshape(-1)
    md5 = hashlib.md5(inter.astype("<i2").tobytes()).digest()
    cap = 8192 + n * ch * 3  # worst case ≈ verbatim + headers
    out = np.empty((cap,), np.uint8)
    rc = native_lib().flac_encode16(
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n, ch, sample_rate, md5,
        out.ctypes.data_as(ctypes.c_char_p), cap)
    if rc < 0:
        raise RuntimeError("FLAC encode failed (buffer too small?)")
    return out[:rc].tobytes()


def read_flac(path: str, native: bool = True) -> tuple[np.ndarray, int]:
    """File path -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr = decode_flac(data, native=native)
    return pcm_to_float(pcm, flac_info(data)["bps"]), sr


def write_flac(path: str, data: np.ndarray, sr: int = 16000) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_flac(float_to_pcm16(data), sr))


def pcm_to_float(pcm: np.ndarray, bps: int) -> np.ndarray:
    """(n, ch) int PCM -> float32 mono in [-1, 1] (channel mean)."""
    x = pcm.astype(np.float32) / float(1 << (bps - 1))
    return x.mean(axis=1) if x.ndim == 2 else x


def float_to_pcm16(data: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    return (x * 32767.0).astype(np.int16)


# ----------------------------------------------- the plain (Python) decoder


class _BitReader:
    __slots__ = ("data", "n", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data) * 8
        self.pos = 0

    def bits(self, k: int) -> int:
        p = self.pos
        if p + k > self.n:
            raise FlacError("truncated FLAC stream")
        self.pos = p + k
        # gather the covering bytes, then shift out the slack
        start, end = p >> 3, (p + k + 7) >> 3
        v = int.from_bytes(self.data[start:end], "big")
        slack = (end << 3) - (p + k)
        return (v >> slack) & ((1 << k) - 1)

    def sbits(self, k: int) -> int:
        v = self.bits(k)
        return v - (1 << k) if k and (v >> (k - 1)) else v

    def unary(self) -> int:
        q = 0
        while self.bits(1) == 0:
            q += 1
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7


def _read_residual(br: _BitReader, buf: list, blocksize: int, order: int):
    method = br.bits(2)
    if method > 1:
        raise FlacError("bad residual method")
    pbits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    po = br.bits(4)
    nparts = 1 << po
    if blocksize % nparts:
        raise FlacError("bad partition order")
    for part in range(nparts):
        count = (blocksize >> po) - (order if part == 0 else 0)
        param = br.bits(pbits)
        if param == escape:
            raw = br.bits(5)
            buf.extend(br.sbits(raw) if raw else 0 for _ in range(count))
        else:
            for _ in range(count):
                q = br.unary()
                v = (q << param) | br.bits(param)
                buf.append((v >> 1) ^ -(v & 1))


_FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> list:
    if br.bits(1) != 0:
        raise FlacError("bad subframe pad bit")
    stype = br.bits(6)
    wasted = 0
    if br.bits(1):
        wasted = br.unary() + 1
    bps -= wasted
    if stype == 0:
        buf = [br.sbits(bps)] * blocksize
    elif stype == 1:
        buf = [br.sbits(bps) for _ in range(blocksize)]
    elif (stype & 0x38) == 0x08 and (stype & 0x07) <= 4:
        order = stype & 0x07
        buf = [br.sbits(bps) for _ in range(order)]
        _read_residual(br, buf, blocksize, order)
        coef = _FIXED[order]
        for i in range(order, blocksize):
            buf[i] += sum(c * buf[i - j - 1] for j, c in enumerate(coef))
    elif stype & 0x20:
        order = (stype & 0x1F) + 1
        buf = [br.sbits(bps) for _ in range(order)]
        precision = br.bits(4) + 1
        if precision == 16:
            raise FlacError("invalid qlp precision")
        shift = br.sbits(5)
        coef = [br.sbits(precision) for _ in range(order)]
        _read_residual(br, buf, blocksize, order)
        for i in range(order, blocksize):
            buf[i] += sum(c * buf[i - j - 1] for j, c in enumerate(coef)) >> shift
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        buf = [v << wasted for v in buf]
    return buf


_BLOCKSIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256, 9: 512, 10: 1024,
               11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768}
_SAMPLESIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def decode_py(data: bytes, info: dict | None = None) -> tuple[np.ndarray, int]:
    """The plain decoder: FLAC bytes -> (int32 (n, channels), the stream's
    byte length). Slow; no MD5 check (`decode_flac(native=False)` adds it)."""
    info = info or flac_info(data)
    p = 4  # skip the metadata blocks to the first frame
    while True:
        if p + 4 > len(data):
            raise FlacError("truncated FLAC stream")
        hdr = data[p]
        p += 4 + int.from_bytes(data[p + 1 : p + 4], "big")
        if hdr & 0x80:
            break
    br = _BitReader(data)
    br.pos = p * 8
    n, nch = info["total_samples"], info["channels"]
    out = np.empty((n, nch), np.int64)
    done = 0
    while done < n:
        if br.bits(14) != 0x3FFE:
            raise FlacError("lost frame sync")
        br.bits(2)  # reserved + blocking strategy
        bs_code, sr_code, ch_code = br.bits(4), br.bits(4), br.bits(4)
        ss_code = br.bits(3)
        br.bits(1)
        first = br.bits(8)
        follow, m = 0, 0x80
        while first & m:
            follow += 1
            m >>= 1
        for _ in range(max(follow - 1, 0)):
            br.bits(8)
        if bs_code == 6:
            blocksize = br.bits(8) + 1
        elif bs_code == 7:
            blocksize = br.bits(16) + 1
        elif bs_code in _BLOCKSIZES:
            blocksize = _BLOCKSIZES[bs_code]
        else:
            raise FlacError(f"reserved block size code {bs_code}")
        if sr_code == 12:
            br.bits(8)
        elif sr_code in (13, 14):
            br.bits(16)
        br.bits(8)  # crc8
        channels = ch_code + 1 if ch_code < 8 else 2
        if channels != nch:
            raise FlacError("a frame's channel count differs from STREAMINFO's")
        if ss_code != 0 and ss_code not in _SAMPLESIZES:
            raise FlacError(f"reserved sample size code {ss_code}")
        bps = info["bps"] if ss_code == 0 else _SAMPLESIZES[ss_code]
        chans = []
        for c in range(channels):
            side = (ch_code == 8 and c == 1) or (ch_code == 9 and c == 0) \
                or (ch_code == 10 and c == 1)
            chans.append(_decode_subframe(br, blocksize, bps + side))
        br.align()
        br.bits(16)  # crc16
        if ch_code == 8:
            chans[1] = [a - s for a, s in zip(chans[0], chans[1])]
        elif ch_code == 9:
            chans[0] = [s + b for s, b in zip(chans[0], chans[1])]
        elif ch_code == 10:
            mids = [(m_ << 1) | (s & 1) for m_, s in zip(chans[0], chans[1])]
            chans = [[(mid + s) >> 1 for mid, s in zip(mids, chans[1])],
                     [(mid - s) >> 1 for mid, s in zip(mids, chans[1])]]
        take = min(blocksize, n - done)
        for c in range(channels):
            out[done : done + take, c] = chans[c][:take]
        done += take
    return out.astype(np.int32), br.pos >> 3
