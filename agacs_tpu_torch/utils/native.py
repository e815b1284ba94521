"""The port's host-side C++ libraries (`native/*.cpp`: the FLAC codec, the
DTW of word timing, the sclite aligner of scoring), compiled with g++ on
first use into `build/agacs_tpu_torch/<name>-<hash>.so` under the
checkout and loaded with ctypes. The hash covers the source and the flags,
so an edited source rebuilds. A failed build raises; nothing falls back to
Python (each module keeps its Python version as the plain version the
tests hold the library against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "agacs_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def build_shared(src: Path, build_dir: Path, cxx: str) -> Path:
    """Compile `src` (if its hashed .so is missing); return the .so."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode())
    out = build_dir / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building {src} with {cxx!r} failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class NativeLibrary:
    """`native/<name>.cpp`, built and loaded on the first call; `declare`
    sets the entry points' ctypes signatures. A failed build raises, and the
    next call tries again. `cxx` (default: $CXX, else g++) and `build_dir`
    may be changed before the first call."""

    def __init__(self, name: str, declare):
        self.src = SRC_DIR / f"{name}.cpp"
        self.declare = declare
        self.cxx = os.environ.get("CXX", "g++")
        self.build_dir = BUILD_DIR
        self.lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def __call__(self) -> ctypes.CDLL:
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(build_shared(self.src, self.build_dir, self.cxx)))
                self.declare(lib)
                self.lib = lib
            return self.lib
