"""Build and load the hand-written CUDA kernels of `agacs_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface. On first use it is compiled
with nvcc for sm_90a into `build/agacs_tpu_torch/<name>-<hash>.so` under
the checkout (the hash covers the source, the `csrc/*.cuh` headers and the
flags, so an edited source rebuilds) and loaded with ctypes. A failed build raises. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "agacs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}  # name -> nvcc output (ptxas register/smem report)


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if its hashed .so is missing); return the .so."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{BUILD_LOG[name]}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `fn` of csrc/<name>.cu, built and loaded on first use
    and cached (the wrappers call this on every launch). Every kernel entry
    returns cudaGetLastError() as an int."""
    f = _FNS.get((name, fn))
    if f is None:
        with _LOCK:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(build(name)))
            f = getattr(_LIBS[name], fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _FNS[(name, fn)] = f
    return f


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
