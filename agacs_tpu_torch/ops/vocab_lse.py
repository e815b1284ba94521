"""Streaming log-sum-exp over the vocabulary projection of a CTC head
(counterpart of `agacs_tpu/ops/vocab_lse.py`; kernel K4,
`csrc/vocab_lse.cu`).

`streaming_lse(x, w, b)` is the row-wise logsumexp(x . w + b) (N,) float32
for rows x (N, K), w (K, V), b (V,), differentiable in all three, without
the (N, V) logits in device memory: a `torch.autograd.Function` (JAX's
custom VJP) whose forward is K4's forward and whose backward is K4's dx and
dw passes over z recomputed from the saved lse:

    dz = exp(z - lse) * g,   dx = bf16(dz) . w^T,   dW = x^T . bf16(dz),
    db = sum over rows of dz

(dx in x's dtype, dW accumulated in float32 and cast to w's dtype, db
float32, as JAX's `_bwd_pallas` returns them). On a CPU tensor it runs the
plain versions `lse_plain` (JAX `_einsum_ref`) and `lse_bwd_plain` (the
kernels' arithmetic), on a CUDA tensor it launches K4 or raises: the card
has no dense-logits fallback. K4 takes bf16 x and w, float32 b, and K a
multiple of 128 up to 1024; a w whose V is not a multiple of 8 (the
Whisper vocabulary's 51865) is handed over as a copy with its rows padded,
for the kernels' 16-byte loads.
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib

BV = 64  # the kernels' vocabulary tile
FWD_LAUNCHES = 0  # K4 launches since the last reset (chip_smoke.py reads them)
DX_LAUNCHES = 0
DW_LAUNCHES = 0


def lse_plain(x, w, b) -> torch.Tensor:
    """(N,) float32 logsumexp of x . w (products of the input dtype's values
    accumulated in float32) + b."""
    return torch.logsumexp(x.float() @ w.float() + b.float(), -1)


def lse_bwd_plain(x, w, b, lse, g):
    """(dx, dW, db) of `lse_plain` for g = d loss / d lse, with the
    kernels' rounding: dz in float32, rounded to w's dtype for both
    products."""
    dz = torch.exp(x.float() @ w.float() + b.float() - lse[:, None]) * g[:, None]
    dzr = dz.to(w.dtype).float()
    return ((dzr @ w.float().t()).to(x.dtype), (x.float().t() @ dzr).to(w.dtype),
            dz.sum(0))


def _check(x, w, b) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"vocab_lse: K4 runs on a CUDA tensor, not on {x.device}")
    for name, t, want in (("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
                          ("b", b, torch.float32)):
        if t.dtype != want or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"vocab_lse: {name} is {t.dtype} on {t.device}; K4 takes a "
                             f"contiguous {want} on {x.device}")
    n, k = x.shape
    if w.shape[0] != k or b.shape != (w.shape[1],):
        raise ValueError(f"vocab_lse: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if k % 128 or k > 1024:
        raise ValueError(f"vocab_lse: K {k}; K4 takes a multiple of 128 up to 1024")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _rows8(w: torch.Tensor) -> torch.Tensor:
    """w with its rows padded to a multiple of 8 columns (zeros), so that
    the kernels read them with 16-byte loads: a copy when V % 8 != 0."""
    v = w.shape[1]
    return w if v % 8 == 0 else torch.nn.functional.pad(w, (0, 8 - v % 8))


def _launch_fwd(x, w, b) -> torch.Tensor:
    _check(x, w, b)
    n, k = x.shape
    v = w.shape[1]
    n_vt = -(-v // BV)
    row_tiles = -(-n // 64)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(n_vt, -(-4 * sms // row_tiles)))  # ~4 blocks an SM
    part = torch.empty(2, splits, n, device=x.device)
    lse = torch.empty(n, device=x.device)
    wp = _rows8(w)
    fn = cuda_lib.load("vocab_lse", "vocab_lse_fwd",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), wp.data_ptr(), wp.shape[1], b.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), lse.data_ptr(), n, k, v, splits, _stream(x))
    cuda_lib.check(rc, "vocab_lse_fwd")
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    return lse


def _launch_dx(x, w, b, lse, g) -> torch.Tensor:
    """K4's dx pass: (N, K) in x's dtype."""
    _check(x, w, b)
    n, k = x.shape
    dx = torch.empty_like(x)
    wp = _rows8(w)
    fn = cuda_lib.load("vocab_lse", "vocab_lse_dx",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), wp.data_ptr(), wp.shape[1], b.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dx.data_ptr(), n, k, w.shape[1], _stream(x))
    cuda_lib.check(rc, "vocab_lse_dx")
    global DX_LAUNCHES
    DX_LAUNCHES += 1
    return dx


def _launch_dw(x, w, b, lse, g) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's dw pass: dW (K, V) accumulated in float32, cast to w's dtype,
    and db (V,) float32."""
    _check(x, w, b)
    n, k = x.shape
    v = w.shape[1]
    vp = -(-v // BV) * BV
    dw = torch.empty(k, vp, device=x.device)
    db = torch.empty(vp, device=x.device)
    wp = _rows8(w)
    fn = cuda_lib.load("vocab_lse", "vocab_lse_dw",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), wp.data_ptr(), wp.shape[1], b.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dw.data_ptr(), db.data_ptr(), n, k, v, vp, _stream(x))
    cuda_lib.check(rc, "vocab_lse_dw")
    global DW_LAUNCHES
    DW_LAUNCHES += 1
    return dw[:, :v].to(w.dtype), db[:v]


class _StreamingLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        lse = lse_plain(x, w, b) if x.device.type == "cpu" else _launch_fwd(x, w, b)
        ctx.save_for_backward(x, w, b, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, w, b, lse = ctx.saved_tensors
        if x.device.type == "cpu":
            return lse_bwd_plain(x, w, b, lse, g)
        g = g.float().contiguous()
        return (_launch_dx(x, w, b, lse, g), *_launch_dw(x, w, b, lse, g))


def streaming_lse(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise logsumexp(x . w + b): x (N, K), w (K, V), b (V,) -> (N,)
    float32; differentiable in x, w and b."""
    return _StreamingLSE.apply(x, w, b)
