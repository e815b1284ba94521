"""W8A8 int8 linear of the frozen trunk (counterpart of
`agacs_tpu/ops/int8_linear.py`; kernel K8, `csrc/int8_gemm.cu`).

Scheme, as in JAX: weights symmetric per-output-channel int8, quantised
once (`quantize_weight`) in JAX's (d_in, d_out) layout; activations
dynamic symmetric per-row int8 at each use; int32 accumulation; epilogue
(acc * row scale) * channel scale, cast to the input's dtype. The frozen
trunk takes no weight gradient, so the backward is dx only, with dy * w_s
row-quantised to int8 against w_q^T (JAX `BWD_INT8 = True`).

On a CUDA tensor a forward at THIN_ROWS rows or fewer (a decode step's 8
or 40) is one launch, `thin_matmul`: the thin-row K8g with K8q folded in
(each rank of its K-split cluster takes its slice's row maxima, the ranks
exchange them, and each stage of x is quantised as it is staged;
`int8_serve.thin_tiling`). Every other product is two launches, K8q
`rowquant` and the wide K8g `int8_gemm` (s8 wgmma fed by TMA,
`gemm_tiling`; it takes any number of rows): the dgrad reads w_q as
stored, the forward w_q^T, which
the caller keeps (`w_t`: `models/whisper.py` `Int8Linear.weight_t` and the
fused projections' cache) and the CUDA path requires. On a CPU tensor the
plain versions below run the same arithmetic (the int32 sums are formed
exactly in float64). There is no fallback from the card to them.

`int8_linear` dispatches as JAX's (:133-150): a 2-D weight whose input
has thin rows (`int8_serve.thin_rows`: at most 32 rows, `AGACS_W8A16` on)
and that `int8_serve.fits` takes the weight-only W8A16 kernel K6
(`ops/int8_serve.py`, bf16 math on the dequantised weight, no row
quantisation); every other product takes K8. `AGACS_W8A16` is off by
default, as in JAX.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable

import torch

from agacs_tpu_torch.ops import cuda_lib, int8_serve

QUANT_LAUNCHES = 0  # K8q launches since the last reset (chip_smoke.py reads them)
LAUNCHES = 0        # K8g forward launches
DGRAD_LAUNCHES = 0  # K8g dgrad launches
THIN_LAUNCHES = 0   # of LAUNCHES, those of `thin_matmul`
THIN_ROWS = 64      # a forward takes `thin_matmul` at <= this many rows
WIDE_BN = 128       # output columns of a wide K8g tile (csrc/int8_gemm.cu WBN)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 as an IEEE division (PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead)."""
    amax = torch.clamp(amax, min=1e-12)
    return amax / torch.full_like(amax, 127.0)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a (..., d_in, d_out) weight
    (JAX `quantize_weight` :48): scale max|w| over d_in / 127, values
    round-half-even and clipped to +-127. Returns (int8 w_q, f32 (..., d_out))."""
    wf = w.float()
    s = _scale(wf.abs().amax(-2))
    q = torch.clamp(torch.round(wf / s[..., None, :]), -127, 127).to(torch.int8)
    return q, s


def dequantize_weight(w_q: torch.Tensor, w_s: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (w_q.float() * w_s[..., None, :]).to(dtype)


def row_quant_ref(x: torch.Tensor, col_scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 (JAX `_row_quant` :65): v = x (times
    `col_scale` per column) in float32; s = max(max|v|, 1e-12) / 127;
    q = round(v / s). Returns (int8 (..., k), f32 (..., 1))."""
    v = x.float()
    if col_scale is not None:
        v = v * col_scale
    s = _scale(v.abs().amax(-1, keepdim=True))
    return torch.round(v / s).to(torch.int8), s


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of int8 a @ b, as float32 (formed in float64:
    every partial sum is an integer below 2^53; the one rounding to float32
    is the int32 -> float32 conversion of the JAX epilogue)."""
    return (a.double() @ b.double()).float()


def int8_gemm_ref(q, s_row, w_q, w_s=None, dgrad=False, out_dtype=torch.float32):
    """K8g's plain version: (q . w_q) * s_row * w_s (forward) or
    (q . w_q^T) * s_row (dgrad), cast to `out_dtype`. s_row (M, 1)."""
    acc = int_mm(q, w_q.t() if dgrad else w_q) * s_row
    if not dgrad:
        acc = acc * w_s
    return acc.to(out_dtype)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w_q, w_s) on the int8 path (JAX `_fwd_core` :83)."""
    xq, sx = row_quant_ref(x)
    return int8_gemm_ref(xq, sx, w_q, w_s, out_dtype=x.dtype)


def int8_matmul_dgrad_ref(g: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                          x_dtype: torch.dtype) -> torch.Tensor:
    """dx of `int8_matmul` (JAX `_int8_bwd` :108, BWD_INT8): q8[dy * w_s]
    against w_q^T, times the row scale."""
    gq, sg = row_quant_ref(g, w_s)
    return int8_gemm_ref(gq, sg, w_q, dgrad=True, out_dtype=x_dtype)


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def thin_gemm(m: int, dgrad: bool) -> bool:
    """Whether a product takes the thin-row K8g (`thin_matmul`, K8q folded
    in): the forward at THIN_ROWS rows or fewer."""
    return not dgrad and m <= THIN_ROWS


def gemm_tiling(m: int, n: int, sms: int) -> tuple[int, int]:
    """(BM, BN) of the wide K8g's output tiles on a card of `sms` SMs (the
    kernel's persistent grid takes one block an SM): 128 x 128 when those
    tiles give every SM one, else 64 x 128 (the teacher-forced decoder's
    528 rows on the H100's 132 SMs: 30 tiles of 128 rows, 54 of 64)."""
    tiles_n = -(-n // WIDE_BN)
    return (128 if -(-m // 128) * tiles_n >= sms else 64), WIDE_BN


def thin_matmul_split_ref(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                          splits: int) -> torch.Tensor:
    """`thin_matmul`'s cluster split in plain PyTorch (for tests): each
    rank's partial row maxima of |x| over its `int8_serve.split_ranges`
    slice of K (K8_KR-row stages; a rank past K holds none), the max of
    the S partials as every rank's scale, each rank's slice quantised with
    it, then `int8_gemm_split_ref` (the int32 partials in rank order and
    the epilogue), cast to x's dtype once."""
    v = x.float()
    ranges = int8_serve.split_ranges(x.shape[-1], int8_serve.K8_KR, splits)
    amax = torch.stack([v[:, k0:k1].abs().amax(-1) if k1 > k0 else v.new_zeros(len(v))
                        for k0, k1 in ranges]).amax(0)  # an empty rank's partial: 0
    s_row = _scale(amax)[:, None]
    q = torch.round(v / s_row).to(torch.int8)  # every rank's slice with the one scale
    return int8_gemm_split_ref(q, s_row, w_q, w_s, splits, x.dtype)


def int8_gemm_split_ref(q: torch.Tensor, s_row: torch.Tensor, w_q: torch.Tensor,
                        w_s: torch.Tensor, splits: int,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The thin K8g's split over K after the row quantisation, in plain
    PyTorch (for tests): each block's exact int32 partial over its
    `int8_serve.split_ranges` rows (K8_KR-row stages), the partials added
    in rank order, then the epilogue (acc * s_row) * w_s, cast once."""
    acc = None
    for k0, k1 in int8_serve.split_ranges(q.shape[-1], int8_serve.K8_KR, splits):
        part = q[:, k0:k1].long() @ w_q[k0:k1].long()
        acc = part if acc is None else acc + part
    return (acc.float() * s_row * w_s).to(out_dtype)


def _check(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}; the kernel takes a "
                             "CUDA tensor")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def rowquant(x: torch.Tensor, col_scale: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8q on a CUDA x (M, K) bf16/f32: (int8 q (M, K), f32 s (M, 1));
    `row_quant_ref` on a CPU x."""
    if x.device.type == "cpu":
        return row_quant_ref(x, col_scale)
    _check("int8_rowquant", x=x, col_scale=col_scale)
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise ValueError(f"int8_rowquant: x {tuple(x.shape)} {x.dtype}; the kernel "
                         "takes a 2-D bfloat16 or float32 tensor")
    m, k = x.shape
    if col_scale is not None and (col_scale.dtype != torch.float32
                                  or col_scale.shape != (k,)):
        raise ValueError(f"int8_rowquant: col_scale must be float32 ({k},)")
    q = torch.empty(m, k, dtype=torch.int8, device=x.device)
    s = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    fn = cuda_lib.load("int8_gemm", "int8_rowquant",
                       [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), _DTYPES[x.dtype],
            None if col_scale is None else col_scale.data_ptr(), q.data_ptr(),
            s.data_ptr(), m, k, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "int8_rowquant")
    global QUANT_LAUNCHES
    QUANT_LAUNCHES += 1
    return q, s


def int8_gemm(q: torch.Tensor, s_row: torch.Tensor, w_q: torch.Tensor,
              w_s: torch.Tensor | None = None, dgrad: bool = False,
              out_dtype: torch.dtype = torch.float32,
              w_t: torch.Tensor | None = None) -> torch.Tensor:
    """The wide K8g on CUDA tensors: (q . w_q) * s_row * w_s, or (q . w_q^T)
    * s_row with `dgrad`; `int8_gemm_ref` on CPU tensors. q (M, K) int8
    (any M), s_row (M, 1) f32, w_q (d_in, d_out) int8, w_s (d_out,) f32.
    The forward reads `w_t` = w_q^T (d_out, d_in), contiguous, and raises
    without it."""
    if q.device.type == "cpu":
        return int8_gemm_ref(q, s_row, w_q, w_s, dgrad, out_dtype)
    _check("int8_gemm", q=q, s_row=s_row, w_q=w_q, w_s=w_s, w_t=w_t)
    m, k = q.shape
    n = w_q.shape[0] if dgrad else w_q.shape[1]
    if (q.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.dim() != 2
            or (w_q.shape[1] if dgrad else w_q.shape[0]) != k
            or s_row.shape != (m, 1) or s_row.dtype != torch.float32
            or (not dgrad and (w_s is None or w_s.shape != (n,)
                               or w_s.dtype != torch.float32))
            or out_dtype not in _DTYPES):
        raise ValueError(f"int8_gemm: q {tuple(q.shape)} {q.dtype}, w_q "
                         f"{tuple(w_q.shape)} {w_q.dtype}, dgrad={dgrad}, out "
                         f"{out_dtype}: shapes or types the kernel does not take")
    if k % 16 or n % 16:
        raise ValueError(f"int8_gemm: K {k} and N {n} must be multiples of 16")
    if not dgrad and (w_t is None or w_t.dtype != torch.int8 or w_t.shape != (n, k)):
        raise ValueError("int8_gemm: the forward takes w_t = w_q^T "
                         f"({n}, {k}) int8, kept by the caller")
    out = torch.empty(m, n, dtype=out_dtype, device=q.device)
    bm = gemm_tiling(m, n, torch.cuda.get_device_properties(q.device).multi_processor_count)[0]
    fn = cuda_lib.load("int8_gemm", "int8_gemm",
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(q.data_ptr(), s_row.data_ptr(), w_q.data_ptr(),
            None if dgrad else w_t.data_ptr(), None if dgrad else w_s.data_ptr(),
            out.data_ptr(), _DTYPES[out_dtype], m, n, k, int(dgrad), bm,
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "int8_gemm")
    global LAUNCHES, DGRAD_LAUNCHES
    if dgrad:
        DGRAD_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def thin_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(w_q, w_s) on the int8 path for M <= THIN_ROWS in
    ONE launch on a CUDA x (bf16 or f32; the output in x's dtype): K8q
    folded into the thin K8g. `int8_matmul_ref` on a CPU x."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, w_s)
    _check("int8_thin_matmul", x=x, w_q=w_q, w_s=w_s)
    m, k = x.shape[0], x.shape[-1]
    n = w_q.shape[-1]
    if (x.dtype not in _DTYPES or x.dim() != 2 or not 0 < m <= THIN_ROWS
            or w_q.dtype != torch.int8 or w_q.shape != (k, n)
            or w_s.dtype != torch.float32 or w_s.shape != (n,)):
        raise ValueError(f"int8_thin_matmul: x {tuple(x.shape)} {x.dtype}, w_q "
                         f"{tuple(w_q.shape)} {w_q.dtype}: the kernel takes 1 to "
                         f"{THIN_ROWS} rows of bf16 or f32 against an int8 (K, N) weight")
    if k % 16 or n % 16:
        raise ValueError(f"int8_thin_matmul: K {k} and N {n} must be multiples of 16")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    bn, splits = int8_serve.thin_tiling(m, n, k, int8_serve.K8_KR)
    fn = cuda_lib.load("int8_gemm", "int8_thin_matmul",
                       [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), _DTYPES[x.dtype], w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(),
            m, n, k, bn, splits, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "int8_thin_matmul")
    global LAUNCHES, THIN_LAUNCHES
    LAUNCHES += 1
    THIN_LAUNCHES += 1
    return out


def derived(cache: dict, weights: tuple[torch.Tensor, ...], make: Callable[[], object]):
    """make() for `weights`, kept in `cache` until one of them moves, is
    written in place or is cut to another shard (keyed by each weight's
    address, `_version` and shape): the derived weights the kernels read
    (the transposes, the fused projections' concatenation, the logits
    head's compute-dtype copy). The entry holds the weights too, so no new
    tensor can take their addresses while it lives; a new key drops the
    old entry. The value is made outside inference mode, so a copy first
    made for a decode request can be saved for a later training step's
    backward; a weight that is itself an inference tensor has no version
    counter and counts as version 0."""
    key = tuple((t.data_ptr(), 0 if t.is_inference() else t._version, tuple(t.shape))
                for t in weights)
    hit = cache.get(key)
    if hit is not None:
        return hit[0]
    with torch.inference_mode(False):
        value = make()
    cache.clear()
    cache[key] = (value, weights)
    return value


def transposed(*weights: torch.Tensor, cache: dict | None = None) -> tuple[torch.Tensor, ...]:
    """Each weight transposed, contiguous: the K-major B operands of the s8
    wgmma kernels (the wide K8g forward reads w_q^T; K2 w1q^T and w2q^T),
    kept in `cache` (when given) by `derived`."""
    def make():
        return tuple(t.t().contiguous() for t in weights)

    return make() if cache is None else derived(cache, weights, make)


def _matmul(x2: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
            w_t: Callable[[], torch.Tensor] | None = None) -> torch.Tensor:
    if thin_gemm(x2.shape[0], False):
        return thin_matmul(x2, w_q, w_s)
    q, s = rowquant(x2)
    return int8_gemm(q, s, w_q, w_s, out_dtype=x2.dtype,
                     w_t=w_t() if w_t is not None and q.is_cuda else None)


def _dgrad(g2: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
           x_dtype: torch.dtype) -> torch.Tensor:
    q, s = rowquant(g2, w_s)
    return int8_gemm(q, s, w_q, dgrad=True, out_dtype=x_dtype)


class Int8Matmul(torch.autograd.Function):
    """JAX's custom VJP (:92-130): no activation is saved; the backward
    returns dx only, and only when x needs it. `w_t` (a function giving
    w_q^T, which the wide forward reads on the card) rides along
    untracked."""

    @staticmethod
    def forward(ctx, x2, w_q, w_s, w_t=None):
        ctx.save_for_backward(w_q, w_s)
        ctx.x_dtype = x2.dtype
        return _matmul(x2, w_q, w_s, w_t)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        w_q, w_s = ctx.saved_tensors
        return _dgrad(g.contiguous(), w_q, w_s, ctx.x_dtype), None, None, None


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                w_t: Callable[[], torch.Tensor] | None = None) -> torch.Tensor:
    """x (..., d_in) @ dequant(w_q, w_s) on the int8 path, through the
    autograd Function when x takes a gradient. `w_t`: a function giving
    w_q^T (contiguous), called only where the wide K8g forward runs on the
    card, which requires it."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and x.requires_grad:
        y = Int8Matmul.apply(x2, w_q, w_s, w_t)
    else:
        y = _matmul(x2, w_q, w_s, w_t)
    return y.reshape(*x.shape[:-1], w_q.shape[1])


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                b: torch.Tensor | None = None,
                w_t: Callable[[], torch.Tensor] | None = None) -> torch.Tensor:
    """JAX `int8_linear` (:133): K6 for thin rows under `AGACS_W8A16`, else
    K8 (`w_t` as `int8_matmul`'s); the bias is added outside the product,
    in the output's dtype."""
    if w_q.dim() == 2 and int8_serve.thin_rows(x) and int8_serve.fits(w_q):
        y = int8_serve.w8a16_matmul(x, w_q, w_s)
    else:
        y = int8_matmul(x, w_q, w_s, w_t)
    return y if b is None else y + b.to(y.dtype)
