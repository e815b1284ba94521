"""Fused W8A8 MLP of the frozen int8 trunk, fc2(gelu(fc1(x))), and its dx
(counterpart of `agacs_tpu/ops/int8_mlp.py`; kernels K2f and K2b,
`csrc/int8_mlp.cu`).

Quantisation as in `ops/int8_linear.py`: x row-quantised to int8, int32
products against the per-channel int8 weights, the hidden (bias, exact-erf
GELU with the Abramowitz-Stegun erf, all float32) row-quantised again
before fc2. The trunk is frozen: the backward is dx only, with the hidden
recomputed (JAX `_bwd_kernel` :126):

    dx = q8[(q8[dy * s2] . w2q^T) * gelu'(h) * s1] . w1q^T

`int8_mlp` goes through the autograd Function `Int8MLP` when x takes a
gradient. On a CPU tensor it runs the plain versions (`int8_mlp_fwd_ref`,
`int8_mlp_bwd_ref`: the kernels' arithmetic, operation for operation); on
a CUDA tensor it launches K2f / K2b or raises. Unlike the JAX VJP, which
returns zero bias gradients, a bias that requires grad raises: no freeze
preset trains the trunk's biases while its weights are frozen.

The model (`models/whisper.py` `MLP`) takes this path, as JAX's `mlp_fwd`
does, for at least `TR` rows and the shapes JAX's `supports` admits: d, h
multiples of 128 within JAX's budget 2·d·h + 8·TR·h + 8·TR·d <= 13 MiB
(`agacs_tpu/ops/int8_mlp.py:63-69`); other shapes take the unfused
`int8_linear` . gelu . `int8_linear` (`unfused`). The two differ
numerically (float32 vs compute-dtype hidden), so both the row rule and
the budget decide the numbers and are kept for parity with JAX, not for
speed: whisper-medium and -large (d 1024, h 4096 and d 1280, h 5120) fall
outside the budget and run unfused, as in JAX.

The kernels split a 64-row tile's hidden columns over a thread-block
cluster of C blocks, each holding its h / C columns of the float32 hidden
in registers (at most 3 units of 128), exchanging row maxima and adding
its int32 partials of the second product across the cluster
(`mlp_tiling`; `int8_mlp_fwd_split_ref` / `int8_mlp_bwd_split_ref` model
the split in plain PyTorch). They take d a multiple of 128 up to 1024 and
h = 128 · C · U with C in {1, 2, 4, 8} and U <= 3, so h <= 3072 (whisper
tiny 384/1536, base 512/2048, small 768/3072); `_check` raises on other
shapes. Their B operands are K-major, so they read w1q^T and w2q^T:
`int8_linear.transposed` makes those once, `MLP` keeps them until a
weight moves or is written, and the CUDA wrappers raise without them.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from agacs_tpu_torch.ops import cuda_lib
from agacs_tpu_torch.ops.int8_linear import _scale, int8_linear, int_mm, row_quant_ref

TR = 256       # JAX's forward row block: the fused path's least row count
FWD_LAUNCHES = 0  # K2f launches since the last reset (chip_smoke.py reads them)
BWD_LAUNCHES = 0  # K2b launches

# The kernels' tiling constants (csrc/int8_mlp.cu; the CPU tests read both).
K2_BM = 64           # rows of a tile: one m64 wgmma tile, shared by a cluster
K2_UNIT = 128        # hidden columns of a unit: 64 per consumer warpgroup
K2_MAX_UNITS = 3     # units a rank keeps in registers (U x 32 floats a thread)
K2_CLUSTERS = (1, 2, 4, 8)  # cluster sizes the kernels take (8: the portable most)
K2_MAX_STAGES = 8    # ring slots
K2_MAX_KB = 8        # 128-byte k-blocks of x a row: d <= 1024
K2_SLOT = 128 * 128  # bytes of a ring slot: one 128 x 128 TMA box of int8
K2_PLD = 136         # int32 row stride of a partial output chunk
K2_MAX_LOADS = 3 * K2_MAX_KB * K2_MAX_UNITS  # ring loads a block (K2b's first products, then the second)
K2_SMALL = (3 * K2_BM * 4 + 8 * 2 * K2_BM * 4 + 2 * K2_MAX_STAGES * 8
            + K2_MAX_LOADS * 4)  # scales, row maxima, barriers, the load table
K2_SMEM = 232448     # shared memory a block may opt into on the H100 (227 KB)

_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_P = 0.3275911
_RSQRT2 = 2.0 ** -0.5
_RSQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)  # the same float32 as JAX's f32 sqrt


def supports(d: int, h: int) -> bool:
    """JAX's `supports` shape rule, without its backend switch."""
    if d % 128 or h % 128:
        return False
    return 2 * d * h + (TR * h) * 4 * 2 + TR * d * 8 <= 13 * 1024 * 1024


def mlp_tiling(d: int, h: int, bwd: bool) -> dict | None:
    """K2's tiling of (d, h): the cluster size C (the fewest ranks whose
    h / C columns, a whole number U <= 3 of 128-column units, fit the
    registers), the 64-row tile, the unit, the ring depth S (as many 16 KB
    slots as shared memory leaves, at most 8) and the block's shared memory
    (csrc/int8_mlp.cu `smem_bytes`); None for a shape the kernels do not
    take."""
    if d <= 0 or h <= 0 or d % 128 or h % K2_UNIT or d // 128 > K2_MAX_KB:
        return None
    c = next((c for c in K2_CLUSTERS if (h // K2_UNIT) % c == 0
              and h // K2_UNIT // c <= K2_MAX_UNITS), None)
    if c is None:
        return None
    units = h // K2_UNIT // c
    areg = max((2 if bwd else 1) * K2_BM * d, 2 * K2_BM * K2_PLD * 4)
    fixed = 1024 + areg + units * K2_BM * 128 + K2_SMALL
    stages = min(K2_MAX_STAGES, (K2_SMEM - fixed) // K2_SLOT)
    if stages < 2:
        return None
    return {"C": c, "BM": K2_BM, "unit": K2_UNIT, "units": units, "S": stages,
            "smem": fixed + stages * K2_SLOT}


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 (float32, |err| < 1.5e-7), as JAX `_erf`."""
    a1, a2, a3, a4, a5 = _A
    ax = x.abs()
    t = 1.0 / (1.0 + _P * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = 1.0 - poly * torch.exp(-ax * ax)
    return torch.sign(x) * y


def gelu(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + _erf(h * _RSQRT2))


def dgelu(h: torch.Tensor) -> torch.Tensor:
    """d/dh [h Phi(h)] = Phi(h) + h phi(h)."""
    cdf = 0.5 * (1.0 + _erf(h * _RSQRT2))
    pdf = torch.exp(-0.5 * h * h) * _RSQRT2PI
    return cdf + h * pdf


def _hidden(x, w1q, s1, b1):
    xq, sx = row_quant_ref(x)
    return int_mm(xq, w1q) * sx * s1 + b1


def int8_mlp_fwd_ref(x, w1q, s1, b1, w2q, s2, b2) -> torch.Tensor:
    """K2f's plain version (JAX `_fwd_kernel` :112): x (n, d) -> (n, d) in
    x's dtype; biases float32."""
    g = gelu(_hidden(x, w1q, s1, b1))
    gq, sg = row_quant_ref(g)
    return (int_mm(gq, w2q) * sg * s2 + b2).to(x.dtype)


def int8_mlp_bwd_ref(x, w1q, s1, b1, w2q, s2, dy) -> torch.Tensor:
    """K2b's plain version (JAX `_bwd_kernel` :126): dx (n, d) in x's dtype."""
    dgh = dgelu(_hidden(x, w1q, s1, b1))
    dyq, sdy = row_quant_ref(dy, s2)
    dg = int_mm(dyq, w2q.t()) * sdy * dgh
    dg = dg * s1
    dgq, sdg = row_quant_ref(dg)
    return (int_mm(dgq, w1q.t()) * sdg).to(x.dtype)


def _split_hidden(g: torch.Tensor, splits: int):
    """The hidden's row quantisation as the cluster does it: each rank's
    row maxima over its h / C columns, combined by max; each rank's slice
    quantised with the row's scale. Returns ([int8 slice per rank], s)."""
    parts = g.chunk(splits, -1)
    amax = torch.stack([p.abs().amax(-1) for p in parts]).amax(0)
    s = _scale(amax)[:, None]
    return [torch.round(p / s).to(torch.int8) for p in parts], s


def _split_sum(qs, w: torch.Tensor) -> torch.Tensor:
    """sum over ranks, in rank order, of each rank's exact int32 partial
    q_r . w[rank's rows], as float32."""
    rows = w.shape[0] // len(qs)
    acc = None
    for r, q in enumerate(qs):
        part = q.long() @ w[r * rows:(r + 1) * rows].long()
        acc = part if acc is None else acc + part
    return acc.float()


def int8_mlp_fwd_split_ref(x, w1q, s1, b1, w2q, s2, b2, splits: int) -> torch.Tensor:
    """K2f's cluster split in plain PyTorch (for tests): the hidden of each
    of `splits` ranks, the row maxima combined over ranks, the partials of
    the second product added in rank order."""
    g = gelu(_hidden(x, w1q, s1, b1))
    qs, sg = _split_hidden(g, splits)
    return (_split_sum(qs, w2q) * sg * s2 + b2).to(x.dtype)


def int8_mlp_bwd_split_ref(x, w1q, s1, b1, w2q, s2, dy, splits: int) -> torch.Tensor:
    """K2b's cluster split in plain PyTorch (for tests), as
    `int8_mlp_fwd_split_ref`."""
    dgh = dgelu(_hidden(x, w1q, s1, b1))
    dyq, sdy = row_quant_ref(dy, s2)
    dg = int_mm(dyq, w2q.t()) * sdy * dgh
    dg = dg * s1
    qs, sg = _split_hidden(dg, splits)
    return (_split_sum(qs, w1q.t()) * sg).to(x.dtype)


def unfused(x, w1q, s1, b1, w2q, s2, b2) -> torch.Tensor:
    """The unfused composition (JAX `_ref` :196): int8_linear, exact GELU in
    the compute dtype, int8_linear."""
    return int8_linear(F.gelu(int8_linear(x, w1q, s1, b1)), w2q, s2, b2)


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _check(what: str, bwd: bool, x, w1q, s1, b1, w2q, s2, other) -> dict:
    """Raise on what the kernels do not take; return the tiling."""
    n, d = x.shape
    h = w1q.shape[1]
    for name, t in (("x", x), ("w1q", w1q), ("s1", s1), ("b1", b1), ("w2q", w2q),
                    ("s2", s2), ("other", other)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}; the kernel takes CUDA "
                             f"tensors on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if (x.dtype not in _DTYPES or other.dtype not in (x.dtype, torch.float32)
            or w1q.dtype != torch.int8 or w2q.dtype != torch.int8
            or w1q.shape != (d, h) or w2q.shape != (h, d)
            or any(t.dtype != torch.float32 for t in (s1, b1, s2))
            or s1.shape != (h,) or b1.shape != (h,) or s2.shape != (d,)):
        raise ValueError(f"{what}: x {tuple(x.shape)} {x.dtype}, w1q {tuple(w1q.shape)} "
                         f"{w1q.dtype}, w2q {tuple(w2q.shape)}: shapes or types the "
                         "kernel does not take")
    tiling = mlp_tiling(d, h, bwd)
    if not supports(d, h) or tiling is None:
        raise ValueError(f"{what}: d {d}, h {h}: the kernel takes d a multiple of 128 "
                         "up to 1024 and h = 128 C U with C in (1, 2, 4, 8), U <= 3")
    return tiling


def _transposes(what: str, w1q, w2q, wt):
    """`wt` checked against w1q and w2q."""
    if wt is None:
        raise ValueError(f"{what}: wt, the transposed weights "
                         "(`int8_linear.transposed`), is required on CUDA")
    d, h = w1q.shape
    if (wt[0].shape != (h, d) or wt[1].shape != (d, h)
            or any(t.dtype != torch.int8 or t.device != w1q.device or not t.is_contiguous()
                   or t.data_ptr() % 16 for t in wt)):
        raise ValueError("int8_mlp: wt must be (w1q^T, w2q^T), contiguous int8 on the "
                         "weights' device")
    return wt


_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


def _fwd_kernel(x, w1q, s1, b1, w2q, s2, b2, wt) -> torch.Tensor:
    """Launch K2f: y (n, d) in x's dtype. `wt`: (w1q^T, w2q^T) as
    `transposed` makes them."""
    tiling = _check("int8_mlp_fwd", False, x, w1q, s1, b1, w2q, s2, b2)
    if b2.dtype != torch.float32 or b2.shape != (x.shape[1],):
        raise ValueError("int8_mlp_fwd: b2 must be float32 (d,)")
    w1t, w2t = _transposes("int8_mlp_fwd", w1q, w2q, wt)
    n, d = x.shape
    y = torch.empty_like(x)
    fn = cuda_lib.load("int8_mlp", "int8_mlp_fwd", _ARGS[:2] + _ARGS[3:])
    rc = fn(x.data_ptr(), _DTYPES[x.dtype], w1t.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2t.data_ptr(), s2.data_ptr(), b2.data_ptr(), y.data_ptr(), n, d,
            w1q.shape[1], tiling["C"], tiling["S"],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "int8_mlp_fwd")
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    return y


def _bwd_kernel(x, w1q, s1, b1, w2q, s2, dy, wt) -> torch.Tensor:
    """Launch K2b: dx (n, d) in x's dtype. `wt` as in `_fwd_kernel` (K2b
    reads w1q^T)."""
    tiling = _check("int8_mlp_bwd", True, x, w1q, s1, b1, w2q, s2, dy)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"int8_mlp_bwd: dy {tuple(dy.shape)} {dy.dtype} vs x "
                         f"{tuple(x.shape)} {x.dtype}")
    w1t, _ = _transposes("int8_mlp_bwd", w1q, w2q, wt)
    n, d = x.shape
    dx = torch.empty_like(x)
    fn = cuda_lib.load("int8_mlp", "int8_mlp_bwd", _ARGS)
    rc = fn(x.data_ptr(), _DTYPES[x.dtype], w1q.data_ptr(), w1t.data_ptr(), s1.data_ptr(),
            b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, d,
            w1q.shape[1], tiling["C"], tiling["S"],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "int8_mlp_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dx


def int8_mlp_fwd(x, w1q, s1, b1, w2q, s2, b2, wt=None) -> torch.Tensor:
    """K2f on a CUDA tensor (`wt` required), its plain version on the CPU
    (`wt` unused)."""
    if x.device.type == "cpu":
        return int8_mlp_fwd_ref(x, w1q, s1, b1, w2q, s2, b2)
    return _fwd_kernel(x, w1q, s1, b1, w2q, s2, b2, wt)


def int8_mlp_bwd(x, w1q, s1, b1, w2q, s2, dy, wt=None) -> torch.Tensor:
    """K2b, as `int8_mlp_fwd`."""
    if x.device.type == "cpu":
        return int8_mlp_bwd_ref(x, w1q, s1, b1, w2q, s2, dy)
    return _bwd_kernel(x, w1q, s1, b1, w2q, s2, dy, wt)


class Int8MLP(torch.autograd.Function):
    """JAX's custom VJP (:270-292): x is the one residual; dx only. `wt`,
    the transposed weights (None on the CPU), rides along untracked."""

    @staticmethod
    def forward(ctx, x2, w1q, s1, b1, w2q, s2, b2, wt):
        ctx.save_for_backward(x2, w1q, s1, b1, w2q, s2)
        ctx.wt = wt
        return int8_mlp_fwd(x2, w1q, s1, b1, w2q, s2, b2, wt)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        x2, w1q, s1, b1, w2q, s2 = ctx.saved_tensors
        return (int8_mlp_bwd(x2, w1q, s1, b1, w2q, s2, dy.contiguous(), ctx.wt),) + (None,) * 7


def int8_mlp(x: torch.Tensor, w1q, s1, b1, w2q, s2, b2, wt=None) -> torch.Tensor:
    """fc2(gelu(fc1(x))) on the fused int8 path; x (..., d), biases of any
    float dtype (used in float32, as JAX casts them). `wt`: (w1q^T, w2q^T)
    as `transposed` keeps them, required on CUDA, unused on the CPU."""
    for name, b in (("fc1", b1), ("fc2", b2)):
        if b.requires_grad:
            raise ValueError(f"int8_mlp: the {name} bias requires grad; the fused int8 "
                             "MLP returns no bias gradient (freeze it with the weights)")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    args = (w1q, s1, b1.float(), w2q, s2, b2.float())
    if torch.is_grad_enabled() and x.requires_grad:
        y = Int8MLP.apply(x2, *args, wt)
    else:
        y = int8_mlp_fwd(x2, *args, wt)
    return y.reshape(shape)
