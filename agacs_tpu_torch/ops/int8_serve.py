"""Weight-only int8 (W8A16) matmul for thin-row serving shapes, and the
serving quantisation of a whisper model (counterpart of
`agacs_tpu/ops/int8_serve.py`; kernel K6, `csrc/w8a16.cu`).

    y = x · bf16(f32(w_q) · w_s)      x: (r, K), w_q: (K, N) int8, w_s: (N,) f32

The weight stays int8 in device memory and is dequantised on chip, one
scale per output column, and rounded to x's dtype BEFORE the dot; the
activations are not quantised. The sums are float32 and the output is
cast to x's dtype. Folding w_s in after the sum is a different result.

`int8_linear` (`ops/int8_linear.py`) and `models.whisper.fused_linears`
take K6 for a 2-D weight when `thin_rows(x)` and `fits(w_q)` hold, as
JAX's `int8_linear` (:133-150) does; the decode step's logits head runs
`w8a16_matmul` over `logits_w_q` whenever a model carries one
(`quantize_for_serving`), whatever `AGACS_W8A16` says.

`AGACS_W8A16` (read at call time, as in JAX :40-57): unset, "0", "false"
or "" is off; "interpret" is on for every tensor (a CPU tensor then takes
K6's plain version, as JAX interprets its Pallas kernel); any other value
is on for a CUDA tensor only (JAX: on its TPU backend only), so a CPU
tensor takes K8's plain version.

On a CUDA tensor `w8a16_matmul` launches K6 (bf16 x only; one launch, its
split over K summed inside it, `thin_tiling`) or raises; on a CPU tensor
it takes `w8a16_matmul_ref`. The backward is dx only,
(g·w_s) @ w_q^T in x's dtype, a plain product as in JAX's VJP (:114-124).
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from agacs_tpu_torch.ops import cuda_lib

MAX_ROWS = 32  # above this K8's row quantisation amortizes (JAX :37)
_NT = 512      # JAX's VMEM column tile: `fits` keeps its shape rule
# The thin-row kernels' tiling (csrc/thin_rows.cuh): a block takes 32 or
# 128 output columns and up to THIN_MR rows; K is split over at most
# MAX_SPLITS blocks of a cluster, in whole ring stages of K6_KR (K6) or
# K8_KR (K8g's thin form) weight rows, until the launch reaches MIN_BLOCKS
# blocks (two for each of the H100's 132 SMs).
WIDE, NARROW = 128, 32
THIN_MR = 64
K6_KR, K8_KR = 64, 128
MAX_SPLITS = 8
MIN_BLOCKS = 2 * 132
LAUNCHES = 0  # K6 launches since the last reset (chip_smoke.py reads it)


def use_w8a16(x: torch.Tensor) -> bool:
    env = os.environ.get("AGACS_W8A16", "0")
    if env in ("0", "false", ""):
        return False
    return env == "interpret" or x.device.type == "cuda"


def thin_rows(x: torch.Tensor) -> bool:
    rows = math.prod(x.shape[:-1]) if x.dim() > 1 else 1
    return rows <= MAX_ROWS and use_w8a16(x)


def fits(w_q: torch.Tensor) -> bool:
    """JAX's rule: N a multiple of 512, or the whole int8 weight <= 8 Mi."""
    return w_q.shape[-1] % _NT == 0 or w_q.numel() <= 8 * 1024 * 1024


def dequant_bf(w_q: torch.Tensor, w_s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """bf16(f32(w_q) · w_s) per column, in `dtype` (JAX `_kernel` :65)."""
    return (w_q.float() * w_s.float()).to(dtype)


def w8a16_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """K6's plain version on a 2-D x: the weight dequantised and rounded to
    x's dtype, the exact products summed in float32, cast to x's dtype."""
    return (x.float() @ dequant_bf(w_q, w_s, x.dtype).float()).to(x.dtype)


def thin_tiling(m: int, n: int, k: int, kr: int) -> tuple[int, int]:
    """(BN, S) of a thin-row launch, from the shapes alone (so every decode
    step launches one grid): BN = 128 when those column tiles alone reach
    MIN_BLOCKS, else 32; S = 1 when the tiles reach MIN_BLOCKS, else K's
    `kr`-row stages split into at most MAX_SPLITS ranges of whole stages,
    as few stages a range as reach MIN_BLOCKS (none empty)."""
    z = -(-m // THIN_MR)
    if -(-n // WIDE) * z >= MIN_BLOCKS:
        return WIDE, 1
    tiles = -(-n // NARROW) * z
    if tiles >= MIN_BLOCKS:
        return NARROW, 1
    stages = -(-k // kr)
    per = max(1, -(-stages // MAX_SPLITS), stages // -(-MIN_BLOCKS // tiles))
    return NARROW, -(-stages // per)


def split_ranges(k: int, kr: int, splits: int) -> list[tuple[int, int]]:
    """The k rows [start, stop) of each block of a split, in rank order:
    ceil(stages / S) stages of `kr` rows each, the last cut at K (the
    kernels' `per`)."""
    stages = -(-k // kr)
    per = -(-stages // splits) * kr
    return [(min(k, r * per), min(k, (r + 1) * per)) for r in range(splits)]


def w8a16_split_ref(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                    splits: int) -> torch.Tensor:
    """K6's split over K in plain PyTorch (for tests): each block's float32
    partial over its `split_ranges` rows of the dequantised bf16 weight,
    the partials added in rank order, cast to x's dtype once."""
    wt = dequant_bf(w_q, w_s, x.dtype).float()
    y = None
    for k0, k1 in split_ranges(x.shape[-1], K6_KR, splits):
        part = x[:, k0:k1].float() @ wt[k0:k1]
        y = part if y is None else y + part
    return y.to(x.dtype)


def _launch(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """Launch K6 on a CUDA x (r, K) bf16."""
    m, k = x.shape
    n = w_q.shape[1]
    for name, t, dt in (("x", x, torch.bfloat16), ("w_q", w_q, torch.int8),
                        ("w_s", w_s, torch.float32)):
        if t.device != x.device or t.dtype != dt:
            raise ValueError(f"w8a16_matmul: {name} is {t.dtype} on {t.device}; the "
                             f"kernel takes {dt} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a16_matmul: {name} must be contiguous and 16-byte aligned")
    if w_q.dim() != 2 or w_q.shape[0] != k or w_s.shape != (n,):
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, "
                         f"w_s {tuple(w_s.shape)}")
    if k % 16 or n % 16:
        raise ValueError(f"w8a16_matmul: K {k} and N {n} must be multiples of 16")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    bn, splits = thin_tiling(m, n, k, K6_KR)
    fn = cuda_lib.load("w8a16", "w8a16_matmul",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(), m, n, k, bn,
            splits, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, "w8a16_matmul")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _matmul(x2: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    if x2.device.type == "cpu":
        return w8a16_matmul_ref(x2, w_q, w_s)
    if x2.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: unsupported device {x2.device}")
    return _launch(x2.contiguous(), w_q, w_s)


class W8A16Matmul(torch.autograd.Function):
    """JAX's custom VJP (:110-124): dx = (g·w_s) @ w_q^T in x's dtype; no
    gradient for the int8 weight or its scale."""

    @staticmethod
    def forward(ctx, x2, w_q, w_s):
        ctx.save_for_backward(w_q, w_s)
        return _matmul(x2, w_q, w_s)

    @staticmethod
    def backward(ctx, g):
        w_q, w_s = ctx.saved_tensors
        gf = (g.float() * w_s).to(g.dtype)
        return gf @ w_q.to(g.dtype).t(), None, None


def w8a16_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ (w_q · w_s) with int8 weight reads and x-dtype math."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and x.requires_grad:
        y = W8A16Matmul.apply(x2, w_q, w_s)
    else:
        y = _matmul(x2, w_q, w_s)
    return y.reshape(*x.shape[:-1], w_q.shape[1])


def quantize_for_serving(model, pad_vocab_to: int = _NT):
    """JAX `quantize_for_serving` (:144-184) on a `models.whisper.Whisper`,
    IN PLACE: every Linear under a QUANT_LINEAR_KEYS name becomes an
    `Int8Linear` (`quantize_weight`'s scheme, from the weight as stored),
    adapters stay; the decoder gets `token_emb_q` (V, d) int8 and
    `token_emb_s` (V,) f32 (one scale per vocab row, max|row| / 127, round
    half to even, clipped to +-127) and the logits head `logits_w_q` =
    token_emb_q^T (d, Vp) and `logits_w_s` (Vp,), both zero-padded to a
    multiple of `pad_vocab_to` columns. `token_embedding` stays: the
    teacher-forced forward reads it, as JAX's does."""
    from agacs_tpu_torch.models.whisper import Int8Linear
    from agacs_tpu_torch.ops.int8_linear import _scale

    for parent, cname, _, lin in list(model._int8_sites()):
        setattr(parent, cname, Int8Linear.quantized(lin))
    dec = model.decoder
    emb = dec.token_embedding.weight.detach().float()
    s = _scale(emb.abs().amax(1))
    q = torch.clamp(torch.round(emb / s[:, None]), -127, 127).to(torch.int8)
    v = emb.shape[0]
    vp = -(-v // pad_vocab_to) * pad_vocab_to
    dec.set_int8_head(q, s, torch.nn.functional.pad(q.t(), (0, vp - v)).contiguous(),
                      torch.nn.functional.pad(s, (0, vp - v)))
    return model
