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
has no dense-logits fallback. K4 takes bf16 x and w, float32 b, and any K,
as JAX's does. The kernels take K a multiple of their route's granule
(`padded_k`: 128 up to K 1280, 256 above, 256 C G above 4096), so the
wrapper pads a K that is not (the transducer joint's 320 goes to 384, K
1400 to 1536, K 4224 to 4608): zero columns of x and zero rows of w, which
add nothing to any product, so lse is exact; dx's padded columns and dW's
padded rows are dropped. The padding is work the kernels do for nothing
(20% at K 320, 9% at K 4224). A w whose V is not a multiple
of 8 (the Whisper vocabulary's 51865) is handed over with its rows padded
too, for the kernels' 16-byte row stride. Both copies (`_pad_x`,
`_rows8`) are made once a step: the forward saves them for both backward
passes.

The forward is one launch of a wgmma kernel fed by TMA at every K: x's
rows resident (at K <= 256 in registers, as the product's A operand), W
streamed through a 4-slot ring (whole K x 64 tiles at K <= 256, 64 x 64
chunks above), S on the tensor cores and an online (max, sum) per row in
registers; `fwd_tiling` picks the block's rows (128, or 64 where x's 128
rows do not fit shared memory beside the ring) and splits each row tile's
V sweep over a cluster of C blocks whose (max, sum) pairs are merged in
rank order. Above K 1536 x's 64 rows no longer fit beside the ring, and
x's 64 x 64 chunks stream through it beside W's (route "stream"). It
replaced a wmma kernel and a combine pass (3.0451 ms at the conformer's
training shape, (7488, 256) x (256, 51865), on an H100, against a bound
of 0.2011 ms).

The backward dispatches by K, never by a failure. At K <= 256 (the
conformer's 256, the tests' 128) dx and dw are wgmma kernels fed by TMA
that compute z once per (row tile, V tile) and keep dz in registers as the
A operand of the second product; they replaced wmma kernels that rebuilt z
once for every 128 output columns (at the conformer's training shape 9.54
and 9.12 ms on an H100 against a bound of 0.40 ms each). `dx_tiling`
splits each 128-row tile's V sweep over a cluster of C blocks whose f32
partials are summed in rank order; `dw_tiling` gives each block 128
vocabulary columns; the ring depth, 4 slots, is fixed in the source.
Above K 256 (the whisper family's CTC head: K 384 to 1280) one output tile
(dx: 128 rows; dw: 128 vocabulary columns) is split over a cluster of C =
K / 128 blocks (above K 1024, C 9 or 10, a non-portable cluster that the
C entries launch only where `cudaOccupancyMaxActiveClusters` says the card
holds one), rank r owning the K-slice [128 r, 128 (r + 1)) of the
accumulator and of the resident operand: each rank computes its partial S
over its slice, the ranks add their partials in rank order through
distributed shared memory, and each then adds P (or dz^T) times its slice
into its share of dX (or dW^T). That replaced wmma kernels that rebuilt z
K / 128 times a pass (147 and 162 ms at (12000, 768) x (768, 51865) on an
H100, against a bound of 1.93 ms each). Above K 1280 a rank owns a
256-wide slice of a 64-row (dx) or 64-column (dw) output tile, on clusters
of C = K / 256 (6 at K 1536, 8 at 2048; 9 to 16 non-portable); above K
4096 a grid axis runs over G groups of C slices, each group's cluster
recomputing S over the whole K (`split_groups`).

The backward computes only the gradients autograd asks for: dx when x
needs one, dW and db when w or b does (a frozen CTC head pays no dw pass).
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib

FWD_LAUNCHES = 0  # K4 launches since the last reset (chip_smoke.py reads them)
DX_LAUNCHES = 0
DW_LAUNCHES = 0

# The wgmma kernels' tiling constants (csrc/vocab_lse.cu; the tests read
# them back from the source).
HK_MAX = 256      # the widest K of the wgmma backward and of whole W tiles in the forward
DX_BM = 128       # dx: rows a block owns
VT = 64           # columns of a streamed W tile
DW_BV = 128       # dw: vocabulary columns a block owns
MAX_C = 8         # dx, forward: blocks of a cluster (the portable size)
STAGES = 4        # ring slots
FWD_KC = 64       # forward: W rows of a ring slot above HK_MAX (64 x 64 chunks)
SMEM_MAX = 232448  # a block's shared memory on sm_90 (227 KB)
KS = 128          # above HK_MAX: the K-slice of a cluster rank in dx and dw
SPLIT128_K = 1280  # the widest K of KS slices (whisper-large's d; clusters of 9 and 10 above 1024)
KS2 = 256         # above SPLIT128_K: the K-slice of a rank, on 64-row or 64-column tiles
MAX_CW = 16       # the widest cluster (non-portable): K 4096 in KS2 slices
GROUP_K = MAX_CW * KS2  # above it, a grid axis over groups of C slices
FWD_XK = 1536     # forward: the widest K with x's rows resident (64 a block)


def _cluster(tiles: int, v: int, sms: int) -> int:
    """The blocks C of a cluster that splits each of `tiles` row tiles' V
    sweep: the largest of 1, 2, 4, 8 with C x tiles no more than the SMs
    and C no more than V's 64-column tiles."""
    n_vt, c = -(-v // VT), 1
    while 2 * c <= MAX_C and 2 * c <= n_vt and 2 * c * tiles <= sms:
        c *= 2
    return c


def fwd_smem(k: int, bm: int) -> int:
    """The forward's shared memory at K and BM rows a block (the source's
    `fwd_smem`): alignment slack, x (BM x K bf16), the ring (STAGES slots
    of K or FWD_KC W rows x 64 bf16), the bias strips and the barriers;
    above FWD_XK (`fwd_stream_smem`) no resident x, and a slot holds a 64 x
    64 W chunk and a BM x 64 x chunk."""
    if k > FWD_XK:
        return 1024 + STAGES * (FWD_KC + bm) * 128 + STAGES * VT * 4 + (1 + 2 * STAGES) * 8
    kc = k if k <= HK_MAX else FWD_KC
    return 1024 + bm * k * 2 + STAGES * kc * 128 + STAGES * VT * 4 + (1 + 2 * STAGES) * 8


def fwd_tiling(n: int, k: int, v: int, sms: int) -> dict:
    """K4's forward: its route ("tiles": whole K x 64 W tiles and two S
    buffers at K <= 256; "chunks": 64 x 64 W chunks beside x's resident
    rows up to FWD_XK; "stream": x's 64 x 64 chunks beside W's above), the
    rows BM of a block (128, or 64 where x's 128 rows do not fit beside the
    ring, and on the stream route) and the cluster size C that splits each
    row tile's V sweep: the largest of 1, 2, 4, 8 with no more blocks than
    SMs and no more ranks than V's 64-column tiles (`_cluster`, dx's
    rule)."""
    bm = DX_BM if k <= FWD_XK and fwd_smem(k, DX_BM) <= SMEM_MAX else 64
    route = "tiles" if k <= HK_MAX else "chunks" if k <= FWD_XK else "stream"
    return {"route": route, "BM": bm, "C": _cluster(-(-n // bm), v, sms)}


def split_groups(k: int) -> tuple[int, int]:
    """(C, G) of the split backward above SPLIT128_K at a padded K: G =
    ceil(K / GROUP_K) groups of C = K / 256 / G ranks (the source's
    `split_groups`)."""
    n = -(-k // KS2)
    g = -(-n // MAX_CW)
    return -(-n // g), g


def dx_tiling(n: int, k: int, v: int, sms: int) -> dict:
    """K4 dx's route and cluster size C: at K <= 256 the wgmma kernel on
    (C, ceil(N / 128)) blocks in clusters of C, C the largest of 1, 2, 4, 8
    with no more blocks than SMs and no more ranks than V's 64-column tiles;
    above, the split kernel on (C, ceil(N / 128)) blocks, C = K / KS ranks
    each owning a KS-wide slice of dx's columns (C 9 and 10, above K
    1024, beyond the portable MAX_C). Above SPLIT128_K the split kernel on
    (C, ceil(N / 64), G) blocks: 64-row tiles, KS2 slices, C ranks (9 to 16
    non-portable) in each of G groups (`split_groups`)."""
    if k > SPLIT128_K:
        c, g = split_groups(k)
        return {"route": "split", "C": c, "KS": KS2, "G": g, "BM": 64}
    if k > HK_MAX:
        return {"route": "split", "C": k // KS, "KS": KS}
    return {"route": "wgmma", "C": _cluster(-(-n // DX_BM), v, sms)}


def dw_tiling(k: int) -> dict:
    """K4 dw's route and the vocabulary columns BV of a block, to which dW's
    columns are padded: 128, two warpgroups of 64. At K <= 256 the wgmma
    kernel, each warpgroup keeping its 64 x K dW^T in registers; above, the
    split kernel on clusters of C = K / KS ranks, each owning a KS-wide
    slice of dW's rows (C 9 and 10 above K 1024, as dx's). Above
    SPLIT128_K blocks of 64 columns, KS2 slices, C and G as dx's."""
    if k > SPLIT128_K:
        c, g = split_groups(k)
        return {"route": "split", "BV": 64, "C": c, "KS": KS2, "G": g}
    if k > HK_MAX:
        return {"route": "split", "BV": DW_BV, "C": k // KS, "KS": KS}
    return {"route": "wgmma", "BV": DW_BV}


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


KP = 128  # the kernels' K granule up to SPLIT128_K: the wrapper pads K up to a multiple of it


def padded_k(k: int) -> int:
    """K as the kernels take it: up to the next multiple of KP up to
    SPLIT128_K, of KS2 above it, and of KS2 C G above GROUP_K (every group
    of C ranks whole)."""
    if k <= SPLIT128_K:
        return -(-k // KP) * KP
    c, g = split_groups(k)
    return KS2 * c * g


def _check(x, w, b) -> None:
    n, k = x.shape
    if w.shape[0] != k or b.shape != (w.shape[1],):
        raise ValueError(f"vocab_lse: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if k <= 0:
        raise ValueError(f"vocab_lse: K {k}; K4 takes K >= 1")
    if x.device.type != "cuda":
        raise ValueError(f"vocab_lse: K4 runs on a CUDA tensor, not on {x.device}")
    for name, t, want in (("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
                          ("b", b, torch.float32)):
        if t.dtype != want or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"vocab_lse: {name} is {t.dtype} on {t.device}; K4 takes a "
                             f"contiguous {want} on {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _rows8(w: torch.Tensor) -> torch.Tensor:
    """w as the kernels read it: its rows padded to a multiple of 8 columns
    (zeros), for 16-byte loads, and zero rows added up to `padded_k` rows.
    One copy when V % 8 or K % KP is not 0, else w itself."""
    k, v = w.shape
    pad_v, pad_k = -v % 8, padded_k(k) - k
    return w if not (pad_v or pad_k) else torch.nn.functional.pad(w, (0, pad_v, 0, pad_k))


def _pad_x(x: torch.Tensor) -> torch.Tensor:
    """x with zero columns up to `padded_k` columns: a copy when K % KP is
    not 0, else x itself."""
    pad_k = padded_k(x.shape[1]) - x.shape[1]
    return x if not pad_k else torch.nn.functional.pad(x, (0, pad_k))


def _padded(x, w, b, wp, xp):
    """Check x, w and b; (N, K padded, V, wp, xp) with the padded copies
    made where the caller has none."""
    _check(x, w, b)
    return (x.shape[0], padded_k(x.shape[1]), w.shape[1], _rows8(w) if wp is None else wp,
            _pad_x(x) if xp is None else xp)


def _launch_fwd(x, w, b, wp=None, xp=None) -> torch.Tensor:
    """K4's forward: lse (N,) float32. wp, xp as for `_launch_dx`."""
    n, k, v, wp, xp = _padded(x, w, b, wp, xp)
    tiling = fwd_tiling(n, k, v, _sms(x))
    lse = torch.empty(n, device=x.device)
    fn = cuda_lib.load("vocab_lse", "vocab_lse_fwd",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(xp.data_ptr(), wp.data_ptr(), wp.shape[1], b.data_ptr(), lse.data_ptr(), n, k, v,
            tiling["BM"], tiling["C"], _stream(x))
    cuda_lib.check(rc, "vocab_lse_fwd")
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    return lse


def _launch_dx(x, w, b, lse, g, wp=None, xp=None) -> torch.Tensor:
    """K4's dx pass: (N, K) in x's dtype (the padded columns dropped). wp:
    w padded (`_rows8`), xp: x padded (`_pad_x`), when the caller has them."""
    n, k, v, wp, xp = _padded(x, w, b, wp, xp)
    dx = torch.empty_like(xp)
    fn = cuda_lib.load("vocab_lse", "vocab_lse_dx",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(xp.data_ptr(), wp.data_ptr(), wp.shape[1], b.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dx.data_ptr(), n, k, v, dx_tiling(n, k, v, _sms(x))["C"], _stream(x))
    cuda_lib.check(rc, "vocab_lse_dx")
    global DX_LAUNCHES
    DX_LAUNCHES += 1
    return dx[:, :x.shape[1]]


def _launch_dw(x, w, b, lse, g, wp=None, xp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's dw pass: dW (K, V) accumulated in float32, cast to w's dtype (the
    padded rows dropped), and db (V,) float32. wp, xp as for `_launch_dx`."""
    n, k, v, wp, xp = _padded(x, w, b, wp, xp)
    bv = dw_tiling(k)["BV"]
    vp = -(-v // bv) * bv
    dw = torch.empty(k, vp, device=x.device)
    db = torch.empty(vp, device=x.device)
    fn = cuda_lib.load("vocab_lse", "vocab_lse_dw",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(xp.data_ptr(), wp.data_ptr(), wp.shape[1], b.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dw.data_ptr(), db.data_ptr(), n, k, v, vp, _stream(x))
    cuda_lib.check(rc, "vocab_lse_dw")
    global DW_LAUNCHES
    DW_LAUNCHES += 1
    return dw[:w.shape[0], :v].to(w.dtype), db[:v]


class _StreamingLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        if x.device.type == "cpu":
            lse, wp, xp = lse_plain(x, w, b), w, x
        else:
            # the padded copies, made once a step for the forward and both backward passes
            wp, xp = _rows8(w), _pad_x(x)
            lse = _launch_fwd(x, w, b, wp, xp)
        ctx.save_for_backward(x, w, b, lse, wp, xp)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, w, b, lse, wp, xp = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad
        dx = dw = db = None
        if x.device.type == "cpu":
            if want_x or want_w or want_b:
                dx, dw, db = lse_bwd_plain(x, w, b, lse, g)
        else:
            g = g.float().contiguous()
            if want_x:
                dx = _launch_dx(x, w, b, lse, g, wp, xp)
            if want_w or want_b:
                dw, db = _launch_dw(x, w, b, lse, g, wp, xp)
        return (dx if want_x else None, dw if want_w else None, db if want_b else None)


def streaming_lse(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise logsumexp(x . w + b): x (N, K), w (K, V), b (V,) -> (N,)
    float32; differentiable in x, w and b."""
    return _StreamingLSE.apply(x, w, b)
