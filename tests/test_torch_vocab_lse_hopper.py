"""K4's Hopper backward on the CPU (`csrc/vocab_lse.cu`): dx and dw compute
z once per (row tile, V tile) on wgmma, with exp2 and log2 e folded in,
rows >= N and columns >= V masked by index and dz rounded to bf16 as the
register operand of the second product. At K <= 256 dx splits each 128-row
tile's V sweep over a cluster of C blocks whose f32 partials are added in
rank order, and dw builds dW as the transpose of dz^T . X with db from the
f32 dz; above K 256 the K-wide accumulator is split over a cluster of C =
K / 128 ranks: each rank's partial S over its K-slice, the C partials added
in rank order, dX and dW^T by slices, db once. Here: a torch model of that
arithmetic order (`split_ref`) at ragged shapes (N 700, V 5000; K 128 to
1024) against JAX's `_bwd_pallas` interpreted and against `lse_bwd_plain`;
the model without one rank's partial, which must fail; the tiling rules
(`dx_tiling`, `dw_tiling`) at every K the wrapper admits against the
card's limits and the source's constants; the backward's gradients of a
frozen head or input (None, the others unchanged); and, on the card, the
kernels against their plain versions.

Tolerances, those of `test_torch_vocab_lse.py`: dx and dW 1e-2 x max |ref|
(bf16 dz and bf16 outputs after float32 sums in another order), db 1e-5 x
max |ref| (float32 sums)."""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from agacs_tpu.ops import vocab_lse as jvl
from agacs_tpu_torch.ops import cuda_lib, vocab_lse

torch.set_num_threads(1)

N, V = 700, 5000
RTOL = {"dx": 1e-2, "dw": 1e-2, "db": 1e-5}
SMS = 132  # the H100's SMs
PORTABLE_CLUSTER = 8
SMEM = 232448  # shared memory a block can have on sm_90 (227 KB)
LOG2E = 1.4426950408889634
SOURCE = (cuda_lib.CSRC / "vocab_lse.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def dx_ranges(v: int, c: int) -> list[tuple[int, int]]:
    """The V tiles [t0, t1) that each of the C ranks of a dx cluster sweeps:
    [r n / C, (r + 1) n / C) of the n 64-column tiles."""
    n_vt = -(-v // vocab_lse.VT)
    return [(r * n_vt // c, (r + 1) * n_vt // c) for r in range(c)]


def _split_dz(x, w, b, lse, g, s=None):
    """The wgmma kernels' f32 dz over tiles padded by index: rows to a
    multiple of 128 (lse log2 e +inf and g 0 there), columns to a multiple
    of 64 (bias -inf there, W zero), with exp2 and log2 e folded in; S the
    padded x . W, or `s`. Returns (dz (Np, Vp) f32, x and W padded,
    float32)."""
    n, k = x.shape
    v = w.shape[1]
    np_, vp = -(-n // vocab_lse.DX_BM) * vocab_lse.DX_BM, -(-v // vocab_lse.VT) * vocab_lse.VT
    xf = torch.zeros(np_, k)
    xf[:n] = x.float()
    wf = torch.zeros(k, vp)
    wf[:, :v] = w.float()
    bias = torch.full((vp,), float("-inf"))
    bias[:v] = b.float()
    l2 = torch.full((np_,), float("inf"))
    l2[:n] = lse.float() * LOG2E
    gp = torch.zeros(np_)
    gp[:n] = g.float()
    s = xf @ wf if s is None else s
    dz = torch.exp2((s + bias) * LOG2E - l2[:, None]) * gp[:, None]
    return dz, xf, wf


def dx_partials(x, w, b, lse, g, c: int) -> list[torch.Tensor]:
    """Each rank's f32 partial dX (Np, K) of the wgmma dx kernel on a
    cluster of C: bf16(dz) . W^T over the rank's V tiles (`dx_ranges`)."""
    dz, _, wf = _split_dz(x, w, b, lse, g)
    dzr = dz.to(w.dtype).float()
    vt = vocab_lse.VT
    return [dzr[:, t0 * vt:t1 * vt] @ wf[:, t0 * vt:t1 * vt].t()
            for t0, t1 in dx_ranges(w.shape[1], c)]


def k_slices(k: int, c: int) -> list[slice]:
    """The K-slices [r k / C, (r + 1) k / C) of the C ranks of a split
    kernel (K / 128 ranks on the card; the model takes any C dividing K)."""
    assert k % c == 0, (k, c)
    return [slice(r * k // c, (r + 1) * k // c) for r in range(c)]


def s_partials(x, w, c: int) -> list[torch.Tensor]:
    """Each rank's f32 partial S (Np, Vp) of a split kernel: its K-slice of
    the padded x times its K-slice of the padded W."""
    _, xf, wf = _split_dz(x, w, torch.zeros(w.shape[1]), torch.zeros(x.shape[0]),
                          torch.zeros(x.shape[0]))
    return [xf[:, ks] @ wf[ks] for ks in k_slices(x.shape[1], c)]


def split_ref(x, w, b, lse, g, c: int = 1, parts=None):
    """(dx, dW, db) in the kernels' arithmetic order: dz with exp2 and log2
    e folded in, rows >= N and columns >= V masked by index. At K <= 256 dx
    the C ranks' partials added in rank order, rounded to x's dtype, and dW
    the transpose of dz^T . X (bf16 dz), cast to w's dtype. Above K 256 the
    split kernels' order: S the C ranks' partials over their K-slices added
    in rank order (`parts`: other partials), dX and dW^T by K-slices of
    bf16(dz) . W_slice^T and bf16(dz)^T . X_slice. db, either way, the
    column sums of the f32 dz, taken once. The order of the float32 sums
    inside a product is the tensor cores', which no CPU product
    reproduces."""
    n, k = x.shape
    v = w.shape[1]
    if k > vocab_lse.HK_MAX:
        parts = s_partials(x, w, c) if parts is None else parts
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        dz, xf, wf = _split_dz(x, w, b, lse, g, s)
        dzr = dz.to(w.dtype).float()
        ks = k_slices(k, c)
        dx = torch.cat([dzr @ wf[sl].t() for sl in ks], 1)
        dwt = torch.cat([dzr.t() @ xf[:, sl] for sl in ks], 1)
        return dx[:n].to(x.dtype), dwt.t()[:, :v].to(w.dtype), dz.sum(0)[:v]
    parts = dx_partials(x, w, b, lse, g, c)
    dx = parts[0]
    for p in parts[1:]:
        dx = dx + p
    dz, xf, _ = _split_dz(x, w, b, lse, g)
    dwt = dz.to(w.dtype).float().t() @ xf
    return dx[:n].to(x.dtype), dwt.t()[:, :v].to(w.dtype), dz.sum(0)[:v]


def dx_smem(k: int) -> int:
    """The wgmma dx kernel's shared memory (the source's `dx_smem`)."""
    strips, bars = _constant("STAGES") * vocab_lse.VT * 4, (1 + 2 * _constant("STAGES")) * 8
    region = max(vocab_lse.DX_BM * k * 2 + _constant("STAGES") * k * 128,
                 vocab_lse.DX_BM * (k + _constant("PAD")) * 4)
    return 1024 + region + strips + bars


def dw_smem(k: int) -> int:
    """The wgmma dw kernel's (the source's `dw_smem`)."""
    strips, bars = _constant("STAGES") * vocab_lse.VT * 4, (1 + 2 * _constant("STAGES")) * 8
    return 1024 + 2 * k * 128 + _constant("STAGES") * _constant("DW_BN") * k * 2 + 2 * strips + bars


def split_smem() -> int:
    """The split kernels' shared memory, the same at every K (the source's
    `split_smem`): alignment slack, the resident slice (128 x KS bf16), the
    ring (STAGES slots of KS x 64 bf16), two slots of both
    warpgroups' receive room (RECV_QUADS quads of 32 float4: the most C
    ceil(32 / C) takes) and packed P (32 quads of 32 pairs of bf16 pairs),
    the strips (two tables), the block's row or column tables and the
    barriers."""
    ks, stages, recv = _constant("KS"), _constant("STAGES"), _constant("RECV_QUADS")
    assert recv == max(c * -(-32 // c) for c in range(3, 9))
    strips, bars = stages * vocab_lse.VT * 4, (1 + 2 * stages + 8) * 8
    return (1024 + 128 * ks * 2 + stages * ks * 128 + 4 * recv * 32 * 16 + 4 * 32 * 32 * 8
            + 2 * strips + 2 * 128 * 4 + bars)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max |ref|)."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()), float(np.abs(ref).max())


@pytest.fixture(scope="module", params=[128, 256, 384, 512, 768, 1024])
def case(request):
    """N 700 (ragged against the 128-row tile), V 5000 (against the 64- and
    128-column tiles) at K: torch inputs (bf16 x and W, f32 b, lse and g)
    and JAX's backward interpreted on the same values."""
    k = request.param
    rng = np.random.RandomState(k)
    x = jnp.asarray(rng.randn(N, k), jnp.bfloat16)
    w = jnp.asarray(rng.randn(k, V) * 3 / np.sqrt(k), jnp.bfloat16)
    b = jnp.asarray(rng.randn(V), jnp.float32)
    g = jnp.asarray(rng.randn(N), jnp.float32)
    lse = jvl._fwd_pallas(x, w, b, interpret=True)
    ref = jvl._bwd_pallas(x, w, b, lse, g, interpret=True)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(_np(a))).to(dtype)

    args = (t(x, torch.bfloat16), t(w, torch.bfloat16), t(b), t(lse), t(g))
    return k, args, ref


@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_split_model_matches_pallas(case, part):
    """The model at the cluster `dx_tiling` picks at N 700: C 8 at K <= 256
    (the V sweep's split), K / 128 above (the K split)."""
    k, args, ref = case
    i = ("dx", "dw", "db").index(part)
    c = vocab_lse.dx_tiling(N, k, V, SMS)["C"]
    assert c == (8 if k <= vocab_lse.HK_MAX else k // 128)
    out = split_ref(*args, c=c)[i]
    assert out.dtype == (torch.float32 if part == "db" else torch.bfloat16)
    err, top = _err(out, ref[i])
    assert err <= RTOL[part] * top, (part, err, top)


@pytest.mark.parametrize("c", [1, 2, 8])
@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_split_model_matches_plain(case, part, c):
    """The model at C 1, 2 and 8 (above K 256: 8 ranks of K / 8, beside the
    card's K / 128) against the plain backward."""
    _, args, _ = case
    i = ("dx", "dw", "db").index(part)
    err, top = _err(split_ref(*args, c=c)[i],
                    vocab_lse.lse_bwd_plain(*args)[i])
    assert err <= RTOL[part] * top, (part, c, err, top)


def test_split_model_needs_every_rank(case):
    """The ranks' partials summed without the last one miss dx's bound
    against JAX: every rank's share is needed (at K <= 256 the V split's
    partial dX on a cluster of 8; above, the K split's partial S on the
    card's K / 128 ranks)."""
    k, args, ref = case
    if k > vocab_lse.HK_MAX:
        c = vocab_lse.dx_tiling(N, k, V, SMS)["C"]
        parts = s_partials(args[0], args[1], c)
        assert all(p.abs().max() > 0 for p in parts)
        dx = split_ref(*args, c=c, parts=parts[:-1])[0]
    else:
        parts = dx_partials(*args, 8)
        assert all(p.abs().max() > 0 for p in parts)
        dx = parts[0]
        for p in parts[1:-1]:
            dx = dx + p
        dx = dx[:N].to(torch.bfloat16)
    err, top = _err(dx, ref[0])
    assert err > RTOL["dx"] * top, (err, top)


def test_tiling_constants_match_the_source():
    for name in ("HK_MAX", "DX_BM", "VT", "DW_BV", "MAX_C", "KS"):
        assert getattr(vocab_lse, name) == _constant(name), name
    for line in ("constexpr int STRIPS = STAGES * VT * 4;",
                 "constexpr int BARS = (1 + 2 * STAGES) * 8;",
                 "  return DX_BM * K * 2 + STAGES * K * 128 > DX_BM * (K + PAD) * 4",
                 "  return 1024 + dx_region(K) + STRIPS + BARS;",
                 "  return 2 * K * 128 + STAGES * DW_BN * K * 2;",
                 "  return 1024 + dw_region(K) + 2 * STRIPS + BARS;",
                 "static_assert(dx_smem(HK_MAX) <= 232448 && dw_smem(HK_MAX) <= 232448,",
                 "constexpr int SPLIT_STAGE = KS * 128;",
                 "constexpr int QBLK = 32 * 16;",
                 "constexpr int PBLK = 32 * 8;",
                 "constexpr int SPLIT_BARS = (1 + 2 * STAGES + 8) * 8;",
                 "  return 1024 + 128 * KS * 2 + STAGES * SPLIT_STAGE + 4 * RECV_QUADS * QBLK + 4 * 32 * PBLK +",
                 "         2 * STRIPS + 2 * 128 * 4 + SPLIT_BARS;",
                 "__device__ __forceinline__ int quad0(int r, int C) { return r * 32 / C; }",
                 "__device__ __forceinline__ int quad_owner(int q, int C) { return ((q + 1) * C - 1) / 32; }",
                 "__device__ __forceinline__ int quad_room(int C) { return (32 + C - 1) / C; }",
                 "static_assert(split_smem() <= 232448 && MAX_C * KS >= 1024 && 3 * KS > HK_MAX,",
                 "  if (K > HK_MAX ? C != K / KS",
                 "  const dim3 grid(C, (N + DX_BM - 1) / DX_BM);",
                 "  const int vt0 = rank * n_vt / C, nt = (rank + 1) * n_vt / C - vt0;",
                 "  const int b0 = blockIdx.y * BT, k0 = (grp * C + rank) * KSZ;",
                 "  constexpr int BT = 64 * NWG;            // rows (dx) or columns (dw) of the output tile",
                 "    return launch_hk(vocab_lse_split_kernel<true>, dim3(K / KS, Vp / DW_BV), K / KS,",
                 "  const dim3 grid(Vp / DW_BV);"):
        assert line in SOURCE, line
    assert "wmma" not in SOURCE.split("#include")[1], "a wmma kernel is left in the source"


def _k_split(k: int, c: int, ks: int) -> None:
    """Above K 256: C ranks of KS columns, a portable cluster, the K-slices
    [r KS, (r + 1) KS) covering K once, the kernels' shared memory within
    227 KB, and the exchange's quads: rank r owns [r 32 / C, (r + 1) 32 /
    C) of a warpgroup's 32 (the source's `quad_owner` maps each quad to
    it), within the three passes of a warp and the room every rank's
    partials of them take."""
    assert ks == vocab_lse.KS == 128 and c * ks == k and 3 <= c <= PORTABLE_CLUSTER
    cols = [j for r in range(c) for j in range(r * ks, (r + 1) * ks)]
    assert cols == list(range(k))
    assert split_smem() <= SMEM
    owned = [list(range(r * 32 // c, (r + 1) * 32 // c)) for r in range(c)]
    assert [q for qs in owned for q in qs] == list(range(32))
    assert all(((q + 1) * c - 1) // 32 == r for r, qs in enumerate(owned) for q in qs)
    assert max(map(len, owned)) <= min(4 * 3, -(-32 // c))
    assert c * -(-32 // c) <= _constant("RECV_QUADS")


@pytest.mark.parametrize("n", [60, 700, 7488])
@pytest.mark.parametrize("k", range(128, 1025, 128))
def test_dx_tiling(k, n):
    """Shared memory within 227 KB and a grid that covers every row once: at
    K <= 256 a cluster of 1, 2, 4 or 8 (the portable sizes) no larger than
    the V tiles, (C, ceil(N / 128)) blocks whose ranks sweep every V tile
    exactly once; above, (K / 128, ceil(N / 128)) blocks, every rank
    sweeping every V tile for its K-slice of the row tile."""
    v = 51865
    t = vocab_lse.dx_tiling(n, k, v, SMS)
    gy = -(-n // vocab_lse.DX_BM)
    rows = [r for y in range(gy) for r in range(y * vocab_lse.DX_BM, (y + 1) * vocab_lse.DX_BM)
            if r < n]
    assert rows == list(range(n))
    if k > vocab_lse.HK_MAX:
        assert t == {"route": "split", "C": k // 128, "KS": 128}
        _k_split(k, t["C"], t["KS"])
        return
    assert t["route"] == "wgmma" and dx_smem(k) <= SMEM
    c = t["C"]
    assert c == {60: 8, 700: 8, 7488: 2}[n]
    assert c in (1, 2, 4, 8) and c <= PORTABLE_CLUSTER
    assert c * gy <= SMS or c == 1
    ranges = dx_ranges(v, c)
    tiles = [i for t0, t1 in ranges for i in range(t0, t1)]
    assert tiles == list(range(-(-v // vocab_lse.VT)))
    assert all(t1 > t0 for t0, t1 in ranges)


@pytest.mark.parametrize("n", [60, 700, 7488])
@pytest.mark.parametrize("k", range(128, 1025, 128))
def test_dw_tiling(k, n):
    """Shared memory within 227 KB, a grid of Vp / BV blocks (above K 256
    each a cluster of K / 128, one rank per K-slice of dW's rows) that
    covers every V column once, and each block's sweep of 64-row x tiles
    every row once."""
    v = 51865
    t = vocab_lse.dw_tiling(k)
    vp = -(-v // t["BV"]) * t["BV"]
    assert v <= vp < v + t["BV"] and t["BV"] == vocab_lse.DW_BV
    bn = _constant("DW_BN")
    rows = [r for r0 in range(0, -(-n // bn) * bn, bn) for r in range(r0, r0 + bn) if r < n]
    assert rows == list(range(n))
    if k > vocab_lse.HK_MAX:
        assert t == {"route": "split", "BV": vocab_lse.DW_BV, "C": k // 128, "KS": 128}
        _k_split(k, t["C"], t["KS"])
        return
    assert t == {"route": "wgmma", "BV": vocab_lse.DW_BV} and dw_smem(k) <= SMEM


def test_conformer_shape_tiling():
    """The conformer's CTC head at 16 x 15 s: dx's 59 row tiles on clusters
    of 2 (118 blocks of 132 SMs), 406 dw blocks of 128 columns, 4-slot
    rings."""
    assert vocab_lse.dx_tiling(7488, 256, 51865, SMS) == {"route": "wgmma", "C": 2}
    assert -(-51865 // vocab_lse.dw_tiling(256)["BV"]) == 406
    assert _constant("STAGES") == 4


def test_whisper_ctc_shape_tiling():
    """The whisper CTC head at 16 x 15 s, (12000, 768) x (768, 51865): dx's
    94 row tiles and dw's 406 column blocks, each on a cluster of 6."""
    assert vocab_lse.dx_tiling(12000, 768, 51865, SMS) == {"route": "split", "C": 6, "KS": 128}
    assert vocab_lse.dw_tiling(768) == {"route": "split", "BV": 128, "C": 6, "KS": 128}
    assert -(-12000 // vocab_lse.DX_BM) == 94 and -(-51865 // vocab_lse.DW_BV) == 406


@pytest.mark.parametrize("frozen", ["head", "input"])
def test_backward_skips_frozen_gradients(frozen):
    """A frozen head (w and b need no gradient) gets None for both and x the
    plain backward's dx; a frozen input gets None and w, b theirs."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(40, 128).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(128, 300) * 0.3).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(300).astype(np.float32))
    g = torch.from_numpy(rng.randn(40).astype(np.float32))
    for t, want in ((x, frozen == "input"), (w, frozen == "head"), (b, frozen == "head")):
        t.requires_grad_(not want)
    lse = vocab_lse.streaming_lse(x, w, b)
    grads = lse.grad_fn.apply(g)
    ref = vocab_lse.lse_bwd_plain(x.detach(), w.detach(), b.detach(), lse.detach(), g)
    lse.backward(g)
    for got, t, r in zip(grads, (x, w, b), ref):
        if t.requires_grad:
            assert torch.equal(got, r) and torch.equal(t.grad, r)
        else:
            assert got is None and t.grad is None


@pytest.mark.parametrize("name", sorted(chip_smoke.K4_ABLATIONS))
def test_k4_ablations_match_the_source(name):
    """Every edit of `chip_smoke.py --k4-ablate` is in the split kernels'
    source, applied in order as the run applies them."""
    text = SOURCE
    for old, new in chip_smoke.K4_ABLATIONS[name]:
        assert old in text, (name, old)
        text = text.replace(old, new, 1)


@pytest.mark.cuda
def test_hopper_backward_matches_plain_on_card():
    """K4's forward, dx and dw against their plain versions on the card, at
    chip_smoke.py's shapes and bounds (K 128 to 1024)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chip_smoke.check_k4(torch.device("cuda"), torch.Generator().manual_seed(0), timed=False)
