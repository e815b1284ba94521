"""K4's Hopper backward on the CPU (`csrc/vocab_lse.cu`, K <= 256): dx and
dw compute z once per (row tile, V tile) on wgmma, with exp2 and log2 e
folded in, rows >= N and columns >= V masked by index and dz rounded to
bf16 as the register operand of the second product; dx splits each
128-row tile's V sweep over a cluster of C blocks whose f32 partials are
added in rank order, and dw builds dW as the transpose of dz^T . X with db
from the f32 dz. Here: a torch model of that arithmetic order
(`split_ref`) at ragged shapes (N 700, V 5000; K 128, 256 and 768)
against JAX's `_bwd_pallas` interpreted and against `lse_bwd_plain`; the
model without one rank's partial, which must fail; the tiling rules
(`dx_tiling`, `dw_tiling`) at every K the wrapper admits against the
card's limits and the source's constants; and, on the card, the kernels
against their plain versions.

Tolerances, those of `test_torch_vocab_lse.py`: dx and dW 1e-2 x max |ref|
(bf16 dz and bf16 outputs after float32 sums in another order), db 1e-5 x
max |ref| (float32 sums)."""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

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


def _split_dz(x, w, b, lse, g):
    """The wgmma kernels' f32 dz over tiles padded by index: rows to a
    multiple of 128 (lse log2 e +inf and g 0 there), columns to a multiple
    of 64 (bias -inf there, W zero), with exp2 and log2 e folded in.
    Returns (dz (Np, Vp) f32, x and W padded, float32)."""
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
    dz = torch.exp2((xf @ wf + bias) * LOG2E - l2[:, None]) * gp[:, None]
    return dz, xf, wf


def dx_partials(x, w, b, lse, g, c: int) -> list[torch.Tensor]:
    """Each rank's f32 partial dX (Np, K) of the wgmma dx kernel on a
    cluster of C: bf16(dz) . W^T over the rank's V tiles (`dx_ranges`)."""
    dz, _, wf = _split_dz(x, w, b, lse, g)
    dzr = dz.to(w.dtype).float()
    vt = vocab_lse.VT
    return [dzr[:, t0 * vt:t1 * vt] @ wf[:, t0 * vt:t1 * vt].t()
            for t0, t1 in dx_ranges(w.shape[1], c)]


def split_ref(x, w, b, lse, g, c: int = 1):
    """(dx, dW, db) in the wgmma kernels' arithmetic order: dz with exp2 and
    log2 e folded in, rows >= N and columns >= V masked by index; dx the C
    ranks' partials added in rank order, rounded to x's dtype; dW the
    transpose of dz^T . X (bf16 dz), cast to w's dtype; db the column sums
    of the f32 dz. The order of the float32 sums inside a product is the
    tensor cores', which no CPU product reproduces."""
    n, v = x.shape[0], w.shape[1]
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


def wmma_smem(k: int, dx: bool) -> int:
    """The wmma kernels' (the source's `smem_bytes`)."""
    br, kc, ck = _constant("BR"), _constant("KC"), _constant("CK")
    zld, wld = _constant("BV") + 4, _constant("BV") + 8
    return br * (k + 8) * 2 + kc * wld * 2 + br * zld * 4 + br * wld * 2 + (ck * wld * 2 if dx else 0)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max |ref|)."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()), float(np.abs(ref).max())


@pytest.fixture(scope="module", params=[128, 256, 768])
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
    """The model at C 8, the cluster `dx_tiling` picks at N 700 and K <= 256."""
    _, args, ref = case
    i = ("dx", "dw", "db").index(part)
    assert vocab_lse.dx_tiling(N, 256, V, SMS)["C"] == 8
    out = split_ref(*args, c=8)[i]
    assert out.dtype == (torch.float32 if part == "db" else torch.bfloat16)
    err, top = _err(out, ref[i])
    assert err <= RTOL[part] * top, (part, err, top)


@pytest.mark.parametrize("c", [1, 2, 8])
@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_split_model_matches_plain(case, part, c):
    _, args, _ = case
    i = ("dx", "dw", "db").index(part)
    err, top = _err(split_ref(*args, c=c)[i],
                    vocab_lse.lse_bwd_plain(*args)[i])
    assert err <= RTOL[part] * top, (part, c, err, top)


def test_split_model_needs_every_rank(case):
    """The ranks' partials summed without the last one (C 8) miss dx's
    bound against JAX: every rank's share is needed."""
    _, args, ref = case
    parts = dx_partials(*args, 8)
    assert all(p.abs().max() > 0 for p in parts)
    dx = parts[0]
    for p in parts[1:-1]:
        dx = dx + p
    err, top = _err(dx[:N].to(torch.bfloat16), ref[0])
    assert err > RTOL["dx"] * top, (err, top)


def test_tiling_constants_match_the_source():
    for name in ("HK_MAX", "DX_BM", "VT", "DW_BV", "MAX_C"):
        assert getattr(vocab_lse, name) == _constant(name), name
    assert vocab_lse.BV == _constant("BV")  # the forward's and the wmma kernels' tile
    for line in ("constexpr int STRIPS = STAGES * VT * 4;",
                 "constexpr int BARS = (1 + 2 * STAGES) * 8;",
                 "  return DX_BM * K * 2 + STAGES * K * 128 > DX_BM * (K + PAD) * 4",
                 "  return 1024 + dx_region(K) + STRIPS + BARS;",
                 "  return 2 * K * 128 + STAGES * DW_BN * K * 2;",
                 "  return 1024 + dw_region(K) + 2 * STRIPS + BARS;",
                 "static_assert(dx_smem(HK_MAX) <= 232448 && dw_smem(HK_MAX) <= 232448,",
                 "constexpr int ZLD = BV + 4;", "constexpr int WLD = BV + 8;",
                 "  const dim3 grid(C, (N + DX_BM - 1) / DX_BM);",
                 "  const int vt0 = rank * n_vt / C, nt = (rank + 1) * n_vt / C - vt0;",
                 "  const dim3 grid(Vp / DW_BV);"):
        assert line in SOURCE, line


@pytest.mark.parametrize("n", [60, 700, 7488])
@pytest.mark.parametrize("k", range(128, 1025, 128))
def test_dx_tiling(k, n):
    """Shared memory within 227 KB, a cluster of 1, 2, 4 or 8 (the portable
    sizes) no larger than the V tiles, and a grid of (C, ceil(N / 128))
    that covers every row tile and, across each cluster's ranks, every V
    tile exactly once."""
    v = 51865
    t = vocab_lse.dx_tiling(n, k, v, SMS)
    if k > vocab_lse.HK_MAX:
        assert t == {"route": "wmma", "C": 1}
        assert wmma_smem(k, True) <= SMEM
        return
    assert t["route"] == "wgmma" and dx_smem(k) <= SMEM
    c, gy = t["C"], -(-n // vocab_lse.DX_BM)
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
    """Shared memory within 227 KB, a grid of Vp / BV blocks that covers
    every V column once, and each block's sweep of 64-row x tiles every row
    once."""
    v = 51865
    t = vocab_lse.dw_tiling(k)
    vp = -(-v // t["BV"]) * t["BV"]
    assert v <= vp < v + t["BV"]
    if k > vocab_lse.HK_MAX:
        assert t == {"route": "wmma", "BV": vocab_lse.BV} and wmma_smem(k, False) <= SMEM
        return
    assert t == {"route": "wgmma", "BV": vocab_lse.DW_BV} and dw_smem(k) <= SMEM
    bn = _constant("DW_BN")
    rows = [r for r0 in range(0, -(-n // bn) * bn, bn) for r in range(r0, r0 + bn) if r < n]
    assert rows == list(range(n))


def test_conformer_shape_tiling():
    """The conformer's CTC head at 16 x 15 s: dx's 59 row tiles on clusters
    of 2 (118 blocks of 132 SMs), 406 dw blocks of 128 columns, 4-slot
    rings."""
    assert vocab_lse.dx_tiling(7488, 256, 51865, SMS) == {"route": "wgmma", "C": 2}
    assert -(-51865 // vocab_lse.dw_tiling(256)["BV"]) == 406
    assert _constant("STAGES") == 4


@pytest.mark.cuda
def test_hopper_backward_matches_plain_on_card():
    """K4's forward, dx and dw against their plain versions on the card, at
    chip_smoke.py's shapes and bounds (K 128, 256 and 768)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    chip_smoke.check_k4(torch.device("cuda"), torch.Generator().manual_seed(0), timed=False)
