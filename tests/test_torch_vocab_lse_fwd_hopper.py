"""K4's Hopper forward on the CPU (`csrc/vocab_lse.cu`
`vocab_lse_fwd_kernel`): one launch at every K, S = x W_tile on wgmma per
64-column V tile, y = S log2 e + b log2 e with -inf from column V on (the
V tail masked by index), the tile's row maxima, a running (m, s) per row
in log2 units with s rescaled only when m grows, and each row tile's V
sweep split over a cluster of C ranks whose (m, s) pairs are merged in
rank order: m = max m_r, s = sum s_r 2^(m_r - m), lse = (m + log2 s) ln 2.
Here: a torch model of that arithmetic order (`fwd_split_ref`) at ragged
shapes (N 700, V 5000 at K 128, 256, 768 and 1024; N 300, V 1001 at K 128)
against JAX's `_fwd_pallas` interpreted and against `lse_plain`; the model
without the last rank's pair, which must fail; the tiling rule
(`fwd_tiling`) at every K the wrapper admits against the card's limits and
the source's constants; and, on the card, the kernel against its plain
version.

Tolerance: lse within 1e-4 relative per row, |lse| floored at 1 nat
(chip_smoke.py's K4_LSE_RTOL: float32 sums of exps in another order, the
fold of log2 e into one fmaf)."""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.ops import vocab_lse as jvl
from agacs_tpu_torch.ops import cuda_lib, vocab_lse

torch.set_num_threads(1)

RTOL = 1e-4
SMS = 132  # the H100's SMs
PORTABLE_CLUSTER = 8
SMEM = 232448  # shared memory a block can have on sm_90 (227 KB)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
SOURCE = (cuda_lib.CSRC / "vocab_lse.cu").read_text()
SHAPES = [(700, 128, 5000), (700, 256, 5000), (700, 768, 5000), (700, 1024, 5000),
          (300, 128, 1001)]


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def rank_tiles(v: int, c: int) -> list[tuple[int, int]]:
    """The V tiles [t0, t1) that each of the C ranks sweeps: [r n / C,
    (r + 1) n / C) of the n 64-column tiles."""
    n_vt = -(-v // vocab_lse.VT)
    return [(r * n_vt // c, (r + 1) * n_vt // c) for r in range(c)]


def rank_pairs(x, w, b, c: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each rank's running (m, s) per row, log2 units, after its sweep: per
    64-column tile y = S log2 e + b log2 e (W's columns from V on zero, b
    -inf there), m raised to the tile's row max with s rescaled only where
    it grows, then s += sum exp2(y - m)."""
    n, v = x.shape[0], w.shape[1]
    vt = vocab_lse.VT
    vp = -(-v // vt) * vt
    xf = x.float()
    wf = torch.zeros(w.shape[0], vp)
    wf[:, :v] = w.float()
    b2 = torch.full((vp,), float("-inf"))
    b2[:v] = b.float() * LOG2E
    pairs = []
    for t0, t1 in rank_tiles(v, c):
        m, s = torch.full((n,), float("-inf")), torch.zeros(n)
        for t in range(t0, t1):
            y = torch.addcmul(b2[t * vt:(t + 1) * vt], xf @ wf[:, t * vt:(t + 1) * vt],
                              torch.tensor(LOG2E))
            mx = y.max(1).values
            grow = mx > m
            s = torch.where(grow, s * torch.exp2(m - mx), s)
            m = torch.where(grow, mx, m)
            s = s + torch.exp2(y - m[:, None]).sum(1)
        pairs.append((m, s))
    return pairs


def merge(pairs) -> torch.Tensor:
    """The ranks' pairs merged in rank order into lse (natural log)."""
    m = pairs[0][0]
    for mr, _ in pairs[1:]:
        m = torch.maximum(m, mr)
    s = torch.zeros_like(m)
    for mr, sr in pairs:
        s = s + sr * torch.exp2(mr - m)
    return (m + torch.log2(s)) * LN2


def fwd_split_ref(x, w, b, c: int) -> torch.Tensor:
    """lse (N,) float32 in the forward kernel's arithmetic order on a
    cluster of C. The order of the float32 sums inside a product and of a
    row's exps (a thread's 16 columns, then its quad) is the tensor cores'
    and the kernel's, which no CPU product reproduces."""
    return merge(rank_pairs(x, w, b, c))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _row_err(out, ref) -> tuple[float, float]:
    """(max over rows of |out - ref| / max(|ref|, 1), its bound)."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float((np.abs(out - ref) / np.maximum(np.abs(ref), 1.0)).max()), RTOL


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    """bf16 x (N, K) and W (K, V) with products of std ~3, f32 b (std 1),
    as torch tensors, and JAX's forward interpreted on the same values."""
    n, k, v = request.param
    rng = np.random.RandomState(k + v)
    x = jnp.asarray(rng.randn(n, k), jnp.bfloat16)
    w = jnp.asarray(rng.randn(k, v) * 3 / np.sqrt(k), jnp.bfloat16)
    b = jnp.asarray(rng.randn(v), jnp.float32)
    ref = jvl._fwd_pallas(x, w, b, interpret=True)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(_np(a))).to(dtype)

    return (n, k, v), (t(x, torch.bfloat16), t(w, torch.bfloat16), t(b)), ref


def test_split_model_matches_pallas(case):
    """The model at the cluster `fwd_tiling` picks for the shape on 132 SMs."""
    (n, k, v), args, ref = case
    c = vocab_lse.fwd_tiling(n, k, v, SMS)["C"]
    out = fwd_split_ref(*args, c)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    err, bound = _row_err(out, ref)
    assert err <= bound, (c, err)


@pytest.mark.parametrize("c", [1, 2, 8])
def test_split_model_matches_plain(case, c):
    _, args, _ = case
    err, bound = _row_err(fwd_split_ref(*args, c), vocab_lse.lse_plain(*args))
    assert err <= bound, (c, err)


def test_split_model_needs_every_rank(case):
    """The ranks' pairs merged without the last one (C 8) miss the bound
    against JAX: every rank's share of V is needed."""
    _, args, ref = case
    pairs = rank_pairs(*args, 8)
    assert all(torch.isfinite(m).all() and (s >= 1).all() for m, s in pairs)
    err, bound = _row_err(merge(pairs[:-1]), ref)
    assert err > bound, err


def test_running_sum_needs_its_rescale(case):
    """A sweep that raises m without rescaling s misses the bound."""
    _, (x, w, b), ref = case
    vt = vocab_lse.VT
    v = w.shape[1]
    m, s = torch.full((x.shape[0],), float("-inf")), torch.zeros(x.shape[0])
    for t in range(-(-v // vt)):
        y = ((x.float() @ w.float()[:, t * vt:(t + 1) * vt]) + b[t * vt:(t + 1) * vt]) * LOG2E
        m = torch.maximum(m, y.max(1).values)
        s = s + torch.exp2(y - m[:, None]).sum(1)
    err, bound = _row_err((m + torch.log2(s)) * LN2, ref)
    assert err > bound, err


def fwd_smem(k: int, bm: int) -> int:
    """The forward's shared memory (the source's `fwd_smem`, its constants
    read from the source)."""
    stages, vt = _constant("STAGES"), _constant("VT")
    kc = k if k <= _constant("HK_MAX") else _constant("FWD_KC")
    return 1024 + bm * k * 2 + stages * kc * 128 + stages * vt * 4 + (1 + 2 * stages) * 8


def test_fwd_constants_match_the_source():
    for name in ("HK_MAX", "VT", "MAX_C", "STAGES", "FWD_KC", "SMEM_MAX"):
        assert getattr(vocab_lse, name) == _constant(name), name
    assert vocab_lse.SMEM_MAX == SMEM
    for line in ("constexpr int fwd_kc(int K) { return K <= HK_MAX ? K : FWD_KC; }",
                 "  return 1024 + BM * K * 2 + STAGES * fwd_kc(K) * 128 + STRIPS + BARS;",
                 "constexpr int fwd_bm(int K) { return fwd_smem(K, 128) <= SMEM_MAX ? 128 : 64; }",
                 "static_assert(fwd_bm(HK_MAX) == 128 && fwd_bm(768) == 128 && "
                 "fwd_bm(896) == 64 &&",
                 "      BM != fwd_bm(K) || C < 1 || C > MAX_C || (C & (C - 1)) || "
                 "C > (V + VT - 1) / VT)",
                 "  const dim3 grid(C, (N + BM - 1) / BM);",
                 "  const size_t smem = fwd_smem(K, BM);",
                 "  const int vt0 = rank * n_vt / C, nt = (rank + 1) * n_vt / C - vt0;",
                 "  const int rows = BM / C;"):
        assert line in SOURCE, line
    # one launch: the old combine pass and its scratch are gone
    assert "vocab_lse_combine" not in SOURCE and "part_m" not in SOURCE
    assert SOURCE.count("vocab_lse_fwd_kernel<") == 5  # and the stream route's above FWD_XK


@pytest.mark.parametrize("n", [60, 300, 700, 7488, 12000])
@pytest.mark.parametrize("k", range(128, 1025, 128))
def test_fwd_tiling(k, n):
    """Shared memory within 227 KB (128 rows where they fit, else 64), a
    cluster of 1, 2, 4 or 8 (the portable sizes) no larger than the V
    tiles, no more blocks than SMs unless C is 1, and the ranks' V tiles
    covering every tile exactly once, none empty."""
    v = 51865
    t = vocab_lse.fwd_tiling(n, k, v, SMS)
    assert t["route"] == ("tiles" if k <= vocab_lse.HK_MAX else "chunks")
    bm, c = t["BM"], t["C"]
    assert fwd_smem(k, bm) <= SMEM == vocab_lse.SMEM_MAX
    assert fwd_smem(k, bm) == vocab_lse.fwd_smem(k, bm)
    assert bm == (128 if fwd_smem(k, 128) <= SMEM else 64)
    assert bm == (128 if k <= 768 else 64)
    assert c in (1, 2, 4, 8) and c <= PORTABLE_CLUSTER
    assert c * -(-n // bm) <= SMS or c == 1
    assert bm % c == 0 and bm // c >= 8  # every rank merges whole rows
    ranges = rank_tiles(v, c)
    assert [i for t0, t1 in ranges for i in range(t0, t1)] == list(range(-(-v // vocab_lse.VT)))
    assert all(t1 > t0 for t0, t1 in ranges)


def test_conformer_shape_tiling():
    """The conformer's CTC head at 16 x 15 s: 59 row tiles of 128 on
    clusters of 2 (118 blocks of 132 SMs), as dx; the whisper CTC head's
    (12000, 768): 94 tiles of 128 on 64 x 64 chunks, C 1; the phase 2v
    shapes at K 1024 and V 500."""
    assert vocab_lse.fwd_tiling(7488, 256, 51865, SMS) == {"route": "tiles", "BM": 128, "C": 2}
    assert vocab_lse.dx_tiling(7488, 256, 51865, SMS)["C"] == 2
    assert vocab_lse.fwd_tiling(12000, 768, 51865, SMS) == {"route": "chunks", "BM": 128, "C": 1}
    assert vocab_lse.fwd_tiling(300, 1024, 1001, SMS) == {"route": "chunks", "BM": 64, "C": 8}
    # chip_smoke.py's (60, 128, 500): one V tile a rank, so a rank's first
    # tile is its last
    assert vocab_lse.fwd_tiling(60, 128, 500, SMS) == {"route": "tiles", "BM": 128, "C": 8}
    assert all(t1 - t0 == 1 for t0, t1 in rank_tiles(500, 8))


def test_padded_w_made_once_a_step():
    """On the CPU the autograd function saves w itself for the backward (no
    padded copy; the card's forward saves its `_rows8` copy for dx and
    dw), and the gradients are the plain backward's."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(40, 128).astype(np.float32)).requires_grad_()
    w = torch.from_numpy((rng.randn(128, 1001) / 8).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.randn(1001).astype(np.float32)).requires_grad_()
    lse = vocab_lse.streaming_lse(x, w, b)
    assert lse.grad_fn.saved_tensors[4] is w
    g = torch.from_numpy(rng.randn(40).astype(np.float32))
    lse.backward(g)
    ref = vocab_lse.lse_bwd_plain(x.detach(), w.detach(), b.detach(), lse.detach(), g)
    for got, want in zip((x.grad, w.grad, b.grad), ref):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_hopper_forward_matches_plain_on_card():
    """K4's forward (and its backward) against the plain versions on the
    card, at chip_smoke.py's shapes and bounds (K 128, 256, 768, 1024): lse
    finite, within 1e-4 relative per row with b NaN past V, and
    bit-identical on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    assert any(k == 1024 for _, k, _ in chip_smoke.K4_SHAPES)
    chip_smoke.check_k4(torch.device("cuda"), torch.Generator().manual_seed(0), timed=False)
