"""K4 above K 1024 on the CPU (`ops/vocab_lse.py`, `csrc/vocab_lse.cu`): the
whisper-large CTC head's K 1280, its padded neighbour K 1200 and K 1152.
The port's plain forward and backward against agacs_tpu's Pallas kernels
`_fwd_pallas` / `_bwd_pallas` in interpret mode (as `test_vocab_lse.py`
runs them); the K padding of the wrapper; a torch model of the split
backward's arithmetic on clusters of 9 and 10 ranks (each rank's partial S
over its 128-wide K-slice, added in rank order) against JAX, and without
its last rank, which must fail; the tiling rules at K 768, 1024 and 1280
and their constants against the source; and above K 1280 (the KS-256
routes, `test_torch_vocab_lse_anyk.py`) the wrapper's ask for the card.
Inputs are made with numpy from a seed, N 200 and V 1001 (ragged against
every row and column tile).

Tolerances, those of `test_torch_vocab_lse.py`: lse 1e-5 relative (float32
sums of exp in another order); dx and dW, bf16 outputs, 1e-2 x max |ref|
(dz rounded to bf16, the outputs rounded to bf16, after float32 sums in
another order); db 1e-5 x max |ref| (float32 sums); the padded route 1e-6
(exact zeros added, float32 sums in another order)."""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.ops import vocab_lse as jvl
from agacs_tpu_torch.ops import cuda_lib, vocab_lse

torch.set_num_threads(1)

N, V = 200, 1001
KS = (1152, 1200, 1280)
RTOL = {"dx": 1e-2, "dw": 1e-2, "db": 1e-5}
SMS = 132  # the H100's SMs
SMEM = 232448  # shared memory a block can have on sm_90 (227 KB)
SOURCE = (cuda_lib.CSRC / "vocab_lse.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+)", SOURCE).group(1))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, rtol, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


@pytest.fixture(scope="module", params=KS)
def case(request):
    """bf16 x (N, K) and W (K, V), float32 b and g; JAX's forward and
    backward interpreted on the same values."""
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

    return k, (t(x, torch.bfloat16), t(w, torch.bfloat16), t(b), t(lse), t(g)), lse, ref


def test_plain_lse_matches_pallas(case):
    _, (x, w, b, _, _), ref, _ = case
    out = vocab_lse.lse_plain(x, w, b)
    assert out.dtype == torch.float32 and out.shape == (N,)
    rel = np.abs(_np(out) - _np(ref)) / np.abs(_np(ref))
    assert rel.max() <= 1e-5, rel.max()


@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_plain_backward_matches_pallas(case, part):
    _, args, _, ref = case
    i = ("dx", "dw", "db").index(part)
    out = vocab_lse.lse_bwd_plain(*args)[i]
    assert out.dtype == (torch.float32 if part == "db" else torch.bfloat16)
    _close(out, ref[i], RTOL[part], part)


def test_padding_to_the_kernels_k_is_exact(case):
    """The wrapper's copies at K 1200 (x's columns and W's rows padded with
    zeros up to 1280, W's rows to a multiple of 8 columns): the plain
    versions on them give the unpadded results, and zeros in the padding."""
    k, (x, w, b, lse, g), _, _ = case
    kp = vocab_lse.padded_k(k)
    assert kp == -(-k // 128) * 128 <= vocab_lse.SPLIT128_K and (kp == k) == (k % 128 == 0)
    xp, wp = vocab_lse._pad_x(x), vocab_lse._rows8(w)
    assert xp.shape == (N, kp) and wp.shape == (kp, -(-V // 8) * 8)
    assert float(xp[:, k:].abs().sum()) == 0.0 and float(wp[k:].abs().sum()) == 0.0
    wpv = wp[:, :V]
    np.testing.assert_allclose(_np(vocab_lse.lse_plain(xp, wpv, b)),
                               _np(vocab_lse.lse_plain(x, w, b)), rtol=1e-6)
    got = vocab_lse.lse_bwd_plain(xp, wpv, b, lse, g)
    want = vocab_lse.lse_bwd_plain(x, w, b, lse, g)
    for a, ref in ((got[0][:, :k], want[0]), (got[1][:k], want[1]), (got[2], want[2])):
        np.testing.assert_allclose(_np(a), _np(ref), atol=1e-6 * float(np.abs(_np(ref)).max()))
    assert kp == k or float(got[0][:, k:].float().abs().max()) == 0.0


def split_ref(x, w, b, lse, g, c: int, ranks: int | None = None):
    """The split backward's arithmetic above K 1024 on a cluster of C ranks
    of 128 columns (K padded to 128 C): each rank's partial S over its
    K-slice in float32, the first `ranks` (all) added in rank order, dz =
    exp(S + b - lse) g from them, rounded to bf16 for both products; dx and
    dW^T by K-slices, db from the float32 dz."""
    k = x.shape[1]
    xp = vocab_lse._pad_x(x).float()
    wp = vocab_lse._rows8(w)[:, :w.shape[1]].float()
    assert xp.shape[1] == 128 * c
    slices = [slice(128 * r, 128 * (r + 1)) for r in range(c)]
    s = None
    for sl in slices[: ranks or c]:
        part = xp[:, sl] @ wp[sl]
        s = part if s is None else s + part
    dz = torch.exp(s + b - lse[:, None]) * g[:, None]
    dzr = dz.to(w.dtype).float()
    dx = torch.cat([dzr @ wp[sl].t() for sl in slices], 1)[:, :k]
    dw = torch.cat([(dzr.t() @ xp[:, sl]).t() for sl in slices], 0)[:k]
    return dx.to(x.dtype), dw.to(w.dtype), dz.sum(0)


@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_split_model_matches_pallas(case, part):
    """The model on the cluster the tiling rule picks (C 9 at K 1152, 10 at
    K 1200 and 1280) against JAX."""
    k, args, _, ref = case
    c = vocab_lse.dx_tiling(N, vocab_lse.padded_k(k), V, SMS)["C"]
    assert c == vocab_lse.dw_tiling(vocab_lse.padded_k(k))["C"] == -(-k // 128)
    i = ("dx", "dw", "db").index(part)
    _close(split_ref(*args, c=c)[i], ref[i], RTOL[part], part)


def test_split_model_needs_every_rank(case):
    """Without the last rank's partial S the model misses dx's bound."""
    k, args, _, ref = case
    c = -(-k // 128)
    dx = split_ref(*args, c=c, ranks=c - 1)[0]
    err = np.abs(_np(dx) - _np(ref[0])).max()
    assert err > RTOL["dx"] * np.abs(_np(ref[0])).max(), err


@pytest.mark.parametrize("k,c", [(768, 6), (1024, 8), (1152, 9), (1280, 10)])
def test_tiling_at_the_whisper_widths(k, c):
    """dx and dw above K 256: the split kernel on clusters of K / 128 (KS
    128): portable up to 8 (K 1024), non-portable at 9 and 10 (K 1152,
    1280); the forward's chunked route with 128 rows a block up to K 768,
    64 above, at the CTC head's 16 x 750 rows."""
    assert vocab_lse.dx_tiling(12000, k, 51865, SMS) == {"route": "split", "C": c, "KS": 128}
    assert vocab_lse.dw_tiling(k) == {"route": "split", "BV": 128, "C": c, "KS": 128}
    assert (c > vocab_lse.MAX_C) == (k > 1024)
    fwd = vocab_lse.fwd_tiling(12000, k, 51865, SMS)
    assert fwd["route"] == "chunks" and fwd["BM"] == (128 if k <= 768 else 64)
    assert vocab_lse.fwd_smem(k, fwd["BM"]) <= SMEM


@pytest.mark.parametrize("c", [9, 10])
def test_wide_cluster_quads_and_shared_memory(c):
    """The exchange on 9 or 10 ranks: rank r owns quads [r 32 / C, (r + 1) 32
    / C) of a warpgroup's 32 (3 or 4, one pass of the 4 warps), the
    source's `quad_owner` maps each to it, every rank's partials fit the
    RECV_WIDE quads of a receive slot, and the wide instance's shared
    memory (`split_smem_wide`, read from the source's constants) fits."""
    owned = [list(range(r * 32 // c, (r + 1) * 32 // c)) for r in range(c)]
    assert [q for qs in owned for q in qs] == list(range(32))
    assert all(((q + 1) * c - 1) // 32 == r for r, qs in enumerate(owned) for q in qs)
    assert {len(qs) for qs in owned} <= {3, 4}
    recv, quads = _constant("RECV_WIDE"), _constant("RECV_QUADS")
    assert c * -(-32 // c) <= recv == max(n * -(-32 // n) for n in (9, 10))
    stages, ks = _constant("STAGES"), _constant("KS")
    strips, bars = stages * vocab_lse.VT * 4, (1 + 2 * stages + 8) * 8
    portable = (1024 + 128 * ks * 2 + stages * ks * 128 + 4 * quads * 32 * 16
                + 4 * 32 * 32 * 8 + 2 * strips + 2 * 128 * 4 + bars)
    assert portable == 209032
    assert portable + 4 * (recv - quads) * 32 * 16 == 217224 <= SMEM


def test_split_route_constants_match_the_source():
    """The KS-128 split up to SPLIT128_K (1280, a cluster of 10 at most) and
    the KS-256 routes above it, dispatched by the C entries by K."""
    assert vocab_lse.SPLIT128_K == _constant("SPLIT128_K") == 1280 == 10 * vocab_lse.KS
    for line in ("constexpr int WIDE_C = SPLIT128_K / KS;",
                 "  return split_smem() + 4 * (RECV_WIDE - RECV_QUADS) * QBLK;",
                 "  if (C > MAX_C)\n    return launch_split(vocab_lse_split_kernel<false, WIDE_C>,",
                 "  if (K / KS > MAX_C)\n    return launch_split(vocab_lse_split_kernel<true, WIDE_C>,",
                 "    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);",
                 "  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);",
                 "    return launch_ks2<false>(grid, st, mp, bf, lf, gf, dx, (float*)nullptr, N, K, V, 0);",
                 "    return launch_ks2<true>(grid, st, mp, bf, lf, gf, dw, (float*)db, N, K, V, Vp);"):
        assert line in SOURCE, line
    # the dx and dw entries take the KS-256 route above SPLIT128_K, and no
    # C entry refuses a K for its size
    assert SOURCE.count("  if (K > SPLIT128_K) {") == 3
    assert SOURCE.count("K % 128 || ldw < V || ldw % 8") == 3
    assert not re.search(r"K > 1024 \|\||K > K_MAX", SOURCE)


@pytest.mark.parametrize("k", [1281, 1408, 2048])
def test_above_1280_the_wrapper_asks_for_the_card(k):
    """Above K 1280 K4's wrapper takes K (its check passes the shapes) and,
    before it touches a device (meta tensors here), raises for the device:
    a tensor off the card never falls back. The CPU path (the plain
    versions) gives torch.logsumexp."""
    x = torch.empty(4, k, dtype=torch.bfloat16, device="meta")
    w = torch.empty(k, 300, dtype=torch.bfloat16, device="meta")
    b = torch.empty(300, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        vocab_lse._check(x, w, b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vocab_lse._launch_dx(x, w, b, torch.empty(4, device="meta"),
                             torch.empty(4, device="meta"))
    rng = np.random.RandomState(k)
    xc = torch.from_numpy(rng.randn(4, k).astype(np.float32))
    wc = torch.from_numpy((rng.randn(k, 300) / np.sqrt(k)).astype(np.float32))
    bc = torch.zeros(300)
    torch.testing.assert_close(vocab_lse.streaming_lse(xc, wc, bc),
                               torch.logsumexp(xc @ wc, -1), rtol=1e-5, atol=1e-5)


def test_at_the_limit_the_wrapper_asks_for_the_card():
    """K 1280 passes the K check; on a tensor off the card K4 then raises
    for the device, never falls back."""
    x = torch.empty(4, 1280, dtype=torch.bfloat16, device="meta")
    w = torch.empty(1280, 300, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        vocab_lse._check(x, w, torch.empty(300, device="meta"))
