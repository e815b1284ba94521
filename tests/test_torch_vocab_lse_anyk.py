"""K4 above K 1280 on the CPU (`ops/vocab_lse.py`, `csrc/vocab_lse.cu`): K
1408 (padded to 1536), 1536 (the CTC head of a conformer at USM-2B's width),
2048, 4096 and 4224 (padded to 4608, two groups). The port's plain forward
and backward against agacs_tpu's Pallas kernels `_fwd_pallas` /
`_bwd_pallas` in interpret mode (as `test_vocab_lse.py` runs them); the
wrapper's padding to the new granule; a torch model of the KS-256 split
backward's arithmetic (each rank's partial S over its 256-wide slice, and
in the grouped route over its slice of every group, added in rank order;
each group's output slices from its own S) against JAX, and without its
last rank, which must fail; the tiling rules and their constants and shared
memory against the source. Inputs are made with numpy from a seed, N 200
(64 at K 4096 and 4224) and V 1001 (ragged against every row and column
tile).

Tolerances, those of `test_torch_vocab_lse_wide.py`: lse 1e-5 relative
(float32 sums of exp in another order); dx and dW, bf16 outputs, 1e-2 x max
|ref| (dz rounded to bf16, the outputs rounded to bf16, after float32 sums
in another order); db 1e-5 x max |ref| (float32 sums); the padded route
1e-6 (exact zeros added, float32 sums in another order)."""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.ops import vocab_lse as jvl
from agacs_tpu_torch.ops import cuda_lib, vocab_lse

torch.set_num_threads(1)

V = 1001
CASES = ((200, 1408), (200, 1536), (200, 2048), (64, 4096), (64, 4224))
RTOL = {"dx": 1e-2, "dw": 1e-2, "db": 1e-5}
SMEM = 232448  # shared memory a block can have on sm_90 (227 KB)
SOURCE = (cuda_lib.CSRC / "vocab_lse.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, rtol, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


@pytest.fixture(scope="module", params=CASES, ids=[f"K{k}" for _, k in CASES])
def case(request):
    """bf16 x (N, K) and W (K, V), float32 b and g; JAX's forward and
    backward interpreted on the same values."""
    n, k = request.param
    rng = np.random.RandomState(k)
    x = jnp.asarray(rng.randn(n, k), jnp.bfloat16)
    w = jnp.asarray(rng.randn(k, V) * 3 / np.sqrt(k), jnp.bfloat16)
    b = jnp.asarray(rng.randn(V), jnp.float32)
    g = jnp.asarray(rng.randn(n), jnp.float32)
    lse = jvl._fwd_pallas(x, w, b, interpret=True)
    ref = jvl._bwd_pallas(x, w, b, lse, g, interpret=True)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(_np(a))).to(dtype)

    return k, (t(x, torch.bfloat16), t(w, torch.bfloat16), t(b), t(lse), t(g)), lse, ref


def test_plain_lse_matches_pallas(case):
    _, (x, w, b, _, _), ref, _ = case
    out = vocab_lse.lse_plain(x, w, b)
    assert out.dtype == torch.float32 and out.shape == (x.shape[0],)
    rel = np.abs(_np(out) - _np(ref)) / np.abs(_np(ref))
    assert rel.max() <= 1e-5, rel.max()


@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_plain_backward_matches_pallas(case, part):
    _, args, _, ref = case
    i = ("dx", "dw", "db").index(part)
    out = vocab_lse.lse_bwd_plain(*args)[i]
    assert out.dtype == (torch.float32 if part == "db" else torch.bfloat16)
    _close(out, ref[i], RTOL[part], part)


def test_padding_to_the_new_granule_is_exact(case):
    """The wrapper's copies (x's columns and W's rows padded with zeros up
    to `padded_k`: a multiple of 256 above K 1280, of 256 C G above 4096;
    W's rows to a multiple of 8 columns): the plain versions on them give
    the unpadded results, and zeros in the padding."""
    k, (x, w, b, lse, g), _, _ = case
    n = x.shape[0]
    kp = vocab_lse.padded_k(k)
    c, grp = vocab_lse.split_groups(kp)
    assert kp % 256 == 0 and kp == 256 * c * grp and kp - k < 256 * grp
    assert kp == {1408: 1536, 4224: 4608}.get(k, k)
    xp, wp = vocab_lse._pad_x(x), vocab_lse._rows8(w)
    assert xp.shape == (n, kp) and wp.shape == (kp, -(-V // 8) * 8)
    assert float(xp[:, k:].abs().sum()) == 0.0 and float(wp[k:].abs().sum()) == 0.0
    wpv = wp[:, :V]
    np.testing.assert_allclose(_np(vocab_lse.lse_plain(xp, wpv, b)),
                               _np(vocab_lse.lse_plain(x, w, b)), rtol=1e-6)
    got = vocab_lse.lse_bwd_plain(xp, wpv, b, lse, g)
    want = vocab_lse.lse_bwd_plain(x, w, b, lse, g)
    for a, ref in ((got[0][:, :k], want[0]), (got[1][:k], want[1]), (got[2], want[2])):
        np.testing.assert_allclose(_np(a), _np(ref), atol=1e-6 * float(np.abs(_np(ref)).max()))
    assert kp == k or float(got[0][:, k:].float().abs().max()) == 0.0


def ks2_ref(x, w, b, lse, g, c: int, groups: int, ranks: int | None = None):
    """The split backward's arithmetic above K 1280 on G `groups` of C ranks
    of 256 columns (K padded to 256 C G). Rank r of group h owns output
    slice h C + r; its partial S is the product over that slice, then over
    slices j C + r of the other groups j in ascending order; the first
    `ranks` (all) partials are added in rank order into the group's S, dz =
    exp(S + b - lse) g from it, rounded to bf16 for both products; the
    group's dx columns and dW rows come from its own dz, db from group
    0's."""
    k = x.shape[1]
    xp = vocab_lse._pad_x(x).float()
    wp = vocab_lse._rows8(w)[:, :w.shape[1]].float()
    assert xp.shape[1] == 256 * c * groups

    def sl(j):
        return slice(256 * j, 256 * (j + 1))

    dx, dwt, db = [], [], None
    for h in range(groups):
        s = None
        for r in range(ranks or c):
            own = h * c + r
            part = xp[:, sl(own)] @ wp[sl(own)]
            for j in range(groups):
                if j != h:
                    part = part + xp[:, sl(j * c + r)] @ wp[sl(j * c + r)]
            s = part if s is None else s + part
        dz = torch.exp(s + b - lse[:, None]) * g[:, None]
        dzr = dz.to(w.dtype).float()
        dx += [dzr @ wp[sl(h * c + r)].t() for r in range(c)]
        dwt += [dzr.t() @ xp[:, sl(h * c + r)] for r in range(c)]
        db = dz.sum(0) if db is None else db
    return (torch.cat(dx, 1)[:, :k].to(x.dtype), torch.cat(dwt, 1).t()[:k].to(w.dtype), db)


@pytest.mark.parametrize("part", ["dx", "dw", "db"])
def test_split_model_matches_pallas(case, part):
    """The model on the clusters the tiling rule picks (C 6 at K 1408 and
    1536, 8 at 2048, 16 at 4096; 2 groups of 9 at 4224) against JAX."""
    k, args, _, ref = case
    kp = vocab_lse.padded_k(k)
    tx = vocab_lse.dx_tiling(args[0].shape[0], kp, V, 132)
    assert (tx["C"], tx["G"]) == {1408: (6, 1), 1536: (6, 1), 2048: (8, 1), 4096: (16, 1),
                                  4224: (9, 2)}[k]
    i = ("dx", "dw", "db").index(part)
    _close(ks2_ref(*args, c=tx["C"], groups=tx["G"])[i], ref[i], RTOL[part], part)


def test_split_model_needs_every_rank(case):
    """Without the last rank's partial S (of every group) the model misses
    dx's bound."""
    k, args, _, ref = case
    c, grp = vocab_lse.split_groups(vocab_lse.padded_k(k))
    dx = ks2_ref(*args, c=c, groups=grp, ranks=c - 1)[0]
    err = np.abs(_np(dx) - _np(ref[0])).max()
    assert err > RTOL["dx"] * np.abs(_np(ref[0])).max(), err


def split2_smem(grouped: bool) -> int:
    """The KS-256 split kernels' shared memory (the source's `split_layout`
    at one warpgroup, its constants read from the source): alignment slack,
    the resident slice (64 x 256 bf16), the ring (4 slots, 3 when grouped,
    of 256 x 64 bf16), two receive slots of RECV_KS2 quads of 32 float4,
    two slots of P (32 quads of 32 pairs of bf16 pairs), the foreign ring
    (FSTAGES slots of two 64 x 64 bf16 chunks, grouped only), the strips
    (two tables of a slot's 64 f32), the block's tables and the
    barriers."""
    ks2, stages, recv = _constant("KS2"), _constant("STAGES"), _constant("RECV_KS2")
    st = stages - 1 if grouped else stages
    fst = _constant("FSTAGES") if grouped else 0
    return (1024 + 64 * ks2 * 2 + st * ks2 * 128 + 2 * recv * 32 * 16 + 2 * 32 * 32 * 8
            + fst * 2 * 8192 + 2 * st * 64 * 4 + 2 * 128 * 4
            + (1 + 2 * st + 4 + 2 * fst) * 8)


def test_new_constants_and_shared_memory_match_the_source():
    assert (vocab_lse.KS2, vocab_lse.MAX_CW, vocab_lse.SPLIT128_K) == (
        _constant("KS2"), _constant("MAX_CW"), _constant("SPLIT128_K")) == (256, 16, 1280)
    assert vocab_lse.FWD_XK == _constant("FWD_XK") == 1536
    assert vocab_lse.GROUP_K == 4096 == _constant("MAX_CW") * _constant("KS2")
    assert "constexpr int FCHUNK = 2 * 8192;" in SOURCE and _constant("FSTAGES") == 2
    # the receive slot holds every rank's partials of a rank's quads at C 6 to 16
    assert _constant("RECV_KS2") == max(c * -(-32 // c) for c in range(6, 17)) == 45
    assert split2_smem(False) == 230504 <= SMEM and split2_smem(True) == 230008 <= SMEM
    # the forward's resident rows at their limit, and its stream route
    assert vocab_lse.fwd_smem(1536, 64) == 231496 <= SMEM  # x's 64 rows resident
    assert 1024 + 64 * 1664 * 2 + 4 * 64 * 128 + 4 * 64 * 4 + 9 * 8 > SMEM  # no longer at 1664
    assert vocab_lse.fwd_smem(2048, 64) == 1024 + 4 * 128 * 128 + 4 * 64 * 4 + 9 * 8 == 67656
    for line in ("  return split_layout(1, KS2, gr ? STAGES - 1 : STAGES, RECV_KS2, gr ? FSTAGES : 0);",
                 "  return 1024 + STAGES * (FWD_KC + 64) * 128 + STRIPS + BARS;",
                 "  return 1024 + 64 * nwg * ksz * 2 + st * ksz * 128 + 2 * nwg * rq * QBLK + "
                 "2 * nwg * 32 * PBLK +",
                 "static_assert(split_layout(2, KS, STAGES, RECV_QUADS, 0) == split_smem() &&",
                 "    if (G == 0 || C != K / KS2 / G) return (int)cudaErrorInvalidValue;",
                 "    const dim3 grid(C, (N + 63) / 64, G);",
                 "    const dim3 grid(C, Vp / 64, G);",
                 "      if (lane == 0 && grp == 0) db[a] = sa[m], db[a + 8] = sb[m];",
                 "  const int b0 = blockIdx.y * BT, k0 = (grp * C + rank) * KSZ;",
                 "    return launch_hk(vocab_lse_fwd_kernel<FWD_KC, 64, true>, grid, C, 256, "
                 "fwd_stream_smem(), st,"):
        assert line in SOURCE, line
    assert not re.search(r"\bK_MAX\b", SOURCE) and not hasattr(vocab_lse, "K_MAX")


@pytest.mark.parametrize("k", [1408, 1536, 2048, 4096, 4224])
def test_tiling_above_1280(k):
    """K padded to 256 (256 C G above 4096); dx and dw on clusters of C =
    K / 256 / G (portable up to 8, at most 16) over G groups, 64-row dx
    tiles and 64-column dw blocks; the forward's resident rows at K 1536
    and the stream route above; every route's shared memory within 227
    KB."""
    kp = vocab_lse.padded_k(k)
    c, grp = {1408: (6, 1), 1536: (6, 1), 2048: (8, 1), 4096: (16, 1), 4224: (9, 2)}[k]
    assert kp == 256 * c * grp and vocab_lse.split_groups(kp) == (c, grp)
    assert vocab_lse.dx_tiling(12000, kp, 51865, 132) == {"route": "split", "C": c, "KS": 256,
                                                          "G": grp, "BM": 64}
    assert vocab_lse.dw_tiling(kp) == {"route": "split", "BV": 64, "C": c, "KS": 256, "G": grp}
    assert c <= vocab_lse.MAX_CW and (c > vocab_lse.MAX_C) == (k in (4096, 4224))
    assert c * 256 <= vocab_lse.GROUP_K and grp == -(-kp // vocab_lse.GROUP_K)
    fwd = vocab_lse.fwd_tiling(12000, kp, 51865, 132)
    assert fwd == {"route": "chunks" if kp <= 1536 else "stream", "BM": 64, "C": 1}
    assert vocab_lse.fwd_smem(kp, 64) <= SMEM
    # the slices: each group's C ranks own distinct 256-wide output slices
    # that cover K once, and a rank's partial S covers its slice of every
    # group
    owned = [(h * c + r) for h in range(grp) for r in range(c)]
    assert sorted(owned) == list(range(kp // 256))
    for r in range(c):
        assert sorted(h * c + r for h in range(grp)) == [r + h * c for h in range(grp)]


@pytest.mark.parametrize("c", range(6, 17))
def test_ks2_cluster_quads(c):
    """The exchange on 6 to 16 ranks of one warpgroup: rank r owns quads [r
    32 / C, (r + 1) 32 / C) of the 32 (at most 6, in two passes of the 4
    warps), the source's `quad_owner` maps each to it, and every rank's
    partials fit the RECV_KS2 quads of a receive slot."""
    owned = [list(range(r * 32 // c, (r + 1) * 32 // c)) for r in range(c)]
    assert [q for qs in owned for q in qs] == list(range(32))
    assert all(((q + 1) * c - 1) // 32 == r for r, qs in enumerate(owned) for q in qs)
    assert max(map(len, owned)) <= min(4 * 3, -(-32 // c)) <= 6
    assert c * -(-32 // c) <= _constant("RECV_KS2")
