"""The thin-row int8-weight kernels' pure rules on the CPU: K6 (the W8A16
matmul, `csrc/w8a16.cu`) and K8g's thin forward (`csrc/int8_gemm.cu`, 64
rows or fewer). Both split K over the blocks of a thread-block cluster in
whole ring stages, chosen from the shapes alone by
`int8_serve.thin_tiling`; their split references (each block's partial
over its `split_ranges` rows, added in rank order) are held against JAX's
interpreted `_w8a16_2d` and JAX's `int8_matmul` on numpy-seeded inputs.

Tolerances: K8g's split reference is bit-identical to JAX (exact int32
partials, whose sum does not depend on the order, then the same float32
epilogue); K6's adds float32 partials in another order than JAX's one dot:
1e-5 x max |y| in float32, and in bf16 the output's own rounding (2^-9
relative) where the two sums straddle a rounding boundary: 1e-2 x max |y|,
as `test_torch_w8a16.py` holds the plain version."""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.ops import int8_linear as ji8
from agacs_tpu.ops import int8_serve as jserve
from agacs_tpu_torch.ops import cuda_lib, int8_linear, int8_serve

torch.set_num_threads(1)

RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
ROWS = (1, 5, 8, 32, 40)
# A decode step's products (whisper-small: self/cross q, k, v, out; fc1;
# fc2), greedy's 8 rows and beam 5's 40, and the padded logits head.
DECODE = ((8, 768, 768), (8, 768, 3072), (8, 3072, 768), (40, 768, 768),
          (40, 768, 3072), (40, 3072, 768), (8, 768, 52224), (40, 768, 52224))
SMS = 132  # the H100's streaming multiprocessors
KRS = {"K6": int8_serve.K6_KR, "K8g": int8_serve.K8_KR}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _source(name: str) -> str:
    return (cuda_lib.CSRC / name).read_text()


def _constant(name: str, source: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source(source)).group(1))


def _blocks(m: int, n: int, bn: int, splits: int) -> int:
    return -(-n // bn) * -(-m // int8_serve.THIN_MR) * splits


@pytest.mark.parametrize("kernel", list(KRS))
@pytest.mark.parametrize("m, k, n", DECODE + ((1, 256, 1024), (64, 64, 16), (3, 4096, 4096)))
def test_thin_tiling_rule(kernel, m, k, n):
    """(BN, S): BN 32 or 128, S 1..8, 1 at BN 128; K cut into whole stages
    (every boundary a multiple of the stage, the last at K) with no empty
    rank; a pure function of the shapes; the card filled wherever K has
    the stages for it."""
    kr = KRS[kernel]
    bn, s = int8_serve.thin_tiling(m, n, k, kr)
    assert (bn, s) == int8_serve.thin_tiling(m, n, k, kr)
    assert bn in (32, 128) and 1 <= s <= int8_serve.MAX_SPLITS and (bn == 32 or s == 1)
    ranges = int8_serve.split_ranges(k, kr, s)
    assert len(ranges) == s and ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b and a % kr == 0 for a, b in ranges)
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    stages = -(-k // kr)
    reachable = _blocks(m, n, 32, min(int8_serve.MAX_SPLITS, stages))
    assert _blocks(m, n, bn, s) >= min(SMS, reachable)


@pytest.mark.parametrize("kernel", list(KRS))
@pytest.mark.parametrize("m, k, n", DECODE)
def test_decode_shapes_fill_the_card(kernel, m, k, n):
    """At every decode-step shape a launch has a block for each SM; the
    logits head (52224 columns) takes 128-column tiles and no split."""
    bn, s = int8_serve.thin_tiling(m, n, k, KRS[kernel])
    assert _blocks(m, n, bn, s) >= SMS
    if n == 52224:
        assert (bn, s) == (128, 1)


def test_rules_match_the_sources():
    """The constants the Python rules and the CUDA sources share: the
    stage heights, the cluster's size, the rows of a block and the thin
    K8g's row limit (its C entry refuses more rows)."""
    assert _constant("KR", "w8a16.cu") == int8_serve.K6_KR
    assert _constant("TKR", "int8_gemm.cu") == int8_serve.K8_KR
    assert _constant("MAX_SPLITS", "thin_rows.cuh") == int8_serve.MAX_SPLITS
    assert 8 * _constant("MAX_NT", "thin_rows.cuh") == int8_serve.THIN_MR
    assert _constant("THIN_ROWS", "int8_gemm.cu") == int8_linear.THIN_ROWS == 64
    assert "if (M > THIN_ROWS || (bn != 32 && bn != 128))" in _source("int8_gemm.cu")
    assert "splitk" not in _source("w8a16.cu")


@pytest.mark.parametrize("m", [1, 8, 40, 64, 65, 300, 12000])
@pytest.mark.parametrize("dgrad", [False, True], ids=["fwd", "dgrad"])
def test_thin_gemm_dispatch(m, dgrad):
    """K8g's thin kernel takes the forward at 64 rows or fewer, nothing
    else; on a CPU tensor `int8_gemm` runs its plain version either way and
    counts no launch."""
    assert int8_linear.thin_gemm(m, dgrad) == (not dgrad and m <= 64)
    rng = np.random.RandomState(m)
    w_q = torch.from_numpy(rng.randint(-127, 128, (32, 48)).astype(np.int8))
    w_s = torch.from_numpy(rng.rand(48).astype(np.float32))
    k = 48 if dgrad else 32
    q = torch.from_numpy(rng.randint(-127, 128, (min(m, 300), k)).astype(np.int8))
    s = torch.ones(q.shape[0], 1)
    before = (int8_linear.LAUNCHES, int8_linear.THIN_LAUNCHES, int8_linear.DGRAD_LAUNCHES)
    out = int8_linear.int8_gemm(q, s, w_q, w_s, dgrad=dgrad)
    assert torch.equal(out, int8_linear.int8_gemm_ref(q, s, w_q, w_s, dgrad))
    assert before == (int8_linear.LAUNCHES, int8_linear.THIN_LAUNCHES,
                      int8_linear.DGRAD_LAUNCHES)


def _splits(k: int, kr: int) -> list[int]:
    """S 1, 2 and the largest S with no empty rank."""
    stages = -(-k // kr)
    big = max(s for s in range(1, int8_serve.MAX_SPLITS + 1)
              if (s - 1) * -(-stages // s) < stages)
    return sorted({1, 2, big})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", ROWS)
def test_w8a16_split_ref_matches_pallas_interpreted(rows, dtype):
    """K6's split over K (1008 = 16 stages of 64, the last 48 rows: S 1,
    2, 8) against JAX's `_w8a16_2d` interpreted, N 160 (a ragged 32-column
    tile); rows 1 and 5 against JAX's pad to 8, 40 past a multiple of 32."""
    rng = np.random.RandomState(rows)
    k, n = 1008, 160
    w_q, w_s = ji8.quantize_weight(jnp.asarray(rng.randn(k, n).astype(np.float32) / 32))
    x = jnp.asarray(rng.randn(rows, k).astype(np.float32), getattr(jnp, dtype))
    ref = _np(jserve._w8a16_2d(x, w_q, w_s, True))
    tq, ts = torch.from_numpy(np.asarray(w_q)), torch.from_numpy(np.asarray(w_s))
    xt = torch.from_numpy(_np(x)).to(getattr(torch, dtype))
    assert _splits(k, int8_serve.K6_KR) == [1, 2, 8]
    for s in _splits(k, int8_serve.K6_KR):
        y = int8_serve.w8a16_split_ref(xt, tq, ts, s)
        assert y.dtype == xt.dtype and y.shape == (rows, n)
        err = np.abs(y.float().numpy() - ref).max()
        assert err <= RTOL[dtype] * np.abs(ref).max(), (s, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", ROWS)
def test_int8_gemm_split_ref_bit_identical_to_jax(rows, dtype):
    """The thin K8g's split over K (912 = 8 stages of 128, the last 16
    rows: S 1, 2, 8) after the row quantisation, bit for bit JAX's
    `int8_matmul`, N 96."""
    rng = np.random.RandomState(100 + rows)
    k, n = 912, 96
    w_q, w_s = ji8.quantize_weight(jnp.asarray(rng.randn(k, n).astype(np.float32) / 32))
    x = jnp.asarray(rng.randn(rows, k).astype(np.float32), getattr(jnp, dtype))
    ref = _np(ji8.int8_matmul(x, w_q, w_s))
    tq, ts = torch.from_numpy(np.asarray(w_q)), torch.from_numpy(np.asarray(w_s))
    q, s_row = int8_linear.row_quant_ref(torch.from_numpy(_np(x)).to(getattr(torch, dtype)))
    assert _splits(k, int8_serve.K8_KR) == [1, 2, 8]
    for s in _splits(k, int8_serve.K8_KR):
        y = int8_linear.int8_gemm_split_ref(q, s_row, tq, ts, s, getattr(torch, dtype))
        np.testing.assert_array_equal(y.float().numpy(), ref, err_msg=f"S {s}")
