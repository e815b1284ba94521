"""K8's Hopper design on the CPU (`csrc/int8_gemm.cu`): the thin product
with K8q folded in (`int8_linear.thin_matmul`: each rank of the K-split
cluster takes its slice's row maxima, the ranks exchange them, every rank
quantises its slice with the max of the S partials) and the wide K8g's
pure rules and operands (`gemm_tiling`; the forward reads w_q^T, which
`Int8Linear.weight_t` and the fused projections' cache keep).

Here: the split's plain model `thin_matmul_split_ref` against the plain
version and JAX's `int8_matmul` on numpy-seeded inputs at every S from 1
to 8, the tiling rule against the constants of the CUDA source, the
dispatch of a product (one launch at <= 64 rows), and the kept transposes.

Tolerance: exact. The max of the ranks' maxima is the row's max, each
rank quantises with that one scale, and the int32 partials' sum does not
depend on the order, so the model equals the plain version and JAX bit for
bit."""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.ops import int8_linear as ji8
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.ops import cuda_lib, int8_linear, int8_serve
from agacs_tpu_torch.train.freeze import apply_freeze

torch.set_num_threads(1)

SMEM = 232448  # shared memory a block may opt into on the H100 (227 KB)
SMS = 132      # the H100 SXM's streaming multiprocessors
# A decode step's products (whisper-small: q, k, v, out; fc1; fc2), greedy's
# 8 rows and beam 5's 40, and the most rows the thin product takes.
THIN = ((8, 768, 768), (8, 768, 3072), (8, 3072, 768), (40, 768, 768), (64, 768, 768))
# The wide K8g's (rows, N): the int8 train step's 12000 encoder rows (out,
# cross k/v, fused q/k/v), serving's 6000, the teacher-forced decoder's 528
# (fused q/k/v and out), the dgrad's N = 768, and edges.
WIDE = ((12000, 768), (12000, 1536), (12000, 2304), (6000, 768), (528, 768), (528, 2304),
        (65, 768), (33, 768), (2816, 768), (2817, 768), (300, 96))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _source() -> str:
    return (cuda_lib.CSRC / "int8_gemm.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source()).group(1))


def _inputs(m: int, k: int, n: int, dtype: str):
    """Whisper-like int8 weights (JAX's quantisation) and rows with a few
    outliers, so a row's max lies in one rank's slice of K."""
    rng = np.random.RandomState(m * 7 + k + n)
    w_q, w_s = ji8.quantize_weight(jnp.asarray(rng.randn(k, n).astype(np.float32) / 32))
    x = rng.randn(m, k).astype(np.float32)
    x[np.arange(m), rng.randint(0, k, m)] *= 9.0
    x = jnp.asarray(x, getattr(jnp, dtype))
    return x, w_q, w_s


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m, k, n", THIN)
def test_thin_split_model_bit_identical_to_plain_and_jax(m, k, n, dtype, splits):
    """The fused split (per-rank partial maxima, their max, each rank's
    slice quantised and its int32 partial, added in rank order) equals the
    plain version and JAX's `int8_matmul` in every element."""
    x, w_q, w_s = _inputs(m, k, n, dtype)
    ref = _np(ji8.int8_matmul(x, w_q, w_s))
    xt = torch.from_numpy(_np(x)).to(getattr(torch, dtype))
    tq, ts = torch.from_numpy(np.asarray(w_q)), torch.from_numpy(np.asarray(w_s))
    y = int8_linear.thin_matmul_split_ref(xt, tq, ts, splits)
    assert y.dtype == xt.dtype and y.shape == (m, n)
    assert torch.equal(y, int8_linear.int8_matmul_ref(xt, tq, ts))
    np.testing.assert_array_equal(y.float().numpy(), ref)


def test_thin_split_model_needs_the_exchange():
    """A rank that quantised with its own partial max, or a max taken over
    a rank's first stage alone, moves the output (what the kernel's
    mutants of the exchange and of the k-range break)."""
    x, w_q, w_s = _inputs(8, 3072, 768, "float32")
    xt = torch.from_numpy(_np(x))
    tq, ts = torch.from_numpy(np.asarray(w_q)), torch.from_numpy(np.asarray(w_s))
    plain = int8_linear.int8_matmul_ref(xt, tq, ts)
    bn, splits = int8_serve.thin_tiling(8, 768, 3072, int8_serve.K8_KR)
    assert (bn, splits) == (32, 8)
    ranges = int8_serve.split_ranges(3072, int8_serve.K8_KR, splits)
    own, first = torch.zeros(8, 768, dtype=torch.long), torch.zeros(8)
    for k0, k1 in ranges:
        s_own = int8_linear._scale(xt[:, k0:k1].abs().amax(-1))[:, None]
        own += torch.round(xt[:, k0:k1] / s_own).long() @ tq[k0:k1].long()
        if k0 == 0:
            s_rank0 = s_own  # rank 0's epilogue
        first = torch.maximum(first, xt[:, k0:k0 + int8_serve.K8_KR].abs().amax(-1))
    assert not torch.equal(own.float() * s_rank0 * ts, plain)
    s_first = int8_linear._scale(first)[:, None]
    q_first = torch.clamp(torch.round(xt / s_first), -127, 127).to(torch.int8)
    assert not torch.equal(int8_linear.int8_gemm_ref(q_first, s_first, tq, ts), plain)


@pytest.mark.parametrize("m, n", WIDE)
def test_gemm_tiling_rule(m, n):
    """(BM, BN) of the wide K8g: BN the source's 128; BM 128 where 128-row
    tiles give each of the card's SMs one (the H100's 132 here), else 64;
    a pure function of the shapes and the SM count."""
    bm, bn = int8_linear.gemm_tiling(m, n, SMS)
    assert (bm, bn) == int8_linear.gemm_tiling(m, n, SMS)
    assert bn == int8_linear.WIDE_BN == _constant("WBN")
    tiles128 = -(-m // 128) * -(-n // bn)
    assert bm == (128 if tiles128 >= SMS else 64)
    assert int8_linear.gemm_tiling(m, n, tiles128)[0] == 128
    assert int8_linear.gemm_tiling(m, n, tiles128 + 1)[0] == 64
    if m == 528:
        assert bm == 64  # the teacher-forced decoder: 30 tiles of 128 rows at N 768
    if m >= 6000:
        assert bm == 128


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("out_bytes", [2, 4])
def test_wide_kernel_fits_shared_memory(bm, out_bytes):
    """The wide kernel's ring (a BM x 128-byte A box and a 128 x 128-byte
    B box a slot), its two warpgroups' output staging and barriers, as
    `wide_smem` in the source counts them, fit one block's shared memory,
    and every TMA box is 1024-byte aligned in it."""
    stages, bk = _constant("WSTAGES"), _constant("WBK")
    assert bk == 128 and _constant("WCONSUMERS") == 256
    slot = bm * bk + int8_linear.WIDE_BN * bk
    wn = int8_linear.WIDE_BN if bm == 128 else int8_linear.WIDE_BN // 2
    smem = 1024 + stages * slot + 2 * 64 * (wn * out_bytes + 16) + 2 * stages * 8
    assert smem <= SMEM
    assert slot % 1024 == 0 and (bm * bk) % 1024 == 0 and (64 * bk) % 1024 == 0
    assert "return 1024 + (size_t)WSTAGES * wide_slot<BM>() + 2 * 64 * wide_ldo<BM, OUT_BF16>() +" \
        in _source()


def test_sources_dispatch_as_the_wrappers():
    """`int8_gemm`'s C entry takes the wide kernel at every row count; the
    thin kernel has one entry, the one-launch product with K8q folded in,
    which refuses more than THIN_ROWS rows."""
    src = _source()
    entry = src[src.index('extern "C" int int8_gemm('):src.index('extern "C" int int8_thin_matmul(')]
    assert "launch_wide(" in entry and "launch_thin" not in entry and "THIN_ROWS" not in entry
    assert "const int8_t* b = dgrad ? w : w_t;" in entry
    assert _constant("THIN_ROWS") == int8_linear.THIN_ROWS
    assert "if (M > THIN_ROWS || (bn != 32 && bn != 128))" in src
    assert "thin_gemm_kernel<BN, NT, OUT_BF16, XT>" in src and "int8_t>" not in src


@pytest.mark.parametrize("rows", [1, 8, 40, 64, 65, 300])
def test_matmul_dispatch_on_the_cpu(rows, monkeypatch):
    """At <= 64 rows a product is `thin_matmul` (no separate K8q), above it
    K8q + K8g; on a CPU tensor both run the plain version and count no
    launch, and the output is `int8_matmul_ref`'s."""
    x, w_q, w_s = _inputs(rows, 256, 96, "bfloat16")
    xt = torch.from_numpy(_np(x)).to(torch.bfloat16)
    tq, ts = torch.from_numpy(np.asarray(w_q)), torch.from_numpy(np.asarray(w_s))
    calls = []
    for fn in ("thin_matmul", "rowquant"):
        real = getattr(int8_linear, fn)
        monkeypatch.setattr(int8_linear, fn, lambda *a, _f=fn, _r=real: calls.append(_f) or _r(*a))
    before = (int8_linear.QUANT_LAUNCHES, int8_linear.LAUNCHES, int8_linear.THIN_LAUNCHES)
    y = int8_linear.int8_matmul(xt, tq, ts)
    assert calls == (["thin_matmul"] if rows <= 64 else ["rowquant"])
    assert torch.equal(y, int8_linear.int8_matmul_ref(xt, tq, ts))
    assert before == (int8_linear.QUANT_LAUNCHES, int8_linear.LAUNCHES,
                      int8_linear.THIN_LAUNCHES)


def _int8_model():
    cfg = tw.make_config("test", adapter=True)
    model = tw.Whisper.from_state_dict(
        cfg, tw.init_whisper_params(torch.Generator().manual_seed(0), cfg))
    apply_freeze(model, "adapter")
    return model.quantize_frozen_()


def test_kept_transposes_are_w_q_t_and_not_state():
    """`Int8Linear.weight_t` is weight_q^T, contiguous, made once and kept;
    the model's state dict is unchanged by it; an in-place write of the
    buffer, or a move of the module, drops the copy."""
    model = _int8_model()
    keys = list(model.state_dict())
    lin = model.encoder.blocks[0].attn.out
    assert isinstance(lin, tw.Int8Linear)
    wt = lin.weight_t()
    assert torch.equal(wt, lin.weight_q.t()) and wt.is_contiguous()
    assert lin.weight_t() is wt  # kept
    assert list(model.state_dict()) == keys
    with torch.no_grad():
        lin.weight_q.fill_(1)
    wt_new = lin.weight_t()
    assert wt_new is not wt and bool((wt_new == 1).all())
    model.to("cpu")
    assert lin._t_cache == {}
    assert lin.weight_t() is not wt_new and torch.equal(lin.weight_t(), lin.weight_q.t())


def test_wide_forward_is_handed_the_kept_transposes(monkeypatch):
    """Every int8 product of an attention layer is handed a function that
    gives its weight transposed: the fused q/k/v the concatenation's
    transpose, kept beside the concatenation; `out` its own `weight_t`.
    Nothing calls it on the CPU, so no copy is made there; called where a
    decode request runs (inference mode, where the concatenation is made
    too) it gives the same copies."""
    model = _int8_model()
    attn = model.encoder.blocks[0].attn
    x = torch.randn(1, 70, attn.query.in_features, generator=torch.Generator().manual_seed(1))
    real = int8_linear._matmul
    seen = []
    monkeypatch.setattr(int8_linear, "_matmul", lambda x2, w_q, w_s, w_t=None:
                        seen.append((w_q, w_t)) or real(x2, w_q, w_s, w_t))
    with torch.no_grad():
        attn(x)
    assert attn.out._t_cache == {} and all(c[2] == {} for c, _ in attn._fused.values())
    assert len(seen) == 2 and all(w_t is not None for _, w_t in seen)
    attn._fused.clear()
    seen.clear()
    monkeypatch.setattr(int8_linear, "_matmul", lambda x2, w_q, w_s, w_t=None:
                        seen.append((w_q, w_t, w_t())) or real(x2, w_q, w_s, w_t))
    with torch.inference_mode():
        attn(x)
    assert len(seen) == 2
    for w_q, w_t, made in seen:
        assert torch.equal(made, w_q.t()) and made.is_contiguous() and w_t() is made
    ((cat, _),) = attn._fused.values()
    assert len(cat[2]) == 1 and attn.out._t_cache
    attn.to("cpu")
    assert attn._fused == {} and attn.out._t_cache == {}
