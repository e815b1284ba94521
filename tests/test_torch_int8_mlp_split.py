"""K2's cluster split on the CPU (`csrc/int8_mlp.cu`): a 64-row tile's h
hidden columns are split over the C blocks of a thread-block cluster, each
block's row maxima are combined by max and the int32 partials of the
second product are added in rank order. Here: the split's plain model
(`int8_mlp_fwd_split_ref` / `int8_mlp_bwd_split_ref`) against the plain
versions and JAX's Pallas kernels interpreted, the tiling rule
(`int8_mlp.mlp_tiling`) at every shape JAX's `supports` admits with
h <= 3072 (against the constants of the CUDA source), and the transposed
weights the model keeps for the kernels (`MLP.k2_weights`).

Tolerances: the split model is bit-identical to the plain versions (the
max of the ranks' maxima is the row's max, and the int32 partials' sum
does not depend on the order); against JAX, K2_RTOL of
`test_torch_int8.py` (XLA's and PyTorch's exp differ in the last bit)."""

import re
from fractions import Fraction

import numpy as np
import pytest

import torch

from agacs_tpu.ops import int8_mlp as jmlp
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.ops import cuda_lib, int8_linear, int8_mlp
from agacs_tpu_torch.train.freeze import apply_freeze

from test_torch_int8 import K2_RTOL, _close, _mlp_inputs, _np, _targs  # tests/ is on sys.path

torch.set_num_threads(1)

SMEM = 232448  # shared memory a block may opt into on the H100 (227 KB)
REGS = 255     # registers a thread may hold
# whisper tiny, base, small: (d, h) -> the cluster size
WHISPER = {(384, 1536): 4, (512, 2048): 8, (768, 3072): 8}


def _constant(name: str) -> int:
    text = (cuda_lib.CSRC / "int8_mlp.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_split_model_matches_plain_and_pallas(which, dtype):
    """n 300 (ragged against the 64-row tile), d 256, h 1024: the split
    model at every cluster size that divides h into 128-column units is
    bit-identical to the plain version, and within K2_RTOL of JAX's kernel
    interpreted at the tiling's own C."""
    p1, p2, x, dy = _mlp_inputs(dtype)
    w1q, s1, b1, w2q, s2, b2 = _targs(p1, p2)
    xt = torch.from_numpy(_np(x)).to(getattr(torch, dtype))
    dyt = torch.from_numpy(_np(dy)).to(xt.dtype)
    if which == "fwd":
        plain = int8_mlp.int8_mlp_fwd_ref(xt, w1q, s1, b1, w2q, s2, b2)
        split = lambda c: int8_mlp.int8_mlp_fwd_split_ref(xt, w1q, s1, b1, w2q, s2, b2, c)  # noqa: E731
        ref = jmlp._fwd_pallas(x, p1, p2, interpret=True)
    else:
        plain = int8_mlp.int8_mlp_bwd_ref(xt, w1q, s1, b1, w2q, s2, dyt)
        split = lambda c: int8_mlp.int8_mlp_bwd_split_ref(xt, w1q, s1, b1, w2q, s2, dyt, c)  # noqa: E731
        ref = jmlp._bwd_pallas(x, p1, p2, dy, interpret=True)
    tiling = int8_mlp.mlp_tiling(256, 1024, which == "bwd")
    assert tiling["C"] == 4 and tiling["units"] == 2
    for c in (1, 2, 4, 8):
        out = split(c)
        assert out.dtype == xt.dtype and out.shape == (300, 256)
        assert torch.equal(out, plain), f"split over {c} ranks"
    _close(split(tiling["C"]).float().numpy(), _np(ref), K2_RTOL[dtype], f"K2 {which} split")


def test_split_model_needs_every_rank():
    """The model's two cluster steps matter: a row max taken over one rank's
    columns alone, or the partials of all ranks but the last, move the
    output (what the kernel's mutants of those steps break)."""
    p1, p2, x, _ = _mlp_inputs("float32", n=70)
    args = _targs(p1, p2)
    xt = torch.from_numpy(_np(x))
    plain = int8_mlp.int8_mlp_fwd_ref(xt, *args)
    g = int8_mlp.gelu(int8_mlp._hidden(xt, *args[:3]))
    qs, sg = int8_mlp._split_hidden(g, 4)
    lone = torch.round(g[:, :256] / int8_mlp._scale(g[:, :256].abs().amax(-1))[:, None])
    assert not torch.equal(lone, qs[0].float())
    short = (int8_mlp._split_sum(qs[:3], args[3][:768]) * sg * args[4] + args[5])
    assert not torch.equal(short, plain)
    full = int8_mlp._split_sum(qs, args[3]) * sg * args[4] + args[5]
    assert torch.equal(full, plain)


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32 (ties to even), normal range."""
    if x == 0:
        return x
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e -= Fraction(2) ** e > x
    m = x * Fraction(2) ** (23 - e)
    q, r = divmod(m.numerator, m.denominator)
    q += 2 * r > m.denominator or (2 * r == m.denominator and q % 2)
    return sign * Fraction(q) / Fraction(2) ** (23 - e)


def test_reciprocal_quantisation_is_the_plain_division():
    """The kernels' `quant_by`, modelled exactly: y = RN(1 / s), q = RN(v y),
    then twice q = RN(q + RN(v - q s) y) (each FMA rounded once). For a
    row's scale s = RN(max(amax, 1e-12) / 127) and |v| <= amax its int8 is
    round(v / s) of the plain version's float32 division: on random values
    and on quotients at and beside every kind of half-integer."""
    rng = np.random.RandomState(0)
    vs, ss, got = [], [], []
    for _ in range(600):
        amax = np.float32(abs(rng.randn()) * 10.0 ** rng.uniform(-6, 3))
        s = _rn32(Fraction(float(max(amax, np.float32(1e-12)))) / 127)
        y = _rn32(1 / s)
        half = np.float32((rng.randint(-127, 127) + 0.5) * float(s))
        cands = [np.float32(rng.uniform(-amax, amax)), half,
                 np.nextafter(half, np.float32(np.inf)), np.nextafter(half, np.float32(-np.inf))]
        for v in cands:
            if abs(v) > amax:
                continue
            fv = Fraction(float(v))
            q = _rn32(fv * y)
            for _ in range(2):
                q = _rn32(q + _rn32(fv - q * s) * y)
            vs.append(float(v))
            ss.append(float(s))
            got.append(round(q))  # Python's round: half to even, as __float2int_rn
    v32 = torch.tensor(vs, dtype=torch.float32)
    s32 = torch.tensor(ss, dtype=torch.float32)
    assert torch.equal(torch.round(v32 / s32).to(torch.int64), torch.tensor(got))


def test_tiling_constants_match_the_source():
    assert int8_mlp.K2_BM == _constant("BM")
    assert int8_mlp.K2_UNIT == _constant("UNIT")
    assert int8_mlp.K2_MAX_UNITS == _constant("MAX_UNITS")
    assert max(int8_mlp.K2_CLUSTERS) == _constant("MAX_C")
    assert int8_mlp.K2_MAX_STAGES == _constant("MAX_STAGES")
    assert int8_mlp.K2_MAX_KB == _constant("MAX_KB")
    assert int8_mlp.K2_PLD == _constant("PLD")
    assert int8_mlp.K2_SLOT == 2 * _constant("BM") * 128
    assert int8_mlp.K2_MAX_LOADS == (2 * _constant("MAX_KB") + _constant("MAX_KB")) * _constant(
        "MAX_UNITS")
    assert int8_mlp.K2_SMALL == (3 * _constant("BM") * 4 + _constant("MAX_C") * 2 * _constant("BM")
                                 * 4 + 2 * _constant("MAX_STAGES") * 8 + int8_mlp.K2_MAX_LOADS * 4)


def _smem(d: int, units: int, stages: int, bwd: bool) -> int:
    """csrc/int8_mlp.cu `smem_bytes`, from its parts: the alignment, the
    ring, x's (and dy's) tiles or the two int32 partial chunks, the int8
    hidden, scales, row maxima, barriers and the table of ring loads."""
    bm = int8_mlp.K2_BM
    areg = max((2 if bwd else 1) * bm * d, 2 * bm * int8_mlp.K2_PLD * 4)
    return 1024 + stages * int8_mlp.K2_SLOT + areg + units * bm * 128 + int8_mlp.K2_SMALL


@pytest.mark.parametrize("bwd", [False, True], ids=["K2f", "K2b"])
@pytest.mark.parametrize("h", range(128, 3073, 128))
def test_tiling_at_every_supported_shape(h, bwd):
    """Every (d, h) that `supports` admits with this h: a taken shape has
    C in (1, 2, 4, 8), h / C a whole number (<= 3) of 128-column units
    (each 2 x m64n64 wgmma N tiles), a ring of 2..8 slots, shared memory
    within 227 KB and accumulators that fit a thread's registers; a shape
    is refused only for d > 1024 or an h that no such C divides."""
    for d in range(128, 6017, 128):
        if not int8_mlp.supports(d, h):
            continue
        t = int8_mlp.mlp_tiling(d, h, bwd)
        units = h // 128
        split = any(units % c == 0 and units // c <= 3 for c in (1, 2, 4, 8))
        if t is None:
            assert d > 1024 or not split, (d, h)
            continue
        assert d <= 1024 and split
        c = t["C"]
        assert c in (1, 2, 4, 8) and h % c == 0 and (h // c) % 128 == 0
        assert t["units"] == h // c // 128 <= 3 and t["BM"] == 64 and t["unit"] == 128
        assert c == min(k for k in (1, 2, 4, 8) if units % k == 0 and units // k <= 3)
        assert 2 <= t["S"] <= 8
        assert t["smem"] == _smem(d, t["units"], t["S"], bwd) <= SMEM
        assert t["S"] == 8 or _smem(d, t["units"], t["S"] + 1, bwd) > SMEM
        # the f32 hidden (32 a unit) and one unit's int32 accumulators (K2b: two)
        assert 32 * t["units"] + 32 * (2 if bwd else 1) <= REGS - 64


def test_whisper_shapes_take_the_kernels():
    for (d, h), c in WHISPER.items():
        for bwd in (False, True):
            t = int8_mlp.mlp_tiling(d, h, bwd)
            assert t is not None and t["C"] == c, (d, h, bwd, t)
    assert int8_mlp.mlp_tiling(768, 3072, False)["S"] == 8
    assert int8_mlp.mlp_tiling(768, 3072, True)["S"] == 6
    assert int8_mlp.mlp_tiling(1024, 4096, False) is None  # whisper-medium: unfused anyway


def test_k2_weights_follow_a_load_in_place():
    """`MLP.k2_weights` (the int8 weights transposed, made once for the
    kernels) is rebuilt when a state-dict load writes the int8 buffers in
    place, and is not part of the state dict."""
    cfg = tw.make_config("test", adapter=True)
    model = tw.Whisper.from_state_dict(
        cfg, tw.init_whisper_params(torch.Generator().manual_seed(0), cfg))
    apply_freeze(model, "adapter")
    model.quantize_frozen_()
    keys = list(model.state_dict())
    mlp = model.encoder.blocks[0].mlp
    w1t, w2t = mlp.k2_weights()
    assert torch.equal(w1t, mlp[0].weight_q.t()) and torch.equal(w2t, mlp[2].weight_q.t())
    assert w1t.is_contiguous() and w2t.is_contiguous()
    assert mlp.k2_weights()[0] is w1t  # kept
    with torch.no_grad():
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        sd["encoder.blocks.0.mlp.0.weight_q"].fill_(1)
        model.load_state_dict(sd)
    w1t_new, w2t_new = mlp.k2_weights()
    assert w1t_new is not w1t and bool((w1t_new == 1).all())
    assert torch.equal(w1t_new, mlp[0].weight_q.t()) and torch.equal(w2t_new, w2t)
    assert list(model.state_dict()) == keys


def test_kernels_take_only_the_kept_transposes():
    """The kernels' operands come one way: `transposed` (kept by
    `MLP.k2_weights`). The CUDA wrappers raise without them, or with
    copies of the wrong shape; on the CPU `wt` is unused."""
    w1q = torch.randint(-127, 128, (128, 256), dtype=torch.int8)
    w2q = torch.randint(-127, 128, (256, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="required"):
        int8_mlp._transposes("int8_mlp_fwd", w1q, w2q, None)
    with pytest.raises(ValueError, match="w1q\\^T"):
        int8_mlp._transposes("int8_mlp_fwd", w1q, w2q, (w1q, w2q))
    wt = int8_linear.transposed(w1q, w2q)
    assert int8_mlp._transposes("int8_mlp_fwd", w1q, w2q, wt) is wt
    x = torch.randn(4, 128)
    s1, b1, s2, b2 = torch.rand(256) / 100, torch.randn(256), torch.rand(128) / 100, torch.randn(128)
    assert torch.equal(int8_mlp.int8_mlp(x, w1q, s1, b1, w2q, s2, b2),
                       int8_mlp.int8_mlp_fwd_ref(x, w1q, s1, b1, w2q, s2, b2))
