"""K3's split over time (the cluster-split decode kernels of
`agacs_tpu_torch/csrc/decode_attn.cu`) on the CPU: `time_splits` at the
recipes' shapes and at edge shapes, and `decode_cache_attention_split_ref`,
the split in plain PyTorch (the global max and sum first, p normalised and
then rounded, the blocks' partial outputs added in rank order), against
JAX's `decode_cache_attention` / `decode_shared_cache_attention` (the
Pallas kernels interpreted) and their `*_ref` oracles, with keys past pos
poisoned on the kernel sides; and `chip_smoke.py`'s mutants against the
sources they edit.

Tolerances, as `test_decode_attention_plain_matches_jax` sets them:
float32 within 1e-5 (summation order); bf16 within 2e-2 (where each side
rounds); int8 against JAX's interpreted kernel within 1e-5 x max |JAX|
(both round q·s_k and p to bf16 the same way) and against JAX's
dequantising oracle within 2e-2."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops import decode_attn as jda
from agacs_tpu_torch.ops import decode_attn

torch.set_num_threads(1)

N, TP, D, H, BEAM = 4, 64, 128, 2, 3  # the shared forms: N // 2 groups of BEAM
SPLITS = (1, 2, 3, 8)
FORMS = ("f32", "bf16", "int8", "shared_bf16", "shared_int8")


def _edges(splits: int) -> list[int]:
    """pos 0, either side of the first chunk edge, and Tp - 1."""
    chunk = -(-TP // splits)
    return sorted({0, chunk - 1, min(chunk, TP - 1), TP - 1})


CASES = [(s, pos) for s in SPLITS for pos in _edges(s)]


@pytest.mark.parametrize("rows, heads, tp, want", [
    (8, 12, 752, 6),    # whisper greedy cross-attention (K3), 8 x 15 s
    (8, 12, 768, 6),    # K3-int8 / K3s-int8: the int8 cross-KV's Tp
    (8, 12, 112, 1),    # greedy self-attention, 100 steps
    (8, 12, 448, 5),    # greedy self-attention over the full decoder context
    (40, 12, 112, 1),   # beam 5 self-attention (K3a): 480 blocks already
    (40, 12, 128, 1),   # K3a-int8's card check, (40, 128)
    (10, 12, 448, 5),   # K3a at the full context, 2 x beam 5
    (8, 4, 752, 8),     # the side ladder's cross-attention (K3@48)
    (8, 4, 112, 1),     # the side ladder's self-attention
    (80, 4, 112, 1),    # the conformer decoder, beam 10: 320 blocks
    (80, 8, 112, 1),    # the transformer LM (K3-f32): 640 blocks
])
def test_time_splits_at_recipe_shapes(rows, heads, tp, want):
    assert decode_attn.time_splits(rows, heads, tp) == want


@pytest.mark.parametrize("groups, tp, want", [
    (8, 752, 3),   # K3s: the beam-5 cross-attention over 8 utterances' cross-KV
    (8, 768, 3),   # K3s-int8
    (1, 752, 8),   # one utterance
    (64, 752, 1),  # a wide batch fills the card unsplit
])
def test_time_splits_shared(groups, tp, want):
    """K3s's blocks carry a group's queries, so it fills the card with
    SHARED_SPLIT_BLOCKS blocks."""
    assert decode_attn.time_splits(groups, 12, tp, decode_attn.SHARED_SPLIT_BLOCKS) == want


@pytest.mark.parametrize("tp", [16, 32, 48, 64, 80, 112, 448, 752, 768, 1504, 8192])
def test_time_splits_edges(tp):
    """S in [1, 8], 1 at Tp <= 64, no more blocks than Tp has MIN_CHUNK
    keys, and at pos = Tp - 1 no block empty, for any rows x heads."""
    for rows in (1, 2, 5, 8, 33, 80):
        for heads in (1, 4, 12):
            s = decode_attn.time_splits(rows, heads, tp)
            assert 1 <= s <= decode_attn.MAX_SPLITS
            if tp <= decode_attn.MIN_CHUNK:
                assert s == 1
            assert s <= -(-tp // decode_attn.MIN_CHUNK)
            chunks = decode_attn.split_chunks(tp, tp - 1, s)
            assert all(z > a for a, z in chunks), (rows, heads, tp, s, chunks)


@pytest.mark.parametrize("splits, pos", CASES)
def test_split_chunks_partition_the_keys(splits, pos):
    """The blocks' keys cover 0..pos once, in rank order, none past pos."""
    chunks = decode_attn.split_chunks(TP, pos, splits)
    assert len(chunks) == splits and chunks[0][0] == 0
    assert all(a1 == z0 for (_, z0), (a1, _) in zip(chunks, chunks[1:]))
    assert chunks[-1][1] == pos + 1
    chunk = -(-TP // splits)
    assert all(z - a <= chunk for a, z in chunks)
    if pos == 0 and splits > 1:
        assert [z - a for a, z in chunks[1:]] == [0] * (splits - 1)  # empty blocks


def test_splits_argument_is_checked():
    assert decode_attn._splits("t", None, 8, 12, 752) == 6
    assert decode_attn._splits("t", 5, 8, 12, 752) == 5
    for bad in (0, 9):
        with pytest.raises(ValueError, match="splits"):
            decode_attn._splits("t", bad, 8, 12, 752)


@functools.lru_cache(maxsize=None)
def _inputs(form: str, pos: int):
    """numpy q, k, v (int8 with scales), the same with keys past pos
    poisoned, and JAX's interpreted kernel and oracle on them."""
    rng = np.random.RandomState(7 + pos + 31 * FORMS.index(form))
    shared = form.startswith("shared")
    caches = N // 2 if shared else N
    nq = caches * BEAM if shared else N
    q = (rng.randn(nq, D) * (D // H) ** -0.5).astype(np.float32)
    k = rng.randn(caches, TP, D).astype(np.float32)
    v = (rng.randn(caches, TP, D) * 0.3).astype(np.float32)
    scales = {}
    if form.endswith("int8"):
        (k, ks), (v, vs) = jw._quantize_kv(jnp.asarray(k)), jw._quantize_kv(jnp.asarray(v))
        k, v = np.array(k), np.array(v)
        scales = {"k_scale": np.array(ks), "v_scale": np.array(vs)}
        poison = 127
    else:
        poison = 1e9
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[:, pos + 1:] = poison
    v_bad[:, pos + 1:] = poison
    dt = jnp.bfloat16 if form.endswith("bf16") else None

    def j(x):
        x = jnp.asarray(x)
        return x.astype(dt) if dt is not None and x.dtype == jnp.float32 else x

    js = {n: jnp.asarray(x) for n, x in scales.items()}
    if shared:
        kernel = jda.decode_shared_cache_attention(j(q), j(k_bad), j(v_bad), pos, H, BEAM,
                                                   interpret=True, **js)
        ref = jda.decode_shared_cache_attention_ref(j(q), j(k), j(v), pos, H, BEAM, **js)
    else:
        kernel = jda.decode_cache_attention(j(q), j(k_bad), j(v_bad), pos, H, interpret=True,
                                            **js)
        ref = jda.decode_cache_attention_ref(j(q), j(k), j(v), pos, H, **js)
    as_np = [np.asarray(x.astype(jnp.float32)) for x in (kernel, ref)]
    return (q, k_bad, v_bad, scales), tuple(as_np)


def _torch(x: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if bf16 and t.dtype == torch.float32 else t


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("splits, pos", CASES)
def test_split_ref_matches_jax(form, splits, pos):
    (q, k_bad, v_bad, scales), (kernel, ref) = _inputs(form, pos)
    bf16 = form.endswith("bf16")
    out = decode_attn.decode_cache_attention_split_ref(
        _torch(q, bf16), _torch(k_bad, bf16), _torch(v_bad, bf16), pos, H, splits,
        beam=BEAM if form.startswith("shared") else None,
        **{n: torch.from_numpy(x) for n, x in scales.items()})
    assert out.shape == q.shape and out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    out = out.float().numpy()
    if form == "f32":
        np.testing.assert_allclose(out, kernel, atol=1e-5)
        np.testing.assert_allclose(out, ref, atol=1e-5)
    elif bf16:
        np.testing.assert_allclose(out, kernel, atol=2e-2)
        np.testing.assert_allclose(out, ref, atol=2e-2)
    else:  # int8: the kernels' folding, then JAX's dequantising oracle
        np.testing.assert_allclose(out, kernel, atol=1e-5 * np.abs(kernel).max())
        np.testing.assert_allclose(out, ref, atol=2e-2)


@pytest.mark.parametrize("form", ["f32", "int8", "shared_int8"])
@pytest.mark.parametrize("pos", [0, 21, 63])
def test_split_ref_is_the_plain_version_at_any_split(form, pos):
    """The split moves only float32 summation order: at every S the split
    reference equals the port's unsplit plain version (what a CPU tensor
    runs) within 1e-6 x max."""
    (q, k_bad, v_bad, scales), _ = _inputs(form, pos)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k_bad, v_bad))
    sc = {n: torch.from_numpy(x) for n, x in scales.items()}
    if form.startswith("shared"):
        plain = decode_attn.decode_shared_cache_attention(qt, kt, vt, pos, H, BEAM, **sc)
    else:
        plain = decode_attn.decode_cache_attention(qt, kt, vt, pos, H, **sc)
    for s in SPLITS:
        out = decode_attn.decode_cache_attention_split_ref(
            qt, kt, vt, pos, H, s, beam=BEAM if form.startswith("shared") else None, **sc)
        np.testing.assert_allclose(out.numpy(), plain.numpy(),
                                   atol=1e-6 * plain.abs().max().item())


@pytest.mark.parametrize("name", list(chip_smoke.MUTANTS))
def test_chip_smoke_mutants_match_their_sources(name):
    """Every edit of `chip_smoke.py --mutants` is in the source it mutates
    (applied in order, as the mutant run applies them), and every check it
    names is one the run knows."""
    fname, edits, checks = chip_smoke.MUTANTS[name]
    with open(f"{chip_smoke.ROOT}/agacs_tpu_torch/csrc/{fname}") as f:
        text = f.read()
    for old, new in edits:
        assert old in text, (name, old)
        text = text.replace(old, new, 1)
    assert set(checks) <= set(chip_smoke.KERNEL_CHECKS) | {"p15"}
