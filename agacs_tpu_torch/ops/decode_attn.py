"""Decode-step cache attention (counterpart of `agacs_tpu/ops/decode_attn.py`
`decode_cache_attention` and `decode_shared_cache_attention`; kernel K3
and its variants).

One query token per row attends over a (Tp, d) K/V cache, keys 0..pos.
q is pre-scaled by d_head**-0.5; caches are raw, with Tp % TIME_ALIGN == 0
(`init_self_kv_cache` and `precompute_cross_kv` pad). The kernels
(`csrc/decode_attn.cu`) read only keys t <= pos: on the TPU the masked
keys get weight exp(-1e30 - m) == 0 exactly, so skipping them changes
nothing but the bytes read.

  decode_cache_attention          K3: row n over its own cache row n;
                                  K3a (anc_local, beam j > 1): row n of
                                  group g = n // j reads position t from
                                  the physical row g*j + anc_local[n, t];
                                  PE (q_cs, k_cs, gate): scores
                                  (1 - g_h)·q.k + g_h·q_cs.k_cs per head h
                                  over a third cache (K3-PE, K3a-PE);
                                  int8 (k_scale, v_scale): int8 caches with
                                  per-channel scales (K3-int8, K3a-int8);
                                  float32 q and caches: K3-f32 (plain rows
                                  only; the transformer LM's self-attention);
                                  d_head 48: K3 at the side ladder's head
                                  width (plain bf16 rows only); plain bf16
                                  and float32 rows at any d_head <= 256
                                  that is a multiple of 4 (the conformer
                                  decoder's and the LM's, `ROWS_D_HEAD_MAX`)
  decode_shared_cache_attention   K3s: the j beam queries of group g over
                                  ONE shared (Tp, d) cache (cross-KV);
                                  int8 caches with scales (K3s-int8)

The int8 kernels fold the scales as the TPU kernel does: q·s_k is formed
in float32 and rounded to bf16 before the dot (int8 -> bf16 is exact), p
is normalised and then rounded to bf16, and s_v multiplies the float32
value sum. `decode_cache_attention_int8_ref` /
`decode_shared_cache_attention_int8_ref` compute exactly that; JAX's own
oracle, which dequantises the caches to the query's dtype first, is
`decode_cache_attention_ref(..., k_scale=, v_scale=)`.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises): there is no fallback.

On the card each (head, row) is split over time: S blocks of one
thread-block cluster take ceil(Tp / S) keys each and combine at the
plain version's rounding point (the global max and sum first, then
bf16(exp(s - m) / l), then the partial outputs in rank order).
`time_splits` picks S from the shapes alone, never from pos;
`decode_cache_attention_split_ref` is that split in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib

TIME_ALIGN = 16  # cache time axis padding (the JAX bf16 sublane tile)
TIME_ALIGN_I8 = 32  # int8 cross-KV caches (the JAX int8 sublane tile)
D_HEAD = 64
# the ladder side network's head width (n_dim 192 / 4 heads): K3's plain
# bf16 rows are also built at it; every other form stays at D_HEAD
D_HEAD_SIDE = 48
# plain rows (bf16 K3, float32 K3-f32) at any other head width up to this,
# a multiple of ROWS_D_HEAD_ALIGN (the conformer decoder's and the LM's
# widths: 36 and 44 in the public small conformers, 128 in the XLarge), on
# the runtime-width entry (`_rows_at`); the whisper-only forms (ancestry,
# PE, int8, K3s) stay at D_HEAD. float32 at D_HEAD and bf16 at D_HEAD_SIDE
# keep their fixed instances: the runtime entry trails them by ~15% at the
# LM's float32 shape and ~4% at the ladder's self-attention (PERF.md §6)
ROWS_D_HEAD_MAX = 256
ROWS_D_HEAD_ALIGN = 4
MAX_KEYS = 8192  # K3 keeps a block's f32 scores in shared memory
MAX_ANC_KEYS = 4096  # K3a also keeps each key's physical row there
MAX_BEAM = 16  # K3s: a lane keeps one accumulator per query of the group
# K3s's acceptance rule: j x (pos + 1 + 16 x 64) f32 within 200 KB. The
# kernel's own shared memory (j x (its keys + S x 66) f32 beside a ring of
# tiles that shrinks to fit) stays inside the card's 227 KB for any call
# the rule admits.
SHARED_SMEM_COLS = 16 * D_HEAD
MAX_SHARED_SMEM = 200 * 1024
# The split over time (`time_splits`): the H100 SXM's streaming
# multiprocessors, the largest portable cluster, the fewest keys worth a
# block, and the blocks a launch should reach (four an SM), as tuned on
# the card (`chip_smoke.py --splits`).
SMS = 132
MAX_SPLITS = 8
MIN_CHUNK = 80
SPLIT_BLOCKS = 4 * SMS
# K3s's blocks each carry the group's j queries: two an SM
SHARED_SPLIT_BLOCKS = 2 * SMS
# kernel launches since the last reset (chip_smoke.py reads them)
LAUNCHES = 0  # K3
ANC_LAUNCHES = 0  # K3a
PE_LAUNCHES = 0  # K3-PE
ANC_PE_LAUNCHES = 0  # K3a-PE
I8_LAUNCHES = 0  # K3-int8
ANC_I8_LAUNCHES = 0  # K3a-int8
SHARED_LAUNCHES = 0  # K3s
SHARED_I8_LAUNCHES = 0  # K3s-int8
F32_LAUNCHES = 0  # K3-f32
D48_LAUNCHES = 0  # K3 at d_head 48
# (ancestry, PE, int8) -> the counter of that kernel
_COUNTER = {(False, False, False): "LAUNCHES", (True, False, False): "ANC_LAUNCHES",
            (False, True, False): "PE_LAUNCHES", (True, True, False): "ANC_PE_LAUNCHES",
            (False, False, True): "I8_LAUNCHES", (True, False, True): "ANC_I8_LAUNCHES"}


def pad_time(t: int, align: int = TIME_ALIGN) -> int:
    return -(-t // align) * align


def time_splits(rows: int, heads: int, tp: int, blocks: int = SPLIT_BLOCKS) -> int:
    """S, the blocks that split one (head, row)'s keys (a cluster): enough
    for the launch to reach `blocks` blocks (SPLIT_BLOCKS for K3's rows,
    SHARED_SPLIT_BLOCKS for K3s's groups), at most MAX_SPLITS, and
    chunks of at least MIN_CHUNK keys of the padded Tp (so S = 1 below
    2 x MIN_CHUNK: a short cache gains less from the split than its
    cluster barriers cost). Shapes only, never pos, so every step of a
    decode loop launches one grid. `rows`: the query rows (K3) or the
    groups (K3s)."""
    return max(1, min(MAX_SPLITS, tp // MIN_CHUNK, -(-blocks // max(1, heads * rows))))


def split_chunks(tp: int, pos: int, splits: int) -> list[tuple[int, int]]:
    """The keys [start, stop) of each block of the split, in rank order:
    ceil(Tp / S) a block, cut at pos (a block past pos takes none)."""
    chunk = -(-tp // splits)
    return [(min(b * chunk, pos + 1), min((b + 1) * chunk, pos + 1)) for b in range(splits)]


def dequantize_kv(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 cache x per-channel scale, in float32, then `dtype` (JAX's
    oracle form, `decode_attn.py:762-768`)."""
    return (x.float() * scale.float()).to(dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, n_head: int) -> torch.Tensor:
    """(N, d) q . (N, Tp, d) k per head -> (N, Tp, h) float32, the product
    in the cache dtype (JAX's oracle einsum)."""
    n, tp, d = k.shape
    dh = d // n_head
    return torch.einsum("nhc,nthc->nth", q.reshape(n, n_head, dh).to(k.dtype),
                        k.reshape(n, tp, n_head, dh)).float()


def _masked_softmax(s: torch.Tensor, pos: int, axis: int) -> torch.Tensor:
    t_ids = torch.arange(s.shape[axis], device=s.device).reshape(
        [-1 if i == axis else 1 for i in range(s.dim())])
    return torch.softmax(torch.where(t_ids <= pos, s, torch.full_like(s, -1.0e30)), dim=axis)


def decode_cache_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    q_cs: torch.Tensor | None = None, k_cs: torch.Tensor | None = None,
    gate: torch.Tensor | None = None, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version (JAX `decode_cache_attention_ref`, plain rows): scores
    in the cache dtype, with PE mixed (1 - g)·s + g·s_cs in float32 per
    head; keys past pos masked with -1e30, float32 softmax, weights cast
    back for the value sum. With `k_scale`/`v_scale` the int8 caches are
    first dequantised to q's dtype (JAX's oracle, not the kernel's
    folding: that is `decode_cache_attention_int8_ref`)."""
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale, q.dtype), dequantize_kv(v, v_scale, q.dtype)
    n, tp, d = k.shape
    s = _scores(q, k, n_head)
    if q_cs is not None:
        g = gate.float()
        s = (1.0 - g) * s + g * _scores(q_cs, k_cs, n_head)
    p = _masked_softmax(s, pos, 1)
    o = torch.einsum("nth,nthc->nhc", p.to(v.dtype), v.reshape(n, tp, n_head, -1))
    return o.reshape(n, d).to(q.dtype)


def decode_cache_attention_int8_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    k_scale: torch.Tensor, v_scale: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K3-int8 (the TPU kernel's folding, `_make_kernel`
    quant, `decode_attn.py:185-194`, `:257-263`): bf16(q·s_k) dotted with
    the int8 keys in float32, float32 softmax, p rounded to bf16 after
    normalising, the float32 value sum times s_v, then q's dtype."""
    n, tp, d = k.shape
    qs = (q.float() * k_scale.float()).to(torch.bfloat16).float()
    s = _scores(qs, k.float(), n_head)
    p = _masked_softmax(s, pos, 1).to(torch.bfloat16).float()
    o = torch.einsum("nth,nthc->nhc", p, v.float().reshape(n, tp, n_head, -1))
    return (o.reshape(n, d) * v_scale.float()).to(q.dtype)


def gather_ancestry(x: torch.Tensor, anc_local: torch.Tensor, beam: int) -> torch.Tensor:
    """(N, Tp, d) cache -> the (N, Tp, d) cache each row reads through the
    ancestry map: out[n, t] = x[(n // beam) * beam + anc_local[n, t], t],
    the map clamped into [0, beam) as the kernel clamps it."""
    n, tp, _ = x.shape
    base = torch.arange(n, device=x.device) // beam * beam
    rows = base[:, None] + anc_local.long().clamp(0, beam - 1)
    return x[rows, torch.arange(tp, device=x.device)[None, :]]


def decode_cache_attention_anc_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    anc_local: torch.Tensor, beam: int, q_cs: torch.Tensor | None = None,
    k_cs: torch.Tensor | None = None, gate: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of K3a and K3a-PE (JAX `decode_cache_attention_ref`
    with `anc_local`): the group's rows of every cache (k_cs too) gathered
    through the map, then the plain-row math. JAX resolves the map with a
    one-hot mix 1.0*x + 0.0*y, which is exact on finite caches, so the
    gather gives its numbers."""
    if k_cs is not None:
        k_cs = gather_ancestry(k_cs, anc_local, beam)
    return decode_cache_attention_ref(q, gather_ancestry(k, anc_local, beam),
                                      gather_ancestry(v, anc_local, beam), pos, n_head,
                                      q_cs, k_cs, gate)


def decode_shared_cache_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    beam: int, k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of K3s (JAX `decode_shared_cache_attention_ref`):
    (G*beam, d) group-major queries over (G, Tp, d) caches; int8 caches
    dequantised to q's dtype first, as JAX's oracle does."""
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale, q.dtype), dequantize_kv(v, v_scale, q.dtype)
    g, tp, d = k.shape
    dh = d // n_head
    s = torch.einsum(
        "gjhc,gthc->gjth", q.reshape(g, beam, n_head, dh).to(k.dtype),
        k.reshape(g, tp, n_head, dh),
    ).float()
    p = _masked_softmax(s, pos, 2)
    o = torch.einsum("gjth,gthc->gjhc", p.to(v.dtype), v.reshape(g, tp, n_head, dh))
    return o.reshape(g * beam, d).to(q.dtype)


def decode_shared_cache_attention_int8_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    beam: int, k_scale: torch.Tensor, v_scale: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K3s-int8 (`_make_kernel_shared` quant,
    `decode_attn.py:863-895`): the folding of
    `decode_cache_attention_int8_ref` with the group's j queries over one
    shared cache."""
    g, tp, d = k.shape
    dh = d // n_head
    qs = (q.float() * k_scale.float()).to(torch.bfloat16).float()
    s = torch.einsum("gjhc,gthc->gjth", qs.reshape(g, beam, n_head, dh),
                     k.float().reshape(g, tp, n_head, dh))
    p = _masked_softmax(s, pos, 2).to(torch.bfloat16).float()
    o = torch.einsum("gjth,gthc->gjhc", p, v.float().reshape(g, tp, n_head, dh))
    return (o.reshape(g * beam, d) * v_scale.float()).to(q.dtype)


def decode_cache_attention_split_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    splits: int, *, beam: int | None = None, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernels' split over time in plain PyTorch (for tests): `splits`
    blocks take the keys of `split_chunks`. Scores in float32 (q, or
    bf16(q·s_k) against int8 caches, dotted with the float32 keys); the
    global max m over all keys 0..pos; the global sum l, the blocks' sums
    of exp(s - m) added in rank order; p = exp(s - m) / l, then bf16 unless
    the caches are float32; each block's float32 partial output over its
    own keys, the partials added in rank order, times s_v for int8; q's
    dtype. `beam`: the shared form, (G*beam, d) queries over (G, Tp, d)."""
    g, tp, d = k.shape
    j, dh = beam or 1, d // n_head
    qf = q.float()
    if k_scale is not None:
        qf = (qf * k_scale.float()).to(torch.bfloat16).float()
    s = torch.einsum("gjhc,gthc->gjht", qf.reshape(g, j, n_head, dh),
                     k.float().reshape(g, tp, n_head, dh))[..., : pos + 1]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    chunks = split_chunks(tp, pos, splits)
    l = torch.zeros_like(e[..., :1])
    for a, z in chunks:
        l = l + e[..., a:z].sum(-1, keepdim=True)
    p = e / l
    if k.dtype != torch.float32:
        p = p.to(torch.bfloat16).float()
    vh = v.float().reshape(g, tp, n_head, dh)
    o = torch.zeros(g, j, n_head, dh, dtype=torch.float32, device=q.device)
    for a, z in chunks:
        o = o + torch.einsum("gjht,gthc->gjhc", p[..., a:z], vh[:, a:z])
    o = o.reshape(g * j, d)
    if v_scale is not None:
        o = o * v_scale.float()
    return o.to(q.dtype)


def decode_cache_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int, *,
    anc_local: torch.Tensor | None = None, beam: int = 1,
    q_cs: torch.Tensor | None = None, k_cs: torch.Tensor | None = None,
    gate: torch.Tensor | None = None, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of the kernel `decode_cache_attention` launches for
    these arguments (what it runs for a CPU tensor); K3a-int8's is K3-int8's
    over the caches gathered through the map."""
    anc = anc_local is not None and beam > 1
    if k_scale is not None:
        if anc:
            k, v = gather_ancestry(k, anc_local, beam), gather_ancestry(v, anc_local, beam)
        return decode_cache_attention_int8_ref(q, k, v, pos, n_head, k_scale, v_scale)
    if anc:
        return decode_cache_attention_anc_ref(q, k, v, pos, n_head, anc_local, beam,
                                              q_cs, k_cs, gate)
    return decode_cache_attention_ref(q, k, v, pos, n_head, q_cs, k_cs, gate)


def decode_shared_cache_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    beam: int, *, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of K3s or K3s-int8 (what
    `decode_shared_cache_attention` runs for a CPU tensor)."""
    if k_scale is not None:
        return decode_shared_cache_attention_int8_ref(q, k, v, pos, n_head, beam,
                                                      k_scale, v_scale)
    return decode_shared_cache_attention_ref(q, k, v, pos, n_head, beam)


def _check_kernel_inputs(what: str, n_head: int, d: int, tensors,
                         cache_dtype: torch.dtype = torch.bfloat16,
                         query_dtype: torch.dtype = torch.bfloat16,
                         d_head: int = D_HEAD) -> None:
    """What every decode kernel takes: bf16 queries with bf16 or int8
    caches, or float32 queries with float32 caches (K3-f32); f32 scales and
    gate, one device, contiguous, 16-byte aligned, d_head 64 (48 for K3's
    plain bf16 rows at the side ladder's width)."""
    dev = tensors[0][1].device
    for name, x in tensors:
        want = {"k": cache_dtype, "v": cache_dtype, "gate": torch.float32,
                "k_scale": torch.float32, "v_scale": torch.float32}.get(name, query_dtype)
        if x.dtype != want or x.device != dev:
            raise ValueError(f"{what}: {name} is {x.dtype} on {x.device}; the "
                             f"kernel takes {want} on {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if d != n_head * d_head:
        raise ValueError(f"{what}: d {d} != {n_head} heads x {d_head}; the kernel "
                         f"takes d_head = {d_head}")


def _check_scales(what: str, k: torch.Tensor, k_scale, v_scale) -> None:
    """int8 caches: int8 k/v, (d,) scales, Tp a multiple of TIME_ALIGN_I8."""
    tp, d = k.shape[1:]
    if k.dtype != torch.int8 or k_scale.shape != (d,) or v_scale.shape != (d,):
        raise ValueError(f"{what}: int8 caches take (d,) scales; k is {k.dtype}, "
                         f"scales {tuple(k_scale.shape)} {tuple(v_scale.shape)}")
    if tp % TIME_ALIGN_I8:
        raise ValueError(f"{what}: Tp {tp} is not a multiple of {TIME_ALIGN_I8}")


def _device_path(what: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); anything else raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return True


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _splits(what: str, splits: int | None, rows: int, heads: int, tp: int,
            blocks: int = SPLIT_BLOCKS) -> int:
    """`splits` if given (1..MAX_SPLITS), else `time_splits`'s choice."""
    if splits is None:
        return time_splits(rows, heads, tp, blocks)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"{what}: splits {splits} outside [1, {MAX_SPLITS}]")
    return splits


def decode_cache_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: int,
    n_head: int,
    *,
    anc_local: torch.Tensor | None = None,
    beam: int = 1,
    q_cs: torch.Tensor | None = None,
    k_cs: torch.Tensor | None = None,
    gate: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """One decode step of masked cache attention: (N, d) output.

    q (N, d); k/v (N, Tp, d); pos a Python int (keys t > pos masked).
    With `anc_local` (N, Tp) int32 in [0, beam) and beam > 1, row n reads
    position t from row (n // beam) * beam + anc_local[n, t] (K3a; a value
    outside [0, beam) is clamped into it, so no row reads outside its
    group); otherwise each row reads its own cache row (K3). PE: q_cs (N,
    d), k_cs (N, Tp, d) read through the same map, gate (h,) float32
    post-sigmoid. int8: k/v int8 with (d,) float32 k_scale/v_scale and
    Tp % TIME_ALIGN_I8 == 0. PE and int8 together raise, as JAX asserts.
    float32 q, k and v (K3-f32) take plain rows only: with a map, PE or
    scales they raise; any other cache dtype raises too. d_head 48 (d ==
    48 x n_head) takes plain bf16 rows only, as the side ladder launches
    it; anything else at that width raises. Plain bf16 and float32 rows
    take any d_head up to ROWS_D_HEAD_MAX that is a multiple of
    ROWS_D_HEAD_ALIGN; the other forms take D_HEAD only. `splits` (card
    only): the blocks a (head, row) is split over, instead of
    `time_splits`'s."""
    pe, quant = q_cs is not None, k_scale is not None
    if pe and quant:
        raise ValueError("decode_cache_attention: int8 caches are unsupported "
                         "for the PE variant")
    n, tp, d = k.shape
    if not 0 <= pos < tp:
        raise ValueError(f"decode_cache_attention: pos {pos} outside [0, {tp})")
    anc = anc_local is not None and beam > 1
    if anc and (n % beam or anc_local.shape != (n, tp)):
        raise ValueError(f"decode_cache_attention: {n} rows in groups of {beam}, "
                         f"anc_local {tuple(anc_local.shape)} (want {(n, tp)})")
    if not _device_path("decode_cache_attention", q):
        return decode_cache_attention_plain(q, k, v, pos, n_head, anc_local=anc_local,
                                            beam=beam, q_cs=q_cs, k_cs=k_cs, gate=gate,
                                            k_scale=k_scale, v_scale=v_scale)
    if q.shape != (n, d) or v.shape != k.shape:
        raise ValueError(f"decode_cache_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    ins = [("q", q), ("k", k), ("v", v)]
    s = _splits("decode_cache_attention", splits, n, n_head, tp)
    if d == n_head * D_HEAD_SIDE:
        if anc or pe or quant or k.dtype != torch.bfloat16:
            raise ValueError("decode_cache_attention: d_head 48 takes plain bf16 rows "
                             "only (no ancestry map, PE, scales or float32)")
        return _d48_rows(q, k, v, pos, n_head, s)
    if k.dtype == torch.float32:
        if anc or pe or quant:
            raise ValueError("decode_cache_attention: float32 caches take plain rows "
                             "only (no ancestry map, PE or scales)")
        if d == n_head * D_HEAD:
            return _f32_rows(q, k, v, pos, n_head, s)
        return _rows_at(q, k, v, pos, n_head, s)
    if d != n_head * D_HEAD and not (anc or pe or quant):
        return _rows_at(q, k, v, pos, n_head, s)
    if pe:
        if q_cs.shape != q.shape or k_cs.shape != k.shape or gate.shape != (n_head,):
            raise ValueError(f"decode_cache_attention: q_cs {tuple(q_cs.shape)}, k_cs "
                             f"{tuple(k_cs.shape)}, gate {tuple(gate.shape)}")
        ins += [("q_cs", q_cs), ("k_cs", k_cs), ("gate", gate)]
    if quant:
        _check_scales("decode_cache_attention", k, k_scale, v_scale)
        ins += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check_kernel_inputs("decode_cache_attention", n_head, d, ins,
                         torch.int8 if quant else torch.bfloat16)
    max_keys = MAX_ANC_KEYS if anc else MAX_KEYS
    if pos + 1 > max_keys:
        raise ValueError(f"decode_cache_attention: pos + 1 = {pos + 1} keys "
                         f"exceed the kernel's {max_keys}")
    if anc and (anc_local.dtype != torch.int32 or anc_local.device != q.device
                or not anc_local.is_contiguous()):
        raise ValueError(f"decode_cache_attention: anc_local is {anc_local.dtype} on "
                         f"{anc_local.device}; the kernel takes contiguous int32 "
                         f"on {q.device}")
    o = torch.empty_like(q)
    fn = cuda_lib.load(
        "decode_attn", "decode_attn_fwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(anc_local if anc else None),
            _ptr(q_cs), _ptr(k_cs), _ptr(gate), _ptr(k_scale), _ptr(v_scale),
            o.data_ptr(), n, tp, n_head, pos, beam if anc else 1, s,
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "decode_attn_fwd")
    counter = _COUNTER[(anc, pe, quant)]
    globals()[counter] += 1
    return o


def _f32_rows(q, k, v, pos: int, n_head: int, splits: int) -> torch.Tensor:
    """Launch K3-f32 (checked by the caller's shape tests)."""
    n, tp, d = k.shape
    _check_kernel_inputs("decode_cache_attention", n_head, d, [("q", q), ("k", k), ("v", v)],
                         torch.float32, torch.float32)
    if pos + 1 > MAX_KEYS:
        raise ValueError(f"decode_cache_attention: pos + 1 = {pos + 1} keys exceed the "
                         f"kernel's {MAX_KEYS}")
    o = torch.empty_like(q)
    fn = cuda_lib.load("decode_attn", "decode_attn_f32_fwd",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), n, tp, n_head, pos,
            splits, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "decode_attn_f32_fwd")
    global F32_LAUNCHES
    F32_LAUNCHES += 1
    return o


def rows_width_ok(d: int, n_head: int) -> bool:
    """Do the plain rows take this width (d = n_head x d_head, d_head <=
    ROWS_D_HEAD_MAX a multiple of ROWS_D_HEAD_ALIGN)?"""
    dh = d // n_head
    return d % n_head == 0 and 0 < dh <= ROWS_D_HEAD_MAX and dh % ROWS_D_HEAD_ALIGN == 0


def _rows_at(q, k, v, pos: int, n_head: int, splits: int) -> torch.Tensor:
    """Launch K3's or K3-f32's plain rows at a head width other than D_HEAD
    (checked by the caller's shape tests)."""
    n, tp, d = k.shape
    if not rows_width_ok(d, n_head):
        raise ValueError(f"decode_cache_attention: d {d} in {n_head} heads; plain rows "
                         f"take d_head <= {ROWS_D_HEAD_MAX}, a multiple of "
                         f"{ROWS_D_HEAD_ALIGN}, and every other form d_head {D_HEAD}")
    f32 = k.dtype == torch.float32
    _check_kernel_inputs("decode_cache_attention", n_head, d, [("q", q), ("k", k), ("v", v)],
                         k.dtype, k.dtype, d_head=d // n_head)
    if pos + 1 > MAX_KEYS:
        raise ValueError(f"decode_cache_attention: pos + 1 = {pos + 1} keys exceed the "
                         f"kernel's {MAX_KEYS}")
    o = torch.empty_like(q)
    fn = cuda_lib.load("decode_attn", "decode_attn_rows_fwd",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), int(f32), n, tp, n_head,
            d // n_head, pos, splits, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "decode_attn_rows_fwd")
    global LAUNCHES, F32_LAUNCHES
    if f32:
        F32_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return o


def _d48_rows(q, k, v, pos: int, n_head: int, splits: int) -> torch.Tensor:
    """Launch K3 at d_head 48 (checked by the caller's shape tests)."""
    n, tp, d = k.shape
    _check_kernel_inputs("decode_cache_attention", n_head, d, [("q", q), ("k", k), ("v", v)],
                         d_head=D_HEAD_SIDE)
    if pos + 1 > MAX_KEYS:
        raise ValueError(f"decode_cache_attention: pos + 1 = {pos + 1} keys exceed the "
                         f"kernel's {MAX_KEYS}")
    o = torch.empty_like(q)
    fn = cuda_lib.load("decode_attn", "decode_attn_d48_fwd",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), n, tp, n_head, pos,
            splits, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "decode_attn_d48_fwd")
    global D48_LAUNCHES
    D48_LAUNCHES += 1
    return o


def decode_shared_cache_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: int,
    n_head: int,
    beam: int,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Grouped masked cache attention: (G*beam, d) queries over (G, Tp, d)
    shared caches -> (G*beam, d). Rows are group-major (row g*beam + i is
    utterance g's beam slot i); keys t > pos are masked (pass T_audio - 1
    to mask the time padding). int8 caches: (d,) float32 k_scale/v_scale
    (K3s-int8). `splits` (card only): the blocks a (head, group) is split
    over, instead of `time_splits`'s."""
    quant = k_scale is not None
    g, tp, d = k.shape
    if not 0 <= pos < tp:
        raise ValueError(f"decode_shared_cache_attention: pos {pos} outside [0, {tp})")
    if q.shape != (g * beam, d) or v.shape != k.shape:
        raise ValueError(f"decode_shared_cache_attention: q {tuple(q.shape)} for "
                         f"{g} groups of {beam}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not _device_path("decode_shared_cache_attention", q):
        return decode_shared_cache_attention_plain(q, k, v, pos, n_head, beam,
                                                   k_scale=k_scale, v_scale=v_scale)
    ins = [("q", q), ("k", k), ("v", v)]
    if quant:
        _check_scales("decode_shared_cache_attention", k, k_scale, v_scale)
        ins += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check_kernel_inputs("decode_shared_cache_attention", n_head, d, ins,
                         torch.int8 if quant else torch.bfloat16)
    s = _splits("decode_shared_cache_attention", splits, g, n_head, tp, SHARED_SPLIT_BLOCKS)
    smem = beam * (pos + 1 + SHARED_SMEM_COLS) * 4
    if not 1 <= beam <= MAX_BEAM or smem > MAX_SHARED_SMEM:
        raise ValueError(f"decode_shared_cache_attention: beam {beam} x {pos + 1} keys "
                         f"exceed the kernel's {MAX_BEAM} queries or "
                         f"{MAX_SHARED_SMEM} B of shared memory")
    o = torch.empty_like(q)
    fn = cuda_lib.load(
        "decode_attn", "decode_attn_shared_fwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            o.data_ptr(), g, tp, n_head, pos, beam, s,
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "decode_attn_shared_fwd")
    global SHARED_LAUNCHES, SHARED_I8_LAUNCHES
    if quant:
        SHARED_I8_LAUNCHES += 1
    else:
        SHARED_LAUNCHES += 1
    return o
