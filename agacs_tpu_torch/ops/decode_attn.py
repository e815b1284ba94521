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
                                  every form at any d_head (`envelope`
                                  says which kernel takes a call)
  decode_shared_cache_attention   K3s: the j beam queries of group g over
                                  ONE shared (Tp, d) cache (cross-KV), in
                                  tiles of QUERY_TILE queries; int8 caches
                                  with scales (K3s-int8)

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

The routes (`envelope`, from the shapes alone): a block whose keys fit
one table (SHORT_KEYS, SHORT_MAP_KEYS through a map) takes the short
route above, on the fixed d_head-64 instances (K3s on the tensor cores
up to its shared memory), the side ladder's 48, the plain rows' runtime
width (`decode_attn_rows_fwd`) or the other forms'
(`decode_attn_forms_fwd`: widths up to 256, a multiple of 8, or 16 for
int8). Everything else takes the long route
(`decode_attn_long_fwd`, the counterpart of JAX's `_call_chunked`): each
block walks its keys in passes of PASS_KEYS with JAX's online-softmax
carry (p rounded to the cache's dtype un-normalised, one division at the
end), heads streamed in HEAD_PIECE-wide pieces, any d_head, any form, and
K3s's groups one query a block; `decode_cache_attention_chunked_ref` is
it in plain PyTorch, and what a CPU tensor runs where the card would
walk a block's keys in more than one pass.
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib

TIME_ALIGN = 16  # cache time axis padding (the JAX bf16 sublane tile)
TIME_ALIGN_I8 = 32  # int8 cross-KV caches (the JAX int8 sublane tile)
D_HEAD = 64
# the ladder side network's head width (n_dim 192 / 4 heads): K3's plain
# bf16 rows have a fixed instance at it
D_HEAD_SIDE = 48
# plain rows (bf16 K3, float32 K3-f32) at any other head width up to this,
# a multiple of ROWS_D_HEAD_ALIGN (the conformer decoder's and the LM's
# widths: 36 and 44 in the public small conformers, 128 in the XLarge), on
# the runtime-width entry (`decode_attn_rows_fwd`). float32 at D_HEAD and
# bf16 at D_HEAD_SIDE keep their fixed instances: the runtime entry trails
# them by ~15% at the LM's float32 shape and ~4% at the ladder's
# self-attention (PERF.md §6)
ROWS_D_HEAD_MAX = 256
ROWS_D_HEAD_ALIGN = 4
# the other forms' runtime-width entry (`decode_attn_forms_fwd`): d_head up
# to ROWS_D_HEAD_MAX, a multiple of a 16-byte piece's channels (the long
# route, which takes them too, read 1.8-2.5x it in one pass at (40, 112,
# 768), 6 heads of 128: `chip_smoke.py` phase 3w, PERF.md)
FORMS_ALIGN = {torch.bfloat16: 8, torch.int8: 16}
# The short route keeps a block's keys in one table of float32 scores:
# SHORT_KEYS of them, or SHORT_MAP_KEYS where each key's physical row
# (the ancestry map) sits beside its score. A block with more keys takes
# the long route, which walks them in passes of PASS_KEYS (its score
# table; a multiple of 64 up to the source's MAX_PASS): it read 2x (bf16)
# and 2.8x (float32) slower than the short route at 1032 and 1180 keys a
# block (`chip_smoke.py` phase 3L, PERF.md). HEAD_PIECE: the channels of
# the long route's head piece (the source's PIECE).
SHORT_KEYS = 8192
SHORT_MAP_KEYS = 4096
PASS_KEYS = 4096
HEAD_PIECE = 256
# K3s takes a group's j queries in the fewest tiles of at most QUERY_TILE
# (mma.sync's rows), their sizes balanced (`query_tiles`), at d_head 64 to
# 256 a multiple of 64 (`SHARED_WIDTHS`), where a tile's shared memory fits
# MAX_DYN_SMEM (the source's): its queries x (its keys + S x (d_head + 2))
# f32 beside a ring of tiles that shrinks to SHARED_RING_KEYS keys (8
# tiles of 16).
QUERY_TILE = 16
SHARED_WIDTHS = (64, 128, 192, 256)
SHARED_RING_KEYS = 8 * 16
MAX_DYN_SMEM = 220 * 1024
FORMS = ("rows", "anc", "pe", "anc_pe", "shared")
CACHE_DTYPES = (torch.bfloat16, torch.int8, torch.float32)
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
LONG_LAUNCHES = 0  # the long route, every form
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


def short_keys(form: str) -> int:
    """The keys a block of the short route holds for `form`: SHORT_MAP_KEYS
    through an ancestry map, else SHORT_KEYS."""
    return SHORT_MAP_KEYS if form in ("anc", "anc_pe") else SHORT_KEYS


def envelope(form: str, d_head: int, beam: int, keys: int, dtype: torch.dtype,
             splits: int = 1, table_keys: int | None = None) -> str:
    """The kernel a call takes on the card, from its shapes alone (never
    pos): `form` one of FORMS ("shared": `decode_shared_cache_attention`,
    `beam` its queries a group; "anc", "anc_pe": groups of `beam` rows),
    `keys` the cache's Tp, `dtype` the caches', `splits` the blocks of its
    split, `table_keys` the keys a short-route block holds (`short_keys`;
    smaller forces the long route). Returns "d64"
    (`decode_attn_fwd`), "f32" (K3-f32 at 64), "d48" (the ladder's rows),
    "rows" (`decode_attn_rows_fwd`), "forms" (`decode_attn_forms_fwd`),
    "shared" (K3s on the tensor cores) or "long" (`decode_attn_long_fwd`).
    Raises only where JAX refuses as well: PE with int8 caches (JAX asserts
    it), int8 caches whose Tp is not a multiple of TIME_ALIGN_I8 (JAX's
    contract for them), caches of another dtype, and sizes below 1."""
    if form not in FORMS or dtype not in CACHE_DTYPES:
        raise ValueError(f"envelope: form {form!r} with {dtype} caches; the kernels take "
                         f"{FORMS} over {CACHE_DTYPES}")
    if min(d_head, beam, keys, splits) < 1:
        raise ValueError(f"envelope: d_head {d_head}, beam {beam}, keys {keys}, splits {splits}")
    if dtype == torch.int8 and form in ("pe", "anc_pe"):
        raise ValueError("decode_cache_attention: int8 caches are unsupported for the PE variant")
    if dtype == torch.int8 and keys % TIME_ALIGN_I8:
        raise ValueError(f"envelope: int8 caches take Tp a multiple of {TIME_ALIGN_I8}, not {keys}")
    chunk, table = -(-keys // splits), table_keys or short_keys(form)
    if form == "shared":
        fits = (4 * query_tiles(beam)[1] * (chunk + splits * (d_head + 2))
                + SHARED_RING_KEYS * d_head * dtype.itemsize <= MAX_DYN_SMEM)
        short = (d_head in SHARED_WIDTHS and dtype != torch.float32 and chunk <= table
                 and fits)
        return "shared" if short else "long"
    if chunk > table:
        return "long"
    if dtype == torch.float32:
        if form != "rows":
            return "long"
        return "f32" if d_head == D_HEAD else "rows" if rows_width_ok(d_head, 1) else "long"
    if d_head == D_HEAD:
        return "d64"
    if form == "rows" and dtype == torch.bfloat16:
        return "d48" if d_head == D_HEAD_SIDE else "rows" if rows_width_ok(d_head, 1) else "long"
    if d_head <= ROWS_D_HEAD_MAX and d_head % FORMS_ALIGN[dtype] == 0:
        return "forms"
    return "long"


def query_tiles(beam: int) -> tuple[int, int]:
    """K3s's tiles a group and the queries of the largest: the fewest tiles
    of at most QUERY_TILE, their sizes balanced (20 as 10 + 10)."""
    tiles = -(-beam // QUERY_TILE)
    return tiles, -(-beam // tiles)


def plan(form: str, rows: int, n_head: int, k: torch.Tensor, beam: int = 1,
         splits: int | None = None) -> tuple[str, int, int]:
    """(route, S, pass keys) of a call on the card: `envelope` at the split
    `time_splits` picks (or `splits`), and the long route's PASS_KEYS.
    `rows`: the query rows, or the groups for "shared", whose long route
    splits its G x beam queries as rows."""
    what = "decode_shared_cache_attention" if form == "shared" else "decode_cache_attention"
    tp, d = k.shape[1:]
    if d % n_head:
        raise ValueError(f"{what}: d {d} is not a multiple of {n_head} heads")
    if form == "shared":  # the launch's blocks: a group's query tiles
        s = _splits(what, splits, rows * query_tiles(beam)[0], n_head, tp, SHARED_SPLIT_BLOCKS)
    else:
        s = _splits(what, splits, rows, n_head, tp)
    route = envelope(form, d // n_head, beam, tp, k.dtype, s)
    if form == "shared" and route == "long" and splits is None:
        s = time_splits(rows * beam, n_head, tp)
    return route, s, PASS_KEYS


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


def decode_cache_attention_chunked_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    splits: int, pass_keys: int = PASS_KEYS, *, anc_local: torch.Tensor | None = None,
    beam: int = 1, shared: bool = False, q_cs: torch.Tensor | None = None,
    k_cs: torch.Tensor | None = None, gate: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The long route in plain PyTorch (the split x passes, as
    `decode_cache_attention_split_ref` is of the split): the caches
    gathered through `anc_local` first (groups of `beam`), or with
    `shared` (G*beam, d) queries over (G, Tp, d) caches. Scores in float32
    (q, or bf16(q·s_k) against int8, dotted with the float32 keys; PE mixed
    (1 - g)·s + g·s_cs per head). Each block of `split_chunks` walks its
    keys in passes of `pass_keys` from its first key with JAX's carry
    (`_make_kernel_chunked`): m_new = max(m, max s), alpha = exp(m - m_new),
    p = exp(s - m_new), l = alpha l + sum p, acc = alpha acc + sum
    bf16(p) v (p not rounded over float32 caches). Then, in rank order, M =
    the blocks' max m, e = exp(m - M), L = sum e l, O = sum e acc; O / L,
    times s_v for int8; q's dtype."""
    if anc_local is not None and beam > 1 and not shared:
        k, v = gather_ancestry(k, anc_local, beam), gather_ancestry(v, anc_local, beam)
        if k_cs is not None:
            k_cs = gather_ancestry(k_cs, anc_local, beam)
    g, tp, d = k.shape
    j, dh = (beam if shared else 1), d // n_head

    def scores(qx, kx):
        qf = qx.float()
        if k_scale is not None:
            qf = (qf * k_scale.float()).to(torch.bfloat16).float()
        return torch.einsum("gjhc,gthc->gjht", qf.reshape(g, j, n_head, dh),
                            kx.float().reshape(g, tp, n_head, dh))[..., : pos + 1]

    s = scores(q, k)
    if q_cs is not None:
        gt = gate.float().reshape(1, 1, n_head, 1)
        s = (1.0 - gt) * s + gt * scores(q_cs, k_cs)
    vh = v.float().reshape(g, tp, n_head, dh)
    f32 = k.dtype == torch.float32
    blocks = []
    for a, z in split_chunks(tp, pos, splits):
        m = torch.full(s.shape[:-1], -torch.inf, device=s.device)
        l, acc = torch.zeros_like(m), torch.zeros(g, j, n_head, dh, device=s.device)
        for p0 in range(a, z, pass_keys):
            p1 = min(p0 + pass_keys, z)
            m_new = torch.maximum(m, s[..., p0:p1].amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s[..., p0:p1] - m_new[..., None])
            l = alpha * l + p.sum(-1)
            w = p if f32 else p.to(torch.bfloat16).float()
            acc = alpha[..., None] * acc + torch.einsum("gjht,gthc->gjhc", w, vh[:, p0:p1])
            m = m_new
        blocks.append((m, l, acc))
    top = torch.stack([m for m, _, _ in blocks]).amax(0)
    l_all, o = torch.zeros_like(top), torch.zeros_like(blocks[0][2])
    for m, l, acc in blocks:
        e = torch.exp(m - top)
        l_all = l_all + e * l
        o = o + e[..., None] * acc
    o = (o / l_all[..., None]).reshape(g * j, d)
    if v_scale is not None:
        o = o * v_scale.float()
    return o.to(q.dtype)


def _cpu_long(form: str, rows: int, n_head: int, k: torch.Tensor,
              beam: int) -> tuple[int, int] | None:
    """(S, pass keys) where the card would walk a block's keys in more than
    one pass of the long route, else None (and None for what the card
    refuses). In one pass the long route is the single-block math with p
    rounded before, not after, the division: the CPU keeps the
    single-block plain version there."""
    if k.dtype not in CACHE_DTYPES or k.shape[-1] % n_head or (
            k.dtype == torch.int8 and (form in ("pe", "anc_pe") or k.shape[1] % TIME_ALIGN_I8)):
        return None
    route, s, kc = plan(form, rows, n_head, k, beam)
    return (s, kc) if route == "long" and -(-k.shape[1] // s) > kc else None


def decode_cache_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int, *,
    anc_local: torch.Tensor | None = None, beam: int = 1,
    q_cs: torch.Tensor | None = None, k_cs: torch.Tensor | None = None,
    gate: torch.Tensor | None = None, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of the kernel `decode_cache_attention` launches for
    these arguments (what it runs for a CPU tensor): the long route's
    where the card walks a block's keys in passes, else the single-block
    one; K3a-int8's is K3-int8's over the caches gathered through the
    map."""
    anc = anc_local is not None and beam > 1
    form = ("anc_pe" if q_cs is not None else "anc") if anc else (
        "pe" if q_cs is not None else "rows")
    long = _cpu_long(form, k.shape[0], n_head, k, beam if anc else 1)
    if long is not None:
        return decode_cache_attention_chunked_ref(
            q, k, v, pos, n_head, *long, anc_local=anc_local if anc else None, beam=beam,
            q_cs=q_cs, k_cs=k_cs, gate=gate, k_scale=k_scale, v_scale=v_scale)
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
    """The plain version of K3s or K3s-int8, or of the long route where the
    card walks a block's keys in passes (what
    `decode_shared_cache_attention` runs for a CPU tensor)."""
    long = _cpu_long("shared", k.shape[0], n_head, k, beam)
    if long is not None:
        return decode_cache_attention_chunked_ref(q, k, v, pos, n_head, *long, beam=beam,
                                                  shared=True, k_scale=k_scale,
                                                  v_scale=v_scale)
    if k_scale is not None:
        return decode_shared_cache_attention_int8_ref(q, k, v, pos, n_head, beam,
                                                      k_scale, v_scale)
    return decode_shared_cache_attention_ref(q, k, v, pos, n_head, beam)


def _check_kernel_inputs(what: str, tensors, cache_dtype: torch.dtype,
                         query_dtype: torch.dtype) -> None:
    """What every decode kernel takes: bf16 queries with bf16 or int8
    caches, or float32 queries with float32 caches; f32 scales and gate,
    one device, contiguous, 16-byte aligned."""
    dev = tensors[0][1].device
    for name, x in tensors:
        want = {"k": cache_dtype, "v": cache_dtype, "k_cs": cache_dtype, "gate": torch.float32,
                "k_scale": torch.float32, "v_scale": torch.float32}.get(name, query_dtype)
        if x.dtype != want or x.device != dev:
            raise ValueError(f"{what}: {name} is {x.dtype} on {x.device}; the "
                             f"kernel takes {want} on {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


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


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _count(name: str) -> None:
    globals()[name] += 1


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
    bf16 queries over bf16 or int8 caches, or float32 queries over float32
    caches, at any d_head; `envelope` names the kernel. `splits` (card
    only): the blocks a (head, row) is split over, instead of
    `time_splits`'s. A block with more keys than `short_keys` takes the
    long route."""
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
    form = ("anc_pe" if pe else "anc") if anc else ("pe" if pe else "rows")
    route, s, kc = plan(form, n, n_head, k, beam if anc else 1, splits)
    ins = [("q", q), ("k", k), ("v", v)]
    if pe:
        if q_cs.shape != q.shape or k_cs.shape != k.shape or gate.shape != (n_head,):
            raise ValueError(f"decode_cache_attention: q_cs {tuple(q_cs.shape)}, k_cs "
                             f"{tuple(k_cs.shape)}, gate {tuple(gate.shape)}")
        ins += [("q_cs", q_cs), ("k_cs", k_cs), ("gate", gate)]
    if quant:
        _check_scales("decode_cache_attention", k, k_scale, v_scale)
        ins += [("k_scale", k_scale), ("v_scale", v_scale)]
    f32 = k.dtype == torch.float32
    _check_kernel_inputs("decode_cache_attention", ins, k.dtype,
                         torch.float32 if f32 else torch.bfloat16)
    if anc and (anc_local.dtype != torch.int32 or anc_local.device != q.device
                or not anc_local.is_contiguous()):
        raise ValueError(f"decode_cache_attention: anc_local is {anc_local.dtype} on "
                         f"{anc_local.device}; the kernel takes contiguous int32 "
                         f"on {q.device}")
    o = torch.empty_like(q)
    dh = d // n_head
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(anc_local if anc else None),
            _ptr(q_cs), _ptr(k_cs), _ptr(gate), _ptr(k_scale), _ptr(v_scale), o.data_ptr())
    if route == "long":
        _long(ptrs, n, tp, n_head, dh, pos, 1 if anc else 0, beam if anc else 1, f32, s, kc,
              _stream(q))
    elif route in ("d64", "forms"):
        entry, ints = (("decode_attn_fwd", (n, tp, n_head, pos, beam if anc else 1, s))
                       if route == "d64" else
                       ("decode_attn_forms_fwd", (n, tp, n_head, dh, pos, beam if anc else 1, s)))
        fn = cuda_lib.load("decode_attn", entry,
                           [ctypes.c_void_p] * 10 + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        cuda_lib.check(fn(*ptrs, *ints, _stream(q)), entry)
        _count(_COUNTER[(anc, pe, quant)])
    else:  # plain rows: "f32", "d48", "rows"
        entry, ints, counter = {
            "f32": ("decode_attn_f32_fwd", (n, tp, n_head, pos, s), "F32_LAUNCHES"),
            "d48": ("decode_attn_d48_fwd", (n, tp, n_head, pos, s), "D48_LAUNCHES"),
            "rows": ("decode_attn_rows_fwd", (int(f32), n, tp, n_head, dh, pos, s),
                     "F32_LAUNCHES" if f32 else "LAUNCHES"),
        }[route]
        fn = cuda_lib.load("decode_attn", entry,
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        cuda_lib.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *ints,
                          _stream(q)), entry)
        _count(counter)
    return o


def _long(ptrs: tuple, rows: int, tp: int, n_head: int, dh: int, pos: int, mode: int, j: int,
          f32: bool, splits: int, kc: int, stream: int) -> None:
    """Launch the long route (`decode_attn_long_fwd`; the caller checked
    the inputs): mode 0 plain rows, 1 the ancestry map, 2 K3s's groups of
    j."""
    fn = cuda_lib.load("decode_attn", "decode_attn_long_fwd",
                       [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    cuda_lib.check(fn(*ptrs, rows, tp, n_head, dh, pos, mode, j, int(f32), splits, kc, stream),
                   "decode_attn_long_fwd")
    _count("LONG_LAUNCHES")


def rows_width_ok(d: int, n_head: int) -> bool:
    """Do the plain rows' runtime-width entry take this width (d = n_head x
    d_head, d_head <= ROWS_D_HEAD_MAX a multiple of ROWS_D_HEAD_ALIGN)?"""
    dh = d // n_head
    return d % n_head == 0 and 0 < dh <= ROWS_D_HEAD_MAX and dh % ROWS_D_HEAD_ALIGN == 0


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
    (K3s-int8); float32 queries over float32 caches. Any beam and d_head
    (`envelope`). `splits` (card only): the blocks a (head, group) is split
    over, instead of `time_splits`'s."""
    quant = k_scale is not None
    g, tp, d = k.shape
    if not 0 <= pos < tp:
        raise ValueError(f"decode_shared_cache_attention: pos {pos} outside [0, {tp})")
    if beam < 1 or q.shape != (g * beam, d) or v.shape != k.shape:
        raise ValueError(f"decode_shared_cache_attention: q {tuple(q.shape)} for "
                         f"{g} groups of {beam}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not _device_path("decode_shared_cache_attention", q):
        return decode_shared_cache_attention_plain(q, k, v, pos, n_head, beam,
                                                   k_scale=k_scale, v_scale=v_scale)
    route, s, kc = plan("shared", g, n_head, k, beam, splits)
    ins = [("q", q), ("k", k), ("v", v)]
    if quant:
        _check_scales("decode_shared_cache_attention", k, k_scale, v_scale)
        ins += [("k_scale", k_scale), ("v_scale", v_scale)]
    f32 = k.dtype == torch.float32
    _check_kernel_inputs("decode_shared_cache_attention", ins, k.dtype,
                         torch.float32 if f32 else torch.bfloat16)
    o = torch.empty_like(q)
    if route == "long":
        _long((q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None, None,
               _ptr(k_scale), _ptr(v_scale), o.data_ptr()), g * beam, tp, n_head, d // n_head,
              pos, 2, beam, f32, s, kc, _stream(q))
        return o
    fn = cuda_lib.load(
        "decode_attn", "decode_attn_shared_fwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            o.data_ptr(), g, tp, n_head, d // n_head, pos, beam, s, _stream(q))
    cuda_lib.check(rc, "decode_attn_shared_fwd")
    _count("SHARED_I8_LAUNCHES" if quant else "SHARED_LAUNCHES")
    return o
