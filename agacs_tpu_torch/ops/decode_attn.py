"""Decode-step cache attention (counterpart of `agacs_tpu/ops/decode_attn.py`
`decode_cache_attention` and `decode_shared_cache_attention`; kernels K3,
K3a and K3s).

One query token per row attends over a (Tp, d) K/V cache, keys 0..pos.
q is pre-scaled by d_head**-0.5; caches are raw, with Tp % TIME_ALIGN == 0
(`init_self_kv_cache` and `precompute_cross_kv` pad). The kernels
(`csrc/decode_attn.cu`) read only keys t <= pos: on the TPU the masked
keys get weight exp(-1e30 - m) == 0 exactly, so skipping them changes
nothing but the bytes read.

  decode_cache_attention          K3: row n over its own cache row n;
                                  K3a (anc_local, beam j > 1): row n of
                                  group g = n // j reads position t from
                                  the physical row g*j + anc_local[n, t]
  decode_shared_cache_attention   K3s: the j beam queries of group g over
                                  ONE shared (Tp, d) cache (cross-KV)

The PE gate mix and int8 caches are not ported yet and raise.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises): there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib

TIME_ALIGN = 16  # cache time axis padding (the JAX bf16 sublane tile)
D_HEAD = 64
MAX_KEYS = 8192  # K3 keeps pos+1 f32 scores in shared memory
# K3a keeps pos+1 f32 scores and pos+1 int32 rows in the 48 KB of shared
# memory a block gets without the opt-in attribute (beside ~1.3 KB static)
MAX_ANC_KEYS = 4096
MAX_BEAM = 16  # K3s: the j queries of a group live in registers
SHARED_WARPS = 16  # K3s's warps per block (SH_WARPS in decode_attn.cu)
# K3s keeps j x (pos+1) f32 scores and its warps' j x 64 f32 partial
# outputs in dynamic shared memory (set per launch); 200 KB leaves room
# for its <= 4.2 KB static arrays in 227 KB
MAX_SHARED_SMEM = 200 * 1024
# kernel launches since the last reset (chip_smoke.py reads them)
LAUNCHES = 0  # K3
ANC_LAUNCHES = 0  # K3a
SHARED_LAUNCHES = 0  # K3s


def pad_time(t: int, align: int = TIME_ALIGN) -> int:
    return -(-t // align) * align


def decode_cache_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int
) -> torch.Tensor:
    """Plain version (JAX `decode_cache_attention_ref`, plain rows): scores
    in the cache dtype, keys past pos masked with -1e30, float32 softmax,
    weights cast back for the value sum."""
    n, tp, d = k.shape
    dh = d // n_head
    s = torch.einsum(
        "nhc,nthc->nth", q.reshape(n, n_head, dh).to(k.dtype),
        k.reshape(n, tp, n_head, dh),
    ).float()
    t_ids = torch.arange(tp, device=k.device)[None, :, None]
    s = torch.where(t_ids <= pos, s, torch.full_like(s, -1.0e30))
    p = torch.softmax(s, dim=1)
    o = torch.einsum("nth,nthc->nhc", p.to(v.dtype), v.reshape(n, tp, n_head, dh))
    return o.reshape(n, d).to(q.dtype)


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
    anc_local: torch.Tensor, beam: int,
) -> torch.Tensor:
    """Plain version of K3a (JAX `decode_cache_attention_ref` with
    `anc_local`): the group's rows gathered through the map, then the
    plain-row math. JAX resolves the map with a one-hot mix 1.0*x + 0.0*y,
    which is exact on finite caches, so the gather gives its numbers."""
    return decode_cache_attention_ref(
        q, gather_ancestry(k, anc_local, beam), gather_ancestry(v, anc_local, beam),
        pos, n_head)


def decode_shared_cache_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, n_head: int,
    beam: int,
) -> torch.Tensor:
    """Plain version of K3s (JAX `decode_shared_cache_attention_ref`):
    (G*beam, d) group-major queries over (G, Tp, d) caches."""
    g, tp, d = k.shape
    dh = d // n_head
    s = torch.einsum(
        "gjhc,gthc->gjth", q.reshape(g, beam, n_head, dh).to(k.dtype),
        k.reshape(g, tp, n_head, dh),
    ).float()
    t_ids = torch.arange(tp, device=k.device)[None, None, :, None]
    s = torch.where(t_ids <= pos, s, torch.full_like(s, -1.0e30))
    p = torch.softmax(s, dim=2)
    o = torch.einsum("gjth,gthc->gjhc", p.to(v.dtype), v.reshape(g, tp, n_head, dh))
    return o.reshape(g * beam, d).to(q.dtype)


def _check_kernel_inputs(what: str, n_head: int, d: int, tensors) -> None:
    """What every decode kernel takes: bf16, one device, contiguous,
    16-byte aligned, d_head 64."""
    dev = tensors[0][1].device
    for name, x in tensors:
        if x.dtype != torch.bfloat16 or x.device != dev:
            raise ValueError(f"{what}: {name} is {x.dtype} on {x.device}; the "
                             f"kernel takes bfloat16 on {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if d != n_head * D_HEAD:
        raise ValueError(f"{what}: d {d} != {n_head} heads x {D_HEAD}; the kernel "
                         f"takes d_head = {D_HEAD}")


def _device_path(what: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); anything else raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return True


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
) -> torch.Tensor:
    """One decode step of masked cache attention: (N, d) output.

    q (N, d); k/v (N, Tp, d); pos a Python int (keys t > pos masked).
    With `anc_local` (N, Tp) int32 in [0, beam) and beam > 1, row n reads
    position t from row (n // beam) * beam + anc_local[n, t] (K3a; a value
    outside [0, beam) is clamped into it, so no row reads outside its
    group); otherwise each row reads its own cache row (K3)."""
    if q_cs is not None or k_scale is not None:
        raise NotImplementedError(
            "decode_cache_attention: the PE and int8 variants are not ported yet")
    n, tp, d = k.shape
    if not 0 <= pos < tp:
        raise ValueError(f"decode_cache_attention: pos {pos} outside [0, {tp})")
    anc = anc_local is not None and beam > 1
    if anc and (n % beam or anc_local.shape != (n, tp)):
        raise ValueError(f"decode_cache_attention: {n} rows in groups of {beam}, "
                         f"anc_local {tuple(anc_local.shape)} (want {(n, tp)})")
    if not _device_path("decode_cache_attention", q):
        if anc:
            return decode_cache_attention_anc_ref(q, k, v, pos, n_head, anc_local, beam)
        return decode_cache_attention_ref(q, k, v, pos, n_head)
    if q.shape != (n, d) or v.shape != k.shape:
        raise ValueError(f"decode_cache_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_kernel_inputs("decode_cache_attention", n_head, d,
                         (("q", q), ("k", k), ("v", v)))
    max_keys = MAX_ANC_KEYS if anc else MAX_KEYS
    if pos + 1 > max_keys:
        raise ValueError(f"decode_cache_attention: pos + 1 = {pos + 1} keys "
                         f"exceed the kernel's {max_keys}")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    global LAUNCHES, ANC_LAUNCHES
    if not anc:
        fn = cuda_lib.load(
            "decode_attn", "decode_attn_fwd",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        )
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                n, tp, n_head, pos, stream)
        cuda_lib.check(rc, "decode_attn_fwd")
        LAUNCHES += 1
        return o
    if (anc_local.dtype != torch.int32 or anc_local.device != q.device
            or not anc_local.is_contiguous()):
        raise ValueError(f"decode_cache_attention: anc_local is {anc_local.dtype} on "
                         f"{anc_local.device}; the kernel takes contiguous int32 "
                         f"on {q.device}")
    fn = cuda_lib.load(
        "decode_attn", "decode_attn_anc_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), anc_local.data_ptr(),
            o.data_ptr(), n, tp, n_head, pos, beam, stream)
    cuda_lib.check(rc, "decode_attn_anc_fwd")
    ANC_LAUNCHES += 1
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
) -> torch.Tensor:
    """Grouped masked cache attention: (G*beam, d) queries over (G, Tp, d)
    shared caches -> (G*beam, d). Rows are group-major (row g*beam + i is
    utterance g's beam slot i); keys t > pos are masked (pass T_audio - 1
    to mask the time padding)."""
    if k_scale is not None:
        raise NotImplementedError(
            "decode_shared_cache_attention: int8 caches are not ported yet")
    g, tp, d = k.shape
    if not 0 <= pos < tp:
        raise ValueError(f"decode_shared_cache_attention: pos {pos} outside [0, {tp})")
    if q.shape != (g * beam, d) or v.shape != k.shape:
        raise ValueError(f"decode_shared_cache_attention: q {tuple(q.shape)} for "
                         f"{g} groups of {beam}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not _device_path("decode_shared_cache_attention", q):
        return decode_shared_cache_attention_ref(q, k, v, pos, n_head, beam)
    _check_kernel_inputs("decode_shared_cache_attention", n_head, d,
                         (("q", q), ("k", k), ("v", v)))
    smem = beam * (pos + 1 + SHARED_WARPS * D_HEAD) * 4
    if not 1 <= beam <= MAX_BEAM or smem > MAX_SHARED_SMEM:
        raise ValueError(f"decode_shared_cache_attention: beam {beam} x {pos + 1} keys "
                         f"exceed the kernel's {MAX_BEAM} queries or "
                         f"{MAX_SHARED_SMEM} B of shared memory")
    o = torch.empty_like(q)
    fn = cuda_lib.load(
        "decode_attn", "decode_attn_shared_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g, tp, n_head,
            pos, beam, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "decode_attn_shared_fwd")
    global SHARED_LAUNCHES
    SHARED_LAUNCHES += 1
    return o
