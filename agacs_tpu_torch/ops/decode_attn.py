"""Decode-step cache attention (counterpart of `agacs_tpu/ops/decode_attn.py`
`decode_cache_attention`, plain-row variant; kernel K3).

One query token per row attends over that row's (Tp, d) K/V cache,
keys 0..pos. q is pre-scaled by d_head**-0.5; caches are raw, with
Tp % TIME_ALIGN == 0 (`init_self_kv_cache` and `precompute_cross_kv`
pad). The kernel (`csrc/decode_attn.cu`) reads only keys t <= pos: on the
TPU the masked keys get weight exp(-1e30 - m) == 0 exactly, so skipping
them changes nothing but the bytes read. Beam ancestry, the PE gate mix
and int8 caches are not ported yet and raise.

`decode_cache_attention` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises): there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib

TIME_ALIGN = 16  # cache time axis padding (the JAX bf16 sublane tile)
D_HEAD = 64
MAX_KEYS = 8192  # the kernel keeps pos+1 f32 scores in shared memory
LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)


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

    q (N, d); k/v (N, Tp, d); pos a Python int (keys t > pos masked)."""
    if (anc_local is not None and beam > 1) or q_cs is not None \
            or k_scale is not None:
        raise NotImplementedError(
            "decode_cache_attention: the beam-ancestry, PE and int8 variants "
            "are not ported yet (plain rows only)")
    n, tp, d = k.shape
    if not 0 <= pos < tp:
        raise ValueError(f"decode_cache_attention: pos {pos} outside [0, {tp})")
    if q.device.type == "cpu":
        return decode_cache_attention_ref(q, k, v, pos, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"decode_cache_attention: unsupported device {q.device}")
    if q.shape != (n, d) or v.shape != k.shape:
        raise ValueError(f"decode_cache_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.device != q.device:
            raise ValueError(f"decode_cache_attention: {name} is {x.dtype} on "
                             f"{x.device}; the kernel takes bfloat16 on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_cache_attention: {name} must be "
                             "contiguous and 16-byte aligned")
    if d != n_head * D_HEAD:
        raise ValueError(f"decode_cache_attention: d {d} != {n_head} heads x "
                         f"{D_HEAD}; the kernel takes d_head = {D_HEAD}")
    if pos + 1 > MAX_KEYS:
        raise ValueError(f"decode_cache_attention: pos + 1 = {pos + 1} keys "
                         f"exceed the kernel's {MAX_KEYS}")
    o = torch.empty_like(q)
    fn = cuda_lib.load(
        "decode_attn", "decode_attn_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            n, tp, n_head, pos, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "decode_attn_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return o
