"""Packed-layout encoder self-attention, forward only (counterpart of
`agacs_tpu/ops/flash_train.py` `packed_flash_mha`; kernel K1).

q/k/v arrive in the natural (B, T, H·64) layout the projections produce;
the kernel (`csrc/packed_flash_fwd.cu`) reads each head's 64 columns in
place, so no head-split or merge transposes run. The backward kernels
belong to the training path and are not ported yet.

`packed_flash_mha` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor (or raises): there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib
from agacs_tpu_torch.ops.attention import packed_mha

D_HEAD = 64
LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

packed_flash_mha_ref = packed_mha  # the plain version (JAX `_einsum_ref`)


def packed_flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int
) -> torch.Tensor:
    """(B, T, D) packed q/k/v -> (B, T, D) non-causal self-attention."""
    if q.device.type == "cpu":
        return packed_flash_mha_ref(q, k, v, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"packed_flash_mha: unsupported device {q.device}")
    b, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"packed_flash_mha: {name} {tuple(x.shape)} on "
                             f"{x.device} vs q {tuple(q.shape)} on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"packed_flash_mha: {name} is {x.dtype}, the "
                             "kernel takes bfloat16")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"packed_flash_mha: {name} must be contiguous "
                             "and 16-byte aligned")
    if d != n_head * D_HEAD:
        raise ValueError(f"packed_flash_mha: d_model {d} != {n_head} heads x "
                         f"{D_HEAD}; the kernel takes d_head = {D_HEAD}")
    o = torch.empty_like(q)
    fn = cuda_lib.load(
        "packed_flash_fwd", "packed_flash_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, t, n_head, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "packed_flash_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return o
