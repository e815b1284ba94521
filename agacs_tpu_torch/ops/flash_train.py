"""Packed-layout encoder self-attention with its backward (counterpart of
`agacs_tpu/ops/flash_train.py` `packed_flash_mha` and its custom VJP;
kernels K1f and K1b).

q/k/v arrive in the natural (B, T, H·64) layout the projections produce;
the kernels read each head's 64 columns in place, so no head-split or
merge transposes run:

  K1f `csrc/packed_flash_fwd.cu`: the forward; under autograd it also
      writes each score row's f32 log-sum-exp (B, H, T), the row
      statistics the backward needs (the JAX VJP has no such residual: it
      recomputes them; this one is internal and changes no result);
  K1b `csrc/packed_flash_bwd.cu`: dq, dk, dv from (q, k, v, o, do, lse).

`packed_flash_mha` goes through the autograd Function `PackedFlashMHA`
when a gradient is needed, and straight to the forward otherwise (the
serving path). A CPU tensor takes the plain versions (`packed_flash_mha_ref`
forward, `packed_flash_mha_bwd_ref` backward), through the same Function;
a CUDA tensor launches the kernels or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from agacs_tpu_torch.ops import cuda_lib
from agacs_tpu_torch.ops.attention import packed_mha, split_heads

D_HEAD = 64
LAUNCHES = 0      # K1f launches since the last reset (chip_smoke.py reads it)
BWD_LAUNCHES = 0  # K1b launches since the last reset

packed_flash_mha_ref = packed_mha  # the plain forward (JAX `_einsum_ref`)


def packed_flash_mha_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, n_head: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, `_bwd_kernel`'s math (:177-220) in the input
    dtype's rounding: products of the input dtype's values accumulated in
    float32; p un-normalized; D = rowsum(do·o); dv = pᵀ(do·linv);
    ds = p(dp − D)·linv; dq = s2·ds k; dk = dsᵀ(q·s2); p, do·linv and ds
    rounded to the input dtype before their products."""
    dt = q.dtype
    b, t, d = q.shape
    s2 = (d // n_head) ** -0.5

    def heads(x):
        return split_heads(x, n_head).float()

    qh = heads(q * s2)  # x0.125 is exact in bf16
    kh, vh, oh, doh = heads(k), heads(v), heads(o), heads(do)
    s = qh @ kh.transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    linv = 1.0 / p.sum(-1, keepdim=True)
    dd = (doh * oh).sum(-1, keepdim=True)
    don = (doh * linv).to(dt).float()
    dv = p.to(dt).float().transpose(-1, -2) @ don
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - dd) * linv).to(dt).float()
    dq = (ds @ kh) * s2
    dk = ds.transpose(-1, -2) @ qh

    def merge(x):
        return x.transpose(1, 2).reshape(b, t, d).to(dt)

    return merge(dq), merge(dk), merge(dv)


def _check(what: str, n_head: int, **tensors) -> None:
    """Raise on what the kernels do not take. The device comes last, so a
    CPU test reaches every other check."""
    q = tensors["q"]
    d = q.shape[-1]
    for name, x in tensors.items():
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} on {x.device} vs "
                             f"q {tuple(q.shape)} on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {name} is {x.dtype}, the kernel takes "
                             "bfloat16")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")
    if d != n_head * D_HEAD:
        raise ValueError(f"{what}: d_model {d} != {n_head} heads x {D_HEAD}; "
                         f"the kernel takes d_head = {D_HEAD}")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")


def _fwd_kernel(q, k, v, n_head: int, with_lse: bool):
    """Launch K1f: o, and the (B, H, T) f32 lse when `with_lse`."""
    _check("packed_flash_fwd", n_head, q=q, k=k, v=v)
    b, t, _ = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty(b, n_head, t, dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = cuda_lib.load(
        "packed_flash_fwd", "packed_flash_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, t, n_head,
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "packed_flash_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return o, lse


def packed_flash_mha_bwd(q, k, v, o, lse, do, n_head: int):
    """Launch K1b: (dq, dk, dv) of the packed attention on the card."""
    _check("packed_flash_bwd", n_head, q=q, k=k, v=v, o=o, do=do)
    b, t, _ = q.shape
    if (lse is None or lse.shape != (b, n_head, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("packed_flash_bwd: lse must be the forward kernel's "
                         f"contiguous ({b}, {n_head}, {t}) float32 row statistics")
    dd = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    fn = cuda_lib.load(
        "packed_flash_bwd", "packed_flash_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, n_head,
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(rc, "packed_flash_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


class PackedFlashMHA(torch.autograd.Function):
    """The custom VJP (`flash_train.py:280-345`): K1f forward saving
    (q, k, v, o) and the lse rows, K1b backward; plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, n_head: int):
        if q.device.type == "cpu":
            o, lse = packed_flash_mha_ref(q, k, v, n_head), None
        else:
            o, lse = _fwd_kernel(q, k, v, n_head, with_lse=True)
        ctx.n_head = n_head
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = packed_flash_mha_bwd_ref(q, k, v, o, do, ctx.n_head)
        else:
            dq, dk, dv = packed_flash_mha_bwd(q, k, v, o, lse, do.contiguous(),
                                              ctx.n_head)
        return dq, dk, dv, None


def packed_flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int
) -> torch.Tensor:
    """(B, T, D) packed q/k/v -> (B, T, D) non-causal self-attention."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return PackedFlashMHA.apply(q, k, v, n_head)
    if q.device.type == "cpu":
        return packed_flash_mha_ref(q, k, v, n_head)
    return _fwd_kernel(q, k, v, n_head, with_lse=False)[0]
