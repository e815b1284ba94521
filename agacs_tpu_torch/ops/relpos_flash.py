"""Relative-position (Transformer-XL) multi-head attention of the conformer
encoder (counterpart of `agacs_tpu/ops/relpos_flash.py`; kernel K5's
forward and backward, `csrc/relpos_flash.cu`).

Per head h, with qu = q + pos_bias_u and qv = q + pos_bias_v formed by the
caller:

  s[q, j] = (qu[q] . k[j] + qv[q] . pe[T-1-q+j]) * d_head^-0.5 + mask[j]
  out[q]  = softmax_j(s[q]) . v

qu, qv, k, v in the packed (B, T, D) layout the projections produce; pe
(Wp, D) the projected positions T-1 .. -(T-1) in rows 0 .. 2T-2, zero-padded
to Wp = 2T-1 rounded up to 128 (`pad_pe`); mask (B, T) additive float32,
0 on valid keys and `NEG_MASK` on padded ones.

`supports` is JAX's envelope of the kernel without its backend test:
64 <= T <= 640, d % 128 == 0, d_head % 8 == 0, bf16 inputs. Inside it the
conformer (`models/conformer.py`) calls `relpos_mha`; outside it takes the
einsum path, as JAX's `_rel_attn` does. The two paths round differently
(float32 scores here, bf16 einsums there), so the envelope decides the
numbers and is not a fallback. `relpos_mha` runs the plain version
`relpos_mha_plain` for a CPU tensor and launches K5 for a CUDA tensor or
raises. K5 is built at head widths `INSTANCES` (32, 64, 128); a head of
another width up to 128 is zero-padded to the next instance, and a wider
one to the next multiple of `CHUNK` (128), which K5's wide route streams
in 128-wide chunks, the chunk count given at launch (`instance`,
`pad_heads`): the zero columns add exact zeros to both score products,
the padded output and gradient columns are dropped, and the scale stays
the real width's d_head^-0.5. So the card takes exactly JAX's envelope;
`check_envelope` raises outside it, naming it. Under autograd it is a
`torch.autograd.Function` (JAX's custom VJP): on the card the forward also
keeps each row's max and sum and the backward is K5's backward kernel; on
the CPU the backward is `relpos_mha_bwd_plain`, `_bwd_kernel`'s
arithmetic. dpe is summed over the batch in float32 and cast to pe's
dtype, as JAX's `_vjp_bwd` does; the mask gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from agacs_tpu_torch.ops import cuda_lib

MIN_T, MAX_T = 64, 640
NEG_MASK = -1e30
INSTANCES = (32, 64, 128)  # the head widths K5 is built at
CHUNK = 128  # above INSTANCES, heads are padded to a multiple of this (the wide route)
LAUNCHES = 0  # K5 forward launches since the last reset (chip_smoke.py reads it)
BWD_LAUNCHES = 0  # K5 backward launches


def _wp(t: int) -> int:
    return -(-(2 * t - 1) // 128) * 128


def pad_pe(pe: torch.Tensor, t: int) -> torch.Tensor:
    """(2T-1, D) projected positions -> (Wp, D) zero-padded."""
    return F.pad(pe, (0, 0, 0, _wp(t) - pe.shape[0]))


def supports(t: int, d_model: int, n_head: int, dtype: torch.dtype) -> bool:
    """Does the conformer take the kernel's path at these shapes (JAX
    `supports` minus the backend test)?"""
    if not MIN_T <= t <= MAX_T:
        return False
    if d_model % n_head or d_model % 128 or (d_model // n_head) % 8:
        return False
    return dtype == torch.bfloat16


def instance(d_head: int) -> int:
    """The head width K5 runs a head of `d_head` at (the wrapper zero-pads up
    to it): the least of INSTANCES that holds it, or above them the least
    multiple of CHUNK (the wide route, in width // CHUNK chunks)."""
    for w in INSTANCES:
        if d_head <= w:
            return w
    return -(-d_head // CHUNK) * CHUNK


def check_envelope(t: int, d_model: int, n_head: int) -> int:
    """The head width K5 runs (T, d, h) at on the card (`instance`), or a
    ValueError that names the envelope: JAX's (`supports`: 64 <= T <= 640,
    d % 128 == 0, d_head % 8 == 0)."""
    ok = (MIN_T <= t <= MAX_T and d_model % 128 == 0 and d_model % n_head == 0
          and (d_model // n_head) % 8 == 0)
    if not ok:
        raise ValueError(f"relpos_flash: T {t}, d {d_model}, {n_head} heads: K5 takes "
                         f"{MIN_T} <= T <= {MAX_T}, d % 128 == 0 and d_head % 8 == 0 "
                         "(JAX's envelope)")
    return instance(d_model // n_head)


def pad_heads(x: torch.Tensor, n_head: int, width: int) -> torch.Tensor:
    """(..., h * d_head) -> (..., h * width): each head zero-padded at its end."""
    dh = x.shape[-1] // n_head
    if dh == width:
        return x
    y = x.reshape(*x.shape[:-1], n_head, dh)
    return F.pad(y, (0, width - dh)).reshape(*x.shape[:-1], n_head * width).contiguous()


def unpad_heads(x: torch.Tensor, n_head: int, d_head: int) -> torch.Tensor:
    """The inverse of `pad_heads`: each head's first d_head columns."""
    width = x.shape[-1] // n_head
    if width == d_head:
        return x
    return x.reshape(*x.shape[:-1], n_head, width)[..., :d_head].reshape(
        *x.shape[:-1], n_head * d_head)


def relpos_mha_plain(qu, qv, k, v, pe, mask, n_head: int,
                     scale: float | None = None) -> torch.Tensor:
    """The plain version: JAX `_fwd_kernel`'s arithmetic (:148-175). Scores
    from products of the input dtype's values accumulated in float32, the
    shift as a gather of columns T-1-q+j, the additive mask, a float32
    softmax with the UN-normalized p rounded to v's dtype for the value
    product, the division by the row sum after it. `scale`: d_head^-0.5
    unless given (a padded head keeps its real width's)."""
    b, t, d = qu.shape
    dh = d // n_head
    scale = dh ** -0.5 if scale is None else scale

    def heads(x):
        return x.reshape(b, t, n_head, dh).transpose(1, 2).float()

    peh = pe[: 2 * t - 1].reshape(2 * t - 1, n_head, dh).transpose(0, 1).float()
    ac = heads(qu) @ heads(k).transpose(-1, -2)  # (B, h, T, T)
    bdf = heads(qv) @ peh.transpose(-1, -2)[None]  # (B, h, T, 2T-1)
    cols = (t - 1) - torch.arange(t, device=qu.device)[:, None] \
        + torch.arange(t, device=qu.device)[None, :]
    bd = bdf.gather(3, cols.expand(b, n_head, t, t))
    s = (ac + bd) * scale + mask.float()[:, None, None, :]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(v.dtype).float() @ heads(v)) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).reshape(b, t, d).to(qu.dtype)


def _check(qu, qv, k, v, pe, mask, n_head: int) -> int:
    """The checks of both launches; returns the head width the kernel runs
    at (an instance, or a multiple of CHUNK: the chunk count is width //
    CHUNK)."""
    b, t, d = qu.shape
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_flash: K5 runs on a CUDA tensor, not on {qu.device}")
    for name, x in (("qu", qu), ("qv", qv), ("k", k), ("v", v), ("pe", pe), ("mask", mask)):
        want = torch.float32 if name == "mask" else torch.bfloat16
        if x.dtype != want or x.device != qu.device:
            raise ValueError(f"relpos_flash_fwd: {name} is {x.dtype} on {x.device}; the "
                             f"kernel takes {want} on {qu.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"relpos_flash_fwd: {name} must be contiguous and 16-byte "
                             "aligned")
    if any(x.shape != qu.shape for x in (qv, k, v)) or mask.shape != (b, t) \
            or pe.dim() != 2 or pe.shape[0] < 2 * t - 1 or pe.shape[1] != d:
        raise ValueError(f"relpos_flash_fwd: qu {tuple(qu.shape)}, qv {tuple(qv.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, pe {tuple(pe.shape)}, "
                         f"mask {tuple(mask.shape)}")
    return check_envelope(t, d, n_head)


def relpos_mha_bwd_plain(qu, qv, k, v, pe, mask, o, do, n_head: int,
                         scale: float | None = None):
    """The plain backward: JAX `_bwd_kernel`'s arithmetic (:178-246) ->
    (dqu, dqv, dk, dv, dpe). p = exp(s - m) unnormalised, rounded to do's
    dtype for dv against bf16(do / l); dd = rowsum(do * o) in float32;
    ds = (p (dp - dd) / l * d_head^-0.5) rounded to the input dtype before
    its products; dqv and dpe through the un-shifted ds (a scatter onto
    columns T-1-q+j); dpe summed over the batch in float32, then cast to
    pe's dtype (its rows from 2T-1 on are zero). `scale` as in
    `relpos_mha_plain`."""
    b, t, d = qu.shape
    dh = d // n_head
    dt = do.dtype
    isd = dh ** -0.5 if scale is None else scale

    def heads(x):
        return x.reshape(b, t, n_head, dh).transpose(1, 2).float()

    def merge(x, dtype):
        return x.transpose(1, 2).reshape(b, t, d).to(dtype)

    peh = pe[: 2 * t - 1].reshape(2 * t - 1, n_head, dh).transpose(0, 1).float()
    quh, qvh, kh, vh, doh = heads(qu), heads(qv), heads(k), heads(v), heads(do)
    cols = ((t - 1) - torch.arange(t, device=qu.device)[:, None]
            + torch.arange(t, device=qu.device)[None, :]).expand(b, n_head, t, t)
    bd = (qvh @ peh.transpose(-1, -2)[None]).gather(3, cols)
    s = (quh @ kh.transpose(-1, -2) + bd) * isd + mask.float()[:, None, None, :]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    linv = 1.0 / p.sum(-1, keepdim=True)
    dd = (doh * heads(o)).sum(-1, keepdim=True)
    don = (doh * linv).to(dt).float()
    dv = p.to(dt).float().transpose(-1, -2) @ don
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - dd) * linv * isd).to(dt).float()
    dbd = torch.zeros(b, n_head, t, 2 * t - 1, device=qu.device).scatter(3, cols, ds)
    dqv = (dbd @ peh[None]).to(dt).float()
    dpe = (dbd.transpose(-1, -2) @ qvh).sum(0)  # (h, 2T-1, dh)
    dpe = pad_pe(dpe.transpose(0, 1).reshape(2 * t - 1, d), t)[: pe.shape[0]]
    return (merge(ds @ kh, qu.dtype), merge(dqv, qv.dtype),
            merge(ds.transpose(-1, -2) @ quh, k.dtype), merge(dv, v.dtype), dpe.to(pe.dtype))


def _launch_fwd(qu, qv, k, v, pe, mask, n_head: int, stats: bool):
    """K5's forward on the card -> o, and with `stats` the (B, H, T) float32
    row max and row sum the backward reads."""
    w = _check(qu, qv, k, v, pe, mask, n_head)
    b, t, d = qu.shape
    dh = d // n_head
    qu_, qv_, k_, v_, pe_ = (pad_heads(x, n_head, w) for x in (qu, qv, k, v, pe))
    o = torch.empty_like(qu_)
    m = l = None
    if stats:
        m = torch.empty(b, n_head, t, device=qu.device)
        l = torch.empty_like(m)
    fn = cuda_lib.load("relpos_flash", "relpos_flash_fwd",
                       [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(qu_.data_ptr(), qv_.data_ptr(), k_.data_ptr(), v_.data_ptr(), pe_.data_ptr(),
            mask.data_ptr(), o.data_ptr(), m.data_ptr() if stats else None,
            l.data_ptr() if stats else None, b, t, n_head, w, dh ** -0.5,
            torch.cuda.current_stream(qu.device).cuda_stream)
    cuda_lib.check(rc, "relpos_flash_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return unpad_heads(o, n_head, dh), m, l


def _launch_bwd(qu, qv, k, v, pe, mask, o, do, m, l, n_head: int):
    """K5's backward on the card -> (dqu, dqv, dk, dv, dpe in pe's dtype)."""
    w = _check(qu, qv, k, v, pe, mask, n_head)
    do = do.contiguous()
    if do.shape != qu.shape or do.dtype != qu.dtype:
        raise ValueError(f"relpos_flash_bwd: do {tuple(do.shape)} {do.dtype}")
    b, t, d = qu.shape
    dh = d // n_head
    qu_, qv_, k_, v_, pe_, o_, do_ = (pad_heads(x, n_head, w)
                                      for x in (qu, qv, k, v, pe, o, do))
    dd = torch.empty_like(m)
    dqu, dqv, dk, dv = (torch.empty_like(qu_) for _ in range(4))
    dpe = torch.zeros(pe_.shape, device=pe.device)
    fn = cuda_lib.load("relpos_flash", "relpos_flash_bwd",
                       [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(qu_.data_ptr(), qv_.data_ptr(), k_.data_ptr(), v_.data_ptr(), pe_.data_ptr(),
            mask.data_ptr(), o_.data_ptr(), do_.data_ptr(), m.data_ptr(), l.data_ptr(),
            dd.data_ptr(), dqu.data_ptr(), dqv.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dpe.data_ptr(), b, t, n_head, w, dh ** -0.5,
            torch.cuda.current_stream(qu.device).cuda_stream)
    cuda_lib.check(rc, "relpos_flash_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return (*(unpad_heads(x, n_head, dh) for x in (dqu, dqv, dk, dv)),
            unpad_heads(dpe, n_head, dh).to(pe.dtype))


class _RelposMHA(torch.autograd.Function):
    """K5 under autograd: the plain forward and backward on the CPU, the
    kernels on the card (the forward keeps the row statistics only when an
    input needs a gradient)."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, pe, mask, n_head):
        if qu.device.type == "cpu":
            o, m, l = relpos_mha_plain(qu, qv, k, v, pe, mask, n_head), None, None
        else:
            o, m, l = _launch_fwd(qu, qv, k, v, pe, mask, n_head,
                                  stats=any(ctx.needs_input_grad[:5]))
        ctx.n_head = n_head
        ctx.save_for_backward(qu, qv, k, v, pe, mask, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        qu, qv, k, v, pe, mask, o, m, l = ctx.saved_tensors
        if qu.device.type == "cpu":
            grads = relpos_mha_bwd_plain(qu, qv, k, v, pe, mask, o, do, ctx.n_head)
        else:
            grads = _launch_bwd(qu, qv, k, v, pe, mask, o, do, m, l, ctx.n_head)
        return (*grads, None, None)


def relpos_mha(qu, qv, k, v, pe, mask, n_head: int) -> torch.Tensor:
    """(B, T, D) rel-pos attention before the output projection: the plain
    version on the CPU, K5 on a CUDA tensor (or a raise); differentiable in
    qu, qv, k, v and pe."""
    return _RelposMHA.apply(qu, qv, k, v, pe, mask, n_head)
