"""K5's backward on the CPU: the port's plain backward
(`relpos_flash.relpos_mha_bwd_plain`) against agacs_tpu's Pallas backward
`_bwd_pallas` run in interpret mode, and the port's autograd through
`relpos_mha` against `jax.vjp` of JAX's `relpos_mha` (its Pallas backward
interpreted in bf16, the einsum path in float32), at T 64, 67 (a partial
tile) and 130, with keys masked past each row's length. Inputs are made
with numpy from a seed.

Tolerances, with their reasons: float32 inputs 1e-5 x max |ref| (the same
arithmetic, summed in another order); bf16 inputs 1e-2 x max |ref| for
dqu, dqv, dk, dv and dpe (both round p, do / l and ds to bf16, at places
that differ by the float32 summation order before the rounding).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.ops import relpos_flash as jrf
from agacs_tpu_torch.ops import relpos_flash

torch.set_num_threads(1)

B, D, H = 2, 128, 2  # d_head 64: the kernel's width
NAMES = ("dqu", "dqv", "dk", "dv", "dpe")


def _inputs(t: int, seed: int):
    """qu, qv, k, v (B, T, D), pe (Wp, D) zero-padded, the additive mask
    (row 1's last 20 keys masked) and the output cotangent, as numpy."""
    rng = np.random.RandomState(seed)
    qu = rng.randn(B, t, D) * 1.5 - 1.0
    qv = rng.randn(B, t, D) * 1.5
    k = rng.randn(B, t, D) * 1.5 + 1.0
    v = rng.randn(B, t, D)
    pe = np.zeros((jrf._wp(t), D))
    pe[: 2 * t - 1] = rng.randn(2 * t - 1, D) * 1.5
    mask = np.zeros((B, t), np.float32)
    mask[1, t - 20:] = jrf.NEG_MASK
    do = rng.randn(B, t, D)
    return [x.astype(np.float32) for x in (qu, qv, k, v, pe)], mask, do.astype(np.float32)


def _close(out, ref, rtol, what):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), rtol * np.abs(ref).max()
    assert err <= bound, f"{what}: max |err| {err} > {rtol} x max |ref| ({bound})"


CASES = [(dt, t) for dt in ("float32", "bfloat16") for t in (64, 67, 130)]


@pytest.mark.parametrize("dtype,t", CASES)
def test_plain_backward_matches_pallas_backward(dtype, t):
    xs, mask, do = _inputs(t, seed=t)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(x).astype(jdt) for x in xs]
    jm, jdo = jnp.asarray(mask), jnp.asarray(do).astype(jdt)
    o = jrf._fwd_pallas(*jx, jm, H, True)
    ref = jrf._bwd_pallas(*jx, jm, o, jdo, H, True)
    ref = list(ref[:4]) + [jnp.sum(ref[4], axis=0).astype(jdt)]
    tx = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdt) for x in jx]
    to = torch.from_numpy(np.asarray(o.astype(jnp.float32))).to(tdt)
    got = relpos_flash.relpos_mha_bwd_plain(*tx, torch.from_numpy(mask), to,
                                            torch.from_numpy(do).to(tdt), H)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == tdt, name
        _close(g, r, rtol, f"{name} T={t} {dtype}")


@pytest.mark.parametrize("dtype,t", CASES)
def test_autograd_matches_jax_vjp(dtype, t, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("AGACS_RELPOS_FLASH", "interpret")
    xs, mask, do = _inputs(t, seed=100 + t)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(x).astype(jdt) for x in xs]
    jm = jnp.asarray(mask)
    o_ref, vjp = jax.vjp(lambda *a: jrf.relpos_mha(*a, jm, H, dtype == "bfloat16"), *jx)
    ref = vjp(jnp.asarray(do).astype(jdt))
    tx = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdt).requires_grad_()
          for x in jx]
    o = relpos_flash.relpos_mha(*tx[:4], tx[4], torch.from_numpy(mask), H)
    o.backward(torch.from_numpy(do).to(tdt))
    rtol = 1e-5 if dtype == "float32" else 1e-2
    _close(o, o_ref, rtol, f"o T={t} {dtype}")
    for name, x, r in zip(NAMES, tx, ref):
        _close(x.grad, r, rtol, f"{name} T={t} {dtype}")
    assert relpos_flash.LAUNCHES == relpos_flash.BWD_LAUNCHES == 0
