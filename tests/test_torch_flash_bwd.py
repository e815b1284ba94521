"""The port's K1 backward (agacs_tpu_torch.ops.flash_train) against JAX on
the CPU: the gradients through `PackedFlashMHA` (plain forward and plain
backward on a CPU tensor) and `packed_flash_mha_bwd_ref` against
`agacs_tpu.ops.flash_train.packed_flash_mha(..., interpret=True)`, whose
custom VJP runs the Pallas backward kernels interpreted: `_bwd_kernel` at
T = 200, `_bwd_kernel_qc` at T = 1100 (> MAX_T = 1024).

Tolerances: bf16 inputs, the two sides round p, do·linv and ds to bf16 at
the same points but sum in other orders, so a gradient element moves by a
few bf16 ulps of the largest gradient: 2e-2 x max |JAX grad|. At float32
the plain backward agrees with torch autograd of the plain forward to
1e-5 x max |grad|."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.ops import flash_train as jft
from agacs_tpu_torch.ops import flash_train
from agacs_tpu_torch.ops.attention import packed_mha

torch.set_num_threads(1)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    q, k, v = [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(3)]
    do = rng.randn(*shape).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, h):
    """JAX's packed kernel and its VJP, interpreted, on bf16 inputs."""
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, vjp = jax.vjp(lambda a, b, c: jft.packed_flash_mha(a, b, c, h, True), qj, kj, vj)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(doj)]


def _assert_close(out, ref, rtol):
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        err = np.abs(a - b).max()
        assert err <= rtol * np.abs(b).max(), (name, err, np.abs(b).max())


@pytest.mark.parametrize("b,t,d,h", [(1, 200, 384, 6), (1, 1100, 128, 2)])
def test_grads_match_jax_kernel(b, t, d, h):
    """T = 200 takes `_bwd_kernel`, T = 1100 the q-chunked `_bwd_kernel_qc`."""
    q, k, v, do = _inputs((b, t, d), seed=t)
    ref = _jax_grads(q, k, v, do, h)

    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    dot = torch.from_numpy(do).to(torch.bfloat16)
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    o = flash_train.packed_flash_mha(qt, kt, vt, h)
    assert type(o.grad_fn).__name__ == "PackedFlashMHABackward"
    o.backward(dot)
    assert flash_train.LAUNCHES == 0 and flash_train.BWD_LAUNCHES == 0
    _assert_close((qt.grad, kt.grad, vt.grad), ref, rtol=2e-2)

    plain = flash_train.packed_flash_mha_bwd_ref(qt.detach(), kt.detach(), vt.detach(),
                                                 o.detach(), dot, h)
    assert all(g.dtype == torch.bfloat16 and g.shape == (b, t, d) for g in plain)
    _assert_close(plain, ref, rtol=2e-2)


@pytest.mark.parametrize("t", [37, 200])
def test_plain_backward_matches_autograd_f32(t):
    b, d, h = 2, 128, 2
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((b, t, d), seed=1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = packed_mha(*leaves, h)
    auto = torch.autograd.grad(o, leaves, do)
    plain = flash_train.packed_flash_mha_bwd_ref(q, k, v, o.detach(), do, h)
    for a, p in zip(auto, plain):
        assert (a - p).abs().max() <= 1e-5 * a.abs().max()


def test_forward_without_grad_skips_the_function():
    q = torch.randn(1, 16, 128)
    assert flash_train.packed_flash_mha(q, q, q, 2).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash_train.packed_flash_mha(qg, qg, qg, 2).grad_fn is None


@pytest.mark.cuda
def test_k1b_matches_plain_on_card():
    """K1f (o and its lse rows) and K1b against their plain versions on the
    card at the training shapes, with chip_smoke.py's inputs and bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    chip_smoke.check_k1_train(torch.device("cuda"),
                              torch.Generator().manual_seed(0), timed=False)
