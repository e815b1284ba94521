"""The port's ops (agacs_tpu_torch.ops) against their JAX counterparts on
the CPU: same numpy-seeded inputs through both packages.

Tolerances: float32 paths agree to summation order (1e-5; 1e-4 for the
log-mel, whose log10 amplifies the DFT's rounding); bfloat16 paths differ
by where each side rounds (2e-2 on values of order 0.1-1)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.ops import log_mel_spectrogram as jax_log_mel
from agacs_tpu.ops.decode_attn import decode_cache_attention as jax_dca
from agacs_tpu.ops.decode_attn import decode_cache_attention_ref as jax_dca_ref
from agacs_tpu.ops.flash_train import _einsum_ref
from agacs_tpu.ops.flash_train import packed_flash_mha as jax_packed
from agacs_tpu_torch.ops import decode_attn, flash_train
from agacs_tpu_torch.ops.logmel import log_mel_spectrogram
from agacs_tpu_torch.ops.stft import stft_power

torch.set_num_threads(1)


def _both(a: np.ndarray, bf16: bool):
    """The same values as a jax array and a torch tensor."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("n_samples", [16000, 12345, 48000])
def test_log_mel_matches_jax(n_samples):
    rng = np.random.RandomState(n_samples)
    audio = (rng.randn(2, n_samples) * 0.1).astype(np.float32)
    audio[1, n_samples // 2 :] = 0.0  # a padded row
    ilens = np.array([n_samples, n_samples // 2], np.int32)
    ref, ref_lens = jax_log_mel(jnp.asarray(audio), jnp.asarray(ilens))
    out, lens = log_mel_spectrogram(torch.from_numpy(audio), torch.from_numpy(ilens))
    assert out.shape == (2, n_samples // 160, 80) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))


def test_stft_power_matches_torch_stft():
    audio = torch.from_numpy(np.random.RandomState(0).randn(2, 4000).astype(np.float32))
    ref = torch.stft(audio.double(), 400, 160, window=torch.hann_window(400).double(),
                     center=True, return_complex=True).abs().pow(2).transpose(1, 2)
    np.testing.assert_allclose(stft_power(audio, 400, 160).numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-3)


def _qkv(shape, bf16):
    rng = np.random.RandomState(0)
    return [_both((rng.randn(*shape) * 0.3).astype(np.float32), bf16) for _ in range(3)]


def test_packed_flash_plain_matches_jax_kernel_bf16():
    """The port's plain K1 against the Pallas kernel run interpreted."""
    b, t, d, h = 2, 200, 384, 6
    (qj, qt), (kj, kt), (vj, vt) = _qkv((b, t, d), bf16=True)
    ref = jax_packed(qj, kj, vj, h, True)
    out = flash_train.packed_flash_mha(qt, kt, vt, h)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, d)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2)


def test_packed_flash_plain_matches_einsum_ref_f32():
    b, t, d, h = 2, 200, 384, 6
    (qj, qt), (kj, kt), (vj, vt) = _qkv((b, t, d), bf16=False)
    ref = _einsum_ref(qj, kj, vj, h)
    out = flash_train.packed_flash_mha(qt, kt, vt, h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("t", [129, 750])
def test_packed_flash_function_matches_jax_kernel_bf16(t):
    """The forward through `PackedFlashMHA` (inputs that need a gradient)
    and without it, at the kernels' tile edges: 129 is one row past a
    128-row tile, 750 the encoder's length (5 x 128 + 110)."""
    b, d, h = 2, 128, 2
    (qj, qt), (kj, kt), (vj, vt) = _qkv((b, t, d), bf16=True)
    ref = _np(jax_packed(qj, kj, vj, h, True))
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    out = flash_train.packed_flash_mha(*leaves, h)
    assert type(out.grad_fn).__name__ == "PackedFlashMHABackward"
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, d)
    np.testing.assert_allclose(_np(out.detach()), ref, atol=2e-2)
    np.testing.assert_allclose(_np(flash_train.packed_flash_mha(qt, kt, vt, h)), ref, atol=2e-2)


@pytest.mark.parametrize("case", ["float32", "non_contiguous", "misaligned", "d_head_32",
                                  "cpu"])
def test_packed_flash_kernel_wrappers_refuse(case):
    """K1f's and K1b's wrappers raise on what their kernels do not take:
    a non-bf16, non-contiguous or misaligned tensor, d_head != 64, and (on
    a tensor that passes the rest) a device other than the card."""
    b, t, h = 1, 8, 2
    x = torch.zeros(b, t, h * 64, dtype=torch.bfloat16)
    match = "unsupported device"
    if case == "float32":
        x, match = x.float(), "the kernel takes bfloat16"
    elif case == "non_contiguous":
        x = torch.zeros(b, h * 64, t, dtype=torch.bfloat16).transpose(1, 2)
        match = "contiguous and 16-byte aligned"
    elif case == "misaligned":
        x = torch.zeros(b * t * h * 64 + 1, dtype=torch.bfloat16)[1:].view(b, t, h * 64)
        match = "contiguous and 16-byte aligned"
    elif case == "d_head_32":
        h, match = 4, "the kernel takes d_head = 64"
    lse = torch.zeros(b, h, t)
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    with pytest.raises(ValueError, match=match):
        flash_train._fwd_kernel(x, x, x, h, with_lse=True)
    with pytest.raises(ValueError, match=match):
        flash_train.packed_flash_mha_bwd(x, x, x, x, lse, x, h)
    assert flash_train.LAUNCHES == 0 and flash_train.BWD_LAUNCHES == 0


@pytest.mark.parametrize("bf16,atol", [(False, 1e-5), (True, 2e-2)])
@pytest.mark.parametrize("pos", [0, 9, 37, 63])
def test_decode_attention_plain_matches_jax(bf16, atol, pos):
    """The port's plain K3 against the Pallas kernel (interpreted) and the
    JAX oracle; rows past pos are poisoned on the two kernel sides."""
    n, tp, d, h = 6, 64, 128, 2
    rng = np.random.RandomState(pos)
    q = (rng.randn(n, d) * 0.3 * (d // h) ** -0.5).astype(np.float32)
    k = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    v = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[:, pos + 1 :] = 1e9
    v_bad[:, pos + 1 :] = 1e9
    (qj, qt), (kj, _), (vj, _) = _both(q, bf16), _both(k, bf16), _both(v, bf16)
    (kbj, kbt), (vbj, vbt) = _both(k_bad, bf16), _both(v_bad, bf16)
    out = decode_attn.decode_cache_attention(qt, kbt, vbt, pos, h)
    assert out.dtype == qt.dtype and out.shape == (n, d)
    kernel = jax_dca(qj, kbj, vbj, pos, h, interpret=True)
    ref = jax_dca_ref(qj, kj, vj, pos, h)
    np.testing.assert_allclose(_np(out), _np(kernel), atol=atol)
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol)


def test_pad_time_matches_jax():
    from agacs_tpu.ops.decode_attn import TIME_ALIGN, pad_time

    assert decode_attn.TIME_ALIGN == TIME_ALIGN
    for t in (1, 16, 105, 750, 1500):
        assert decode_attn.pad_time(t) == pad_time(t)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1 and K3 against their plain versions (float32, same bf16 inputs) on
    the card at the whisper-small slice shapes, with chip_smoke.py's sharp,
    shifted inputs and its bound of 1e-2 x max |plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    chip_smoke.check_k1(torch.device("cuda"), g, timed=False)
    chip_smoke.check_k3(torch.device("cuda"), g, timed=False)
