"""Whisper encoder, teacher-forced decoder and KV-cached decoder
(counterpart of `agacs_tpu/models/whisper.py`), as nn.Modules with
OpenAI's parameter names, so `encoder.blocks.3.attn.query.weight` is where
an OpenAI checkpoint puts it.

Counterparts of the JAX functions:

  layer_norm    -> LayerNorm (float32 with float32 affine, cast back)
  linear        -> Linear: weight and bias cast to the input's dtype at use
  gelu          -> nn.GELU / F.gelu, exact erf form
  conv1d        -> Conv1d, padding 1, cast at use (cuDNN's TF32 switched off)
  sinusoids     -> sinusoids
  mha           -> MultiHeadAttention (non-causal self- and cross-attention;
                   `causal_self` for the decoder, with the language columns)
  adapter_fwd   -> Adapter
  mlp_fwd       -> MLP, the `mlp` Sequential of a block (children 0 and 2 are
                   JAX's fc1 and fc2)
  residual_block -> ResidualAttentionBlock.forward / .step (one cached token)
  whisper_encode, encoder_olens, init_whisper_params, whisper_decode,
  precompute_cross_kv, init_self_kv_cache, whisper_decode_step -> functions
  of the same names

Linear and conv parameters are stored in `param_dtype` (default: the
compute dtype, what the serving path loads); layer norms, embeddings and
the PE gate in float32. Training builds the model in float32 and casts
every frozen parameter to the compute dtype (`Whisper.cast_frozen_`, JAX
`cast_frozen_params`), so the trainable parameters stay float32 masters
that each use casts, as JAX keeps trainable leaves float32
(`train/trainer.py:72-87`).

The int8 frozen trunk (JAX `freeze_quant: int8`): `Whisper.quantize_frozen_`
replaces each frozen projection (query, key, value, out, fc1, fc2) with an
`Int8Linear` (JAX's {w_q, w_s, b}; `ops/int8_linear.py`, kernel K8), and an
MLP whose two linears are int8 runs the fused K2 (`ops/int8_mlp.py`) for
at least 256 rows and d, h multiples of 128, as JAX's `mlp_fwd` does.
`from_state_dict` builds the same structure for a state dict holding
`weight_q` buffers (a checkpoint trained that way).

PE (gated dual-QK) attention (JAX `mha(pe=True)`, the TMECS `pe_whisper`
recipes): a PE block's self-attention adds `query_cs`, `key_cs` and a
per-head `gate`, and its scores are (1 - sigmoid(gate))·q.k +
sigmoid(gate)·q_cs.k_cs; it bypasses K1 (plain full attention, as in JAX).
`cross_kv_int8` stores the precomputed cross K/V int8 with per-channel
scales (JAX `_quantize_kv`).

Thin-row int8 products (at most 32 rows, `AGACS_W8A16` on) take the W8A16
kernel K6 (`ops/int8_serve.py`), as JAX's `int8_linear` and
`fused_linears` do. A serving-quantised model (`int8_serve.
quantize_for_serving`, JAX's of the same name) also carries the int8
token table `token_emb_q`/`token_emb_s`, which the decode step's embedding
dequantises, and the int8 logits head `logits_w_q`/`logits_w_s`, which the
decode step runs through K6 whatever `AGACS_W8A16` says.

The ladder side network (reference `model.py:349-484`, JAX
`SideNetworkConfig`): `encoder_side` and `decoder_side` hold their own
narrow blocks (n_dim 192, 4 heads of 48 by default) fed by gated taps of
the trunk's layer outputs; the encoder blends its output with the trunk's
through `gate_output`, the decoder's ladder replaces the trunk's output
head (upsample + its own `ln`). Side blocks run plain attention in the
encoder (JAX's `fused_mha`; K1 takes d_head 64 only) and K3 at d_head 48
in the decode step.

On a CUDA tensor the encoder self-attention runs kernels K1f/K1b
(`ops/flash_train.py`) and the decode step's self- and cross-attention
run kernel K3 (`ops/decode_attn.py`); a beam step runs K3a (self, through
the ancestry map) and K3s (cross, one shared cache per utterance). A PE
decoder's self-attention runs K3-PE / K3a-PE, int8 cross-KV K3-int8 /
K3s-int8, the side ladder K3 at d_head 48. On a CPU tensor they take
their plain versions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agacs_tpu_torch.ops.attention import (
    einsum_mha,
    lang_col_scores,
    merge_heads,
    packed_mha,
    split_heads,
    streaming_lse,
)
from agacs_tpu_torch.ops.decode_attn import (
    decode_cache_attention,
    decode_shared_cache_attention,
    pad_time,
    TIME_ALIGN,
    TIME_ALIGN_I8,
)
from agacs_tpu_torch.ops import int8_mlp, int8_serve
from agacs_tpu_torch.ops.flash_train import D_HEAD as FLASH_D_HEAD
from agacs_tpu_torch.ops.flash_train import packed_flash_mha
from agacs_tpu_torch.ops.int8_linear import (derived, int8_linear, int8_matmul, quantize_weight,
                                             transposed)
from agacs_tpu_torch.ops.logmel import full_fp32


@dataclasses.dataclass(frozen=True)
class SideNetworkConfig:
    """Ladder side network (reference `model.py:349-484`): its width, heads
    and the trunk layers whose outputs it taps."""

    n_dim: int = 192
    n_head: int = 4
    layers: tuple[int, ...] = (0, 2, 4, 6, 8, 10)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """ModelDimensions + PET flags of the JAX WhisperConfig, without its
    TPU-only knobs (remat, layer unrolling, attention backend)."""

    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 768
    n_audio_head: int = 12
    n_audio_layer: int = 12
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 768
    n_text_head: int = 12
    n_text_layer: int = 12
    adapter: bool = False
    pe_attention: bool = False
    adapter_encoder: bool | None = None
    adapter_decoder: bool | None = None
    pe_encoder: bool | None = None
    pe_decoder: bool | None = None
    side_network: SideNetworkConfig | None = None
    compute_dtype: torch.dtype = torch.float32
    cross_kv_int8: bool = False

    def part(self, which: str) -> "WhisperConfig":
        """Effective config for 'encoder' or 'decoder' blocks: resolves the
        per-component PET overrides into the plain adapter/pe flags."""
        if which == "encoder":
            a = self.adapter if self.adapter_encoder is None else self.adapter_encoder
            p = self.pe_attention if self.pe_encoder is None else self.pe_encoder
        else:
            a = self.adapter if self.adapter_decoder is None else self.adapter_decoder
            p = self.pe_attention if self.pe_decoder is None else self.pe_decoder
        if a == self.adapter and p == self.pe_attention:
            return self
        return dataclasses.replace(self, adapter=a, pe_attention=p)

    @property
    def d_audio_head(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def d_text_head(self) -> int:
        return self.n_text_state // self.n_text_head


WHISPER_PRESETS: dict[str, dict] = {
    "tiny": dict(n_audio_state=384, n_audio_head=6, n_audio_layer=4,
                 n_text_state=384, n_text_head=6, n_text_layer=4),
    "base": dict(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                 n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": dict(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                  n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": dict(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                   n_text_state=1024, n_text_head=16, n_text_layer=24),
    "large": dict(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                  n_text_state=1280, n_text_head=20, n_text_layer=32),
    # not a real OpenAI size: a minimal config for fast CPU tests
    "test": dict(n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                 n_text_state=64, n_text_head=2, n_text_layer=2),
}


def make_config(model: str = "small", **overrides) -> WhisperConfig:
    return WhisperConfig(**{**WHISPER_PRESETS[model], **overrides})


def side_config(cfg: WhisperConfig) -> WhisperConfig:
    """The config of the side ladder's blocks (JAX `side_cfg`): no
    adapters, no PE."""
    return dataclasses.replace(cfg, adapter=False, pe_attention=False, adapter_encoder=None,
                               adapter_decoder=None, pe_encoder=None, pe_decoder=None)


def scale_query(q: torch.Tensor, d_head: int) -> torch.Tensor:
    """q * d_head**-0.5 as JAX's decode step forms it (`q * (scale *
    scale)`, a Python float times a compute-dtype array): the scale is
    rounded to q's dtype first. Exact in bf16 at d_head 64 (0.125), not at
    48 (the side ladder)."""
    return q * torch.tensor(d_head ** -0.5, dtype=q.dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class LayerNorm(nn.LayerNorm):
    """float32 layer norm with a float32 affine, output cast back to the
    input dtype (reference model.py:30-32). An affine stored in bf16 (a
    frozen one after `Whisper.cast_frozen_`) is read in float32, as JAX's
    `layer_norm` promotes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _as(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """`p` in `dtype`; `p` itself, with no dispatcher call, when it already
    is (the serving path: weights stored in the compute dtype, a decode
    step of ~250 projections)."""
    return p if p is None or p.dtype == dtype else p.to(dtype)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input's dtype at use
    (JAX `linear`): float32 trainable masters under bf16 activations;
    weights already stored in the compute dtype are used as they are."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _as(self.weight, x.dtype), _as(self.bias, x.dtype))


# Frozen linears the int8 trunk quantises, by JAX module name (JAX
# `train/trainer.py` QUANT_LINEAR_KEYS): the block projections; not the
# adapters, the embedding/logits head or the conv stem.
QUANT_LINEAR_KEYS = frozenset(
    {"query", "key", "value", "out", "fc1", "fc2", "query_cs", "key_cs"})


class Int8Linear(nn.Module):
    """A frozen linear on the int8 path (JAX `int8_linear` over {w_q, w_s,
    b}): buffers `weight_q` int8 in JAX's (in, out) layout and `weight_s`
    float32 (out,), and a frozen `bias` in its stored dtype. Where JAX's
    `mha` projects several of them from one input (`fused_linears`),
    `MultiHeadAttention` does the same (`_project`). The wide K8g forward
    on the card reads `weight_q` transposed: `weight_t` makes that copy at
    its first use and keeps it (not state) until the buffer moves or is
    written."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, bias_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(in_features, out_features,
                                                     dtype=torch.int8, device=device))
        self.register_buffer("weight_s", torch.ones(out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=bias_dtype, device=device),
                                 requires_grad=False) if bias else None
        self._t_cache: dict = {}

    @classmethod
    def quantized(cls, lin: nn.Linear) -> "Int8Linear":
        """`lin`'s weight, as stored (bf16 after `cast_frozen_`), quantised
        per output channel; its bias kept as it is."""
        mod = cls(lin.in_features, lin.out_features, bias=False, device="meta")
        w_q, w_s = quantize_weight(lin.weight.detach().t())
        mod.weight_q, mod.weight_s = w_q.contiguous(), w_s.contiguous()
        mod.bias = lin.bias
        return mod

    def weight_t(self) -> torch.Tensor:
        """weight_q^T, contiguous (`int8_linear.transposed`)."""
        return transposed(self.weight_q, cache=self._t_cache)[0]

    def _apply(self, fn, *args, **kwargs):
        self._t_cache.clear()  # a moved buffer drops its copy at once
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.weight_q, self.weight_s, self.bias, self.weight_t)


class MLP(nn.Sequential):
    """`mlp_fwd` (:490): fc1 (child 0), exact GELU, fc2 (child 2). When both
    linears are int8, at least `int8_mlp.TR` rows with d and h multiples of
    128 run the fused int8 MLP (K2); other row counts (a decode step's 8 or
    40 rows) take the unfused int8 linears. On the card K2 reads the int8
    weights transposed: `k2_weights` keeps those copies (not state)."""

    def __init__(self, *mods: nn.Module):
        super().__init__(*mods)
        self._k2_cache: dict = {}

    def k2_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """fc1's and fc2's int8 weights transposed (K2's K-major operands),
        kept until a buffer moves or is written (`int8_linear.transposed`)."""
        return transposed(self[0].weight_q, self[2].weight_q, cache=self._k2_cache)

    tp = None  # `parallel/tensor_parallel.TensorParallel` when fc1 / fc2 are sharded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1, fc2 = self[0], self[2]
        if self.tp is not None:  # unfused under tensor parallelism (K8 each)
            return self.tp.row(fc2, self[1](self.tp.col(fc1, self.tp.copy_in(x))))
        if (isinstance(fc1, Int8Linear) and isinstance(fc2, Int8Linear)
                and x.numel() // x.shape[-1] >= int8_mlp.TR
                and int8_mlp.supports(fc1.in_features, fc1.out_features)):
            return int8_mlp.int8_mlp(x, fc1.weight_q, fc1.weight_s, fc1.bias,
                                     fc2.weight_q, fc2.weight_s, fc2.bias,
                                     self.k2_weights() if x.is_cuda else None)
        return fc2(self[1](fc1(x)))


def fused_linears(x: torch.Tensor, mods: list[nn.Module], cache: dict,
                  tp=None) -> list[torch.Tensor]:
    """JAX `fused_linears` (:190): int8 projections of one input as ONE
    product over their concatenated weights (kept in `cache` by `derived`,
    with the concatenation transposed once a wide K8g forward on the card
    has read it), each output plus its bias; dense ones each on its own.
    Thin rows under `AGACS_W8A16` take K6 on the concatenation, as JAX's
    int8 branch does. The
    forward gives the numbers of separate products (the row scale depends
    on x alone), but the backward does not: its dgrad row-quantises the
    concatenated output gradient [dq | dk | dv] with one scale per row, so
    the fusion is kept for parity with JAX's gradients. Under tensor
    parallelism (`tp`) the concatenation is of this rank's column shards
    and the dgrad's row scale the maximum over every rank's."""
    if not all(isinstance(m, Int8Linear) for m in mods):
        return [m(x) for m in mods]
    weights = tuple(t for m in mods for t in (m.weight_q, m.weight_s))
    cat = derived(cache, weights, lambda: (torch.cat([m.weight_q for m in mods], 1),
                                           torch.cat([m.weight_s for m in mods]), {}))

    def cat_t():
        return derived(cat[2], (cat[0],), lambda: cat[0].t().contiguous())

    if tp is not None:
        y = tp.int8_col(x, cat[0], cat[1], cat_t)
    elif int8_serve.thin_rows(x) and int8_serve.fits(cat[0]):  # JAX :203-210
        y = int8_serve.w8a16_matmul(x, cat[0], cat[1])
    else:
        y = int8_matmul(x, cat[0], cat[1], cat_t)
    outs = y.split([m.weight_q.shape[1] for m in mods], -1)
    return [o.contiguous() if m.bias is None else o + m.bias.to(o.dtype)
            for o, m in zip(outs, mods)]


def _jax_module_name(parent: nn.Module, child: str) -> str:
    return {"0": "fc1", "2": "fc2"}.get(child, child) if isinstance(parent, MLP) else child


class Conv1d(nn.Conv1d):
    """nn.Conv1d with the same cast at use (JAX `conv1d`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _as(self.weight, x.dtype), _as(self.bias, x.dtype))


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Sinusoidal positions (model.py:53-59); a constant, not a parameter."""
    assert channels % 2 == 0
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    """`mha` (:352).

    Non-causal self-attention (the encoder) goes through `packed_flash_mha`
    on the packed (B, T, D) projections (kernels K1f/K1b on the card) at
    d_head 64, and the plain `packed_mha` at any other width.
    Cross-attention (the teacher-forced form; the decode step has its own
    cached path) and the decoder's causal self-attention (`causal_self`)
    are the head-split plain attention with d_head**-0.25 on q and k.

    With `pe` (JAX `_init_attn(pe=True)`): `query_cs` (with bias),
    `key_cs` (without) and `gate` (n_head,) float32; the scores become
    (1 - g)·q.k + g·q_cs.k_cs with g = sigmoid(gate) in float32 per head
    (JAX `mha` :454-482), in the plain attention, for the encoder too.

    Under tensor parallelism (`tp`, `parallel/tensor_parallel.py`) the
    projections hold this rank's heads (`n_head` of them, `head_slice` of
    the whole), `out` its rows; the input goes through `tp.copy_in` and the
    output is all-reduced."""

    tp = None

    def __init__(self, d: int, n_head: int, dtype: torch.dtype, device=None,
                 pe: bool = False):
        super().__init__()
        self.n_head = n_head
        self.d_head = d // n_head
        self.head_slice = slice(0, n_head)
        self.pe = pe
        kw = dict(dtype=dtype, device=device)
        self.query = Linear(d, d, **kw)
        self.key = Linear(d, d, bias=False, **kw)
        self.value = Linear(d, d, **kw)
        self.out = Linear(d, d, **kw)
        if pe:
            self.query_cs = Linear(d, d, **kw)
            self.key_cs = Linear(d, d, bias=False, **kw)
            self.gate = nn.Parameter(torch.zeros(n_head, device=device))
        self._fused: dict = {}  # concatenated int8 weights (`fused_linears`)

    def _apply(self, fn, *args, **kwargs):
        self._fused.clear()  # moved buffers drop their concatenations at once
        return super()._apply(fn, *args, **kwargs)

    def _in(self, x: torch.Tensor | None) -> torch.Tensor | None:
        return x if self.tp is None or x is None else self.tp.copy_in(x)

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        return self.out(o) if self.tp is None else self.tp.row(self.out, o)

    def _project(self, x: torch.Tensor, xa: torch.Tensor | None = None):
        """q, k, v as JAX `mha` (:389-396) forms them: self-attention fuses
        the three projections, cross-attention the key and value of xa.
        Under tensor parallelism x (and xa) must have gone through `_in`."""
        if xa is None:
            return fused_linears(x, [self.query, self.key, self.value], self._fused, self.tp)
        q = self.query(x) if self.tp is None else self.tp.col(self.query, x)
        return (q, *fused_linears(xa, [self.key, self.value], self._fused, self.tp))

    def gate_probs(self) -> torch.Tensor:
        """sigmoid(gate) in float32 (n_head,), the PE mix weight per head
        (this rank's heads under tensor parallelism)."""
        g = self.gate.float()
        return torch.sigmoid(g if self.tp is None else self.tp.copy_in(g)[self.head_slice])

    def _pe_attention(self, x: torch.Tensor, causal: bool):
        """PE self-attention over x (B, T, d): (merged output before `out`,
        mixed pre-softmax scores (B, h, T, T) float32, -inf where causally
        masked, and their softmax)."""
        sc = self.d_head ** -0.25
        x = self._in(x)
        q, k, v = self._project(x)
        cs = [m(x) if self.tp is None else self.tp.col(m, x)
              for m in (self.query_cs, self.key_cs)]
        qk = torch.einsum("bhqd,bhkd->bhqk", split_heads(q, self.n_head) * sc,
                          split_heads(k, self.n_head) * sc).float()
        qk_cs = torch.einsum("bhqd,bhkd->bhqk",
                             split_heads(cs[0], self.n_head) * sc,
                             split_heads(cs[1], self.n_head) * sc).float()
        g = self.gate_probs().view(1, -1, 1, 1)
        qk = (1.0 - g) * qk + g * qk_cs
        if causal:
            t = qk.shape[-1]
            qk = qk + torch.full((t, t), float("-inf"), device=qk.device).triu(1)
        w = torch.softmax(qk, dim=-1)
        vh = split_heads(v, self.n_head)
        return merge_heads(torch.einsum("bhqk,bhkd->bhqd", w.to(vh.dtype), vh)), qk, w

    def cross_with_scores(self, x: torch.Tensor, xa: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention of x over xa with its pre-softmax scores (B, h,
        T, T_audio) float32 (JAX `mha(..., full_scores=True)`, what word
        timing reads): the (T, T_audio) map is formed, softmax in float32."""
        sc = self.d_head ** -0.25
        q, k, v = self._project(self._in(x), self._in(xa))
        qk = torch.einsum("bhqd,bhkd->bhqk", split_heads(q, self.n_head) * sc,
                          split_heads(k, self.n_head) * sc).float()
        w = torch.softmax(qk, dim=-1)
        vh = split_heads(v, self.n_head)
        o = torch.einsum("bhqk,bhkd->bhqd", w.to(vh.dtype), vh)
        return self._out(merge_heads(o)), qk

    def forward(self, x: torch.Tensor, xa: torch.Tensor | None = None) -> torch.Tensor:
        if self.pe:
            return self._out(self._pe_attention(x, causal=False)[0])
        q, k, v = self._project(self._in(x), self._in(xa))
        # K1 takes d_head 64 (JAX `flash_train.supports`); the side
        # ladder's narrower heads take the plain attention, as JAX's
        # `fused_mha` does off the TPU's flash shapes
        flash = xa is None and q.shape[-1] == self.n_head * FLASH_D_HEAD
        attend = packed_flash_mha if flash else packed_mha
        return self._out(attend(q, k, v, self.n_head))

    def causal_self(self, x: torch.Tensor, lang_cols: bool = False,
                    need_probs: bool = False, full_scores: bool = False
                    ) -> tuple[torch.Tensor, dict]:
        """Causal self-attention (-inf above the diagonal) and its aux
        (`mha` :398-482). With `lang_cols`, "qk_cols": the pre-softmax
        scores at key columns 1:3 (B, h, T, 2), computed analytically
        against the two language-token keys, and with `need_probs` also
        "p_cols" = exp(qk_cols - lse), lse from `streaming_lse`, so no
        (T, T) map is kept for them. With `full_scores` the (T, T) scores
        are formed: "qk_full" (B, h, T, T), -inf where causally masked, and
        the language columns are sliced from it and from its softmax. A PE
        block always forms the (T, T) mix: "qk_cols" and "p_cols" are its
        columns before and after the softmax, "qk_full" the post-softmax
        map (what the reference's PE block returns)."""
        aux = {}
        if self.pe:
            o, qk, w = self._pe_attention(x, causal=True)
            if lang_cols:
                aux["qk_cols"], aux["p_cols"] = qk[..., 1:3], w[..., 1:3]
            if full_scores:
                aux["qk_full"] = w
            return self._out(o), aux
        sc = self.d_head ** -0.25
        q, k, v = self._project(self._in(x))
        qh = split_heads(q, self.n_head) * sc
        kh = split_heads(k, self.n_head) * sc
        vh = split_heads(v, self.n_head)
        if not full_scores:
            o = einsum_mha(qh, kh, vh, causal=True)
            if lang_cols:
                aux["qk_cols"] = lang_col_scores(qh, kh)
                if need_probs:
                    lse = streaming_lse(qh, kh, causal=True)
                    aux["p_cols"] = torch.exp(aux["qk_cols"] - lse[..., None])
            return self._out(merge_heads(o)), aux
        qk = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float()
        t = qk.shape[-1]
        qk = qk + torch.full((t, t), float("-inf"), device=qk.device).triu(1)
        w = torch.softmax(qk, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", w.to(vh.dtype), vh)
        aux["qk_full"] = qk
        if lang_cols:
            aux["qk_cols"], aux["p_cols"] = qk[..., 1:3], w[..., 1:3]
        return self._out(merge_heads(o)), aux


class Adapter(nn.Module):
    """Bottleneck adapter with residual (model.py:181-194); under tensor
    parallelism (`tp`) the down projection column-, the up row-parallel."""

    tp = None

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.model = nn.Sequential(
            Linear(d, d // 4, **kw), nn.GELU(), Linear(d // 4, d, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            down, act, up = self.model
            return x + self.tp.row(up, act(down(self.tp.copy_in(x))))
        return x + self.model(x)


class ResidualAttentionBlock(nn.Module):
    """`residual_block` (:506): self-attn [+adapter+ln] [+cross-attn] + mlp
    [+adapter+ln]. `forward` runs a whole sequence (the encoder, and the
    teacher-forced decoder with causal self-attention); decoder blocks run
    `step` for one cached token."""

    def __init__(self, d: int, n_head: int, cfg: WhisperConfig, cross: bool,
                 device=None, dtype: torch.dtype | None = None):
        super().__init__()
        dtype = dtype or cfg.compute_dtype
        kw = dict(dtype=dtype, device=device)
        self.n_head = n_head
        self.attn = MultiHeadAttention(d, n_head, dtype, device, pe=cfg.pe_attention)
        self.attn_ln = LayerNorm(d, device=device)
        self.cross_attn = MultiHeadAttention(d, n_head, dtype, device) if cross else None
        self.cross_attn_ln = LayerNorm(d, device=device) if cross else None
        self.mlp = MLP(Linear(d, 4 * d, **kw), nn.GELU(), Linear(4 * d, d, **kw))
        self.mlp_ln = LayerNorm(d, device=device)
        self.adapter = cfg.adapter
        if cfg.adapter:
            self.adapter_attn = Adapter(d, dtype, device)
            self.adapter_attn_ln = LayerNorm(d, device=device)
            self.adapter_mlp = Adapter(d, dtype, device)
            self.adapter_mlp_ln = LayerNorm(d, device=device)

    def forward(self, x: torch.Tensor, xa: torch.Tensor | None = None,
                lang_cols: bool = False, need_probs: bool = False,
                full_scores: bool = False, cross_scores: bool = False
                ) -> tuple[torch.Tensor, dict]:
        """x (B, T, d) -> (x, aux). Encoder blocks: non-causal
        self-attention, aux empty. Decoder blocks: causal self-attention
        over x, cross-attention over xa (B, T_audio, d), and the
        self-attention aux of `MultiHeadAttention.causal_self`; with
        `cross_scores` also aux["cross_qk"], the cross-attention's
        pre-softmax scores (B, h, T, T_audio)."""
        aux = {}
        if self.cross_attn is None:
            x = x + self.attn(self.attn_ln(x))
        else:
            a, aux = self.attn.causal_self(self.attn_ln(x), lang_cols, need_probs,
                                           full_scores)
            x = x + a
        if self.adapter:
            x = self.adapter_attn_ln(self.adapter_attn(x))
        if self.cross_attn is not None and cross_scores:
            c, aux["cross_qk"] = self.cross_attn.cross_with_scores(self.cross_attn_ln(x), xa)
            x = x + c
        elif self.cross_attn is not None:
            x = x + self.cross_attn(self.cross_attn_ln(x), xa)
        x = x + self.mlp(self.mlp_ln(x))
        if self.adapter:
            x = self.adapter_mlp_ln(self.adapter_mlp(x))
        return x, aux

    def step(self, h, pos: int, layer: int, self_kv: dict, cross_kv: dict,
             anc_local: torch.Tensor | None = None, beam_groups: int = 1,
             prefix: str = ""):
        """One decode token through decoder block `layer`: h (N, d).
        `prefix` "side_" reads the side ladder's caches ("side_k",
        "side_v", "side_k_packed", "side_v_packed") in place of the
        trunk's.

        Writes this position's k/v (PE: and k_cs) row into the layer's
        caches IN PLACE before the attention reads them (write-first, as in
        the JAX step). With `beam_groups` j > 1 the N = G*j rows are G
        utterances' beams: the self-attention reads through `anc_local`
        (N, Tp) when given (K3a, else its own rows) and the cross-attention
        reads each utterance's un-repeated (G, Tp, d) cross-KV once for its
        j queries (K3s). A PE block passes q_cs, k_cs and sigmoid(gate)
        (K3-PE / K3a-PE); int8 cross-KV passes its scales (K3-int8 /
        K3s-int8)."""
        d_head = h.shape[-1] // self.n_head
        a = self.attn
        y = self.attn_ln(h)
        k_cache, v_cache = self_kv[prefix + "k"][layer], self_kv[prefix + "v"][layer]
        k_cache[:, pos] = a.key(y)
        v_cache[:, pos] = a.value(y)
        pe = {}
        if a.pe:
            k_cs = self_kv["k_cs"][layer]
            k_cs[:, pos] = a.key_cs(y)
            pe = dict(q_cs=scale_query(a.query_cs(y), d_head), k_cs=k_cs,
                      gate=a.gate_probs())
        o = decode_cache_attention(scale_query(a.query(y), d_head), k_cache, v_cache, pos,
                                   self.n_head, anc_local=anc_local, beam=beam_groups, **pe)
        h = h + a.out(o)
        if self.adapter:
            h = self.adapter_attn_ln(self.adapter_attn(h))
        c = self.cross_attn
        qc = scale_query(c.query(self.cross_attn_ln(h)), d_head)
        cross_k = cross_kv[prefix + "k_packed"][layer]
        cross_v = cross_kv[prefix + "v_packed"][layer]
        quant = {}
        if not prefix and "k_scale" in cross_kv:
            quant = dict(k_scale=cross_kv["k_scale"][layer],
                         v_scale=cross_kv["v_scale"][layer])
        t_audio = cross_kv["t_audio"]
        if beam_groups > 1:
            oc = decode_shared_cache_attention(qc, cross_k, cross_v, t_audio - 1,
                                               self.n_head, beam_groups, **quant)
        else:
            oc = decode_cache_attention(qc, cross_k, cross_v, t_audio - 1, self.n_head,
                                        **quant)
        h = h + c.out(oc)
        h = h + self.mlp(self.mlp_ln(h))
        if self.adapter:
            h = self.adapter_mlp_ln(self.adapter_mlp(h))
        return h


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class WhisperEncoder(nn.Module):
    """`whisper_encode` (:709): conv stem, sinusoid positions, blocks, ln_post.
    Under tensor parallelism (`tp`) conv1 holds this rank's output
    channels and conv2 its input channels."""

    tp = None

    def __init__(self, cfg: WhisperConfig, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_audio_state
        kw = dict(dtype=dtype or cfg.compute_dtype, device=device)
        self.conv1 = Conv1d(cfg.n_mels, d, 3, padding=1, **kw)
        self.conv2 = Conv1d(d, d, 3, stride=2, padding=1, **kw)
        self.register_buffer(
            "positional_embedding",
            torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)).to(device,
                                                                cfg.compute_dtype),
            persistent=False,
        )
        enc_cfg = cfg.part("encoder")
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cfg.n_audio_head, enc_cfg, cross=False,
                                   device=device, dtype=dtype)
            for _ in range(cfg.n_audio_layer)
        )
        self.ln_post = LayerNorm(d, device=device)

    def forward(self, mel: torch.Tensor, side: "EncoderSide | None" = None) -> torch.Tensor:
        """mel (B, T_frames, n_mels) -> (B, min(ceil(T/2), n_audio_ctx), d).
        Frames beyond n_audio_ctx * 2 are cropped (> 30 s inputs). With
        `side` the output is blended with the side ladder's (JAX :749-771)."""
        x = mel.to(self.cfg.compute_dtype).transpose(1, 2)  # (B, n_mels, T)
        with full_fp32():
            if self.tp is None:
                x = F.gelu(self.conv2(F.gelu(self.conv1(x))))
            else:
                x = F.gelu(self.tp.row_conv(self.conv2, F.gelu(self.conv1(self.tp.copy_in(x)))))
        x = x.transpose(1, 2)[:, : self.cfg.n_audio_ctx].contiguous()
        x = x + self.positional_embedding[: x.shape[1]]
        x_embed, layer_outs = x, []  # the ladder's taps, kept only for a side
        for block in self.blocks:
            x, _ = block(x)
            if side is not None:
                layer_outs.append(x)
        out = self.ln_post(x)
        return out if side is None else side(x_embed, layer_outs, out)


class WhisperDecoder(nn.Module):
    """Token/position embeddings, decoder blocks and the output head.

    The embeddings are stored float32 (bf16 once `Whisper.cast_frozen_`
    casts them frozen); emb + pos are added in their stored dtype before
    the cast to the compute dtype, as in JAX (`embed`). The logits use the
    table in the compute dtype (`logits_w`): a copy kept while the table is
    frozen (`derived`), a cast in the forward when it trains, so the copy
    is never stale. Under tensor parallelism (`tp`) the table holds this
    rank's rows of the padded vocabulary: the lookup sums the ranks' rows
    and the logits are gathered and cut back to n_vocab (JAX :853-856)."""

    tp = None

    def __init__(self, cfg: WhisperConfig, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_text_state
        self.token_embedding = nn.Embedding(cfg.n_vocab, d, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.n_text_ctx, d, device=device))
        dec_cfg = cfg.part("decoder")
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cfg.n_text_head, dec_cfg, cross=True,
                                   device=device, dtype=dtype)
            for _ in range(cfg.n_text_layer)
        )
        self.ln = LayerNorm(d, device=device)
        for name in INT8_HEAD:  # set by `set_int8_head`
            self.register_buffer(name, None)
        self._logits_cache: dict = {}

    def _apply(self, fn, *args, **kwargs):
        self._logits_cache.clear()  # a moved table drops its copy at once
        return super()._apply(fn, *args, **kwargs)

    def embed(self, tokens: torch.Tensor, pos, int8_head: bool = False) -> torch.Tensor:
        """token_emb[tokens] + pos_emb[pos] in the stored dtypes (two bf16
        leaves sum in bf16, as JAX's `whisper_decode` :815 and
        `whisper_decode_step` :1122 do), then the compute dtype. With
        `int8_head` and a serving-quantised table (the decode step, JAX
        :1113-1117) the looked-up rows are f32(q[tokens]) * s[tokens]."""
        if int8_head and self.token_emb_q is not None:
            emb = self.token_emb_q[tokens].float() * self.token_emb_s[tokens][..., None]
        elif self.tp is not None:
            emb = self.tp.vocab_embed(self.token_embedding.weight, tokens)
        else:
            emb = self.token_embedding(tokens)
        return (emb + self.positional_embedding[pos]).to(self.cfg.compute_dtype)

    def set_int8_head(self, token_emb_q, token_emb_s, logits_w_q, logits_w_s) -> None:
        """Carry the serving-quantised token table and logits head
        (`int8_serve.quantize_for_serving`): (V, d) int8 + (V,) f32 and
        (d, Vp) int8 + (Vp,) f32, as buffers on the table's device."""
        dev = self.token_embedding.weight.device
        self.token_emb_q, self.token_emb_s = token_emb_q.to(dev), token_emb_s.to(dev)
        self.logits_w_q, self.logits_w_s = logits_w_q.to(dev), logits_w_s.to(dev)

    def logits(self, h: torch.Tensor, int8_head: bool = False) -> torch.Tensor:
        """float32 (..., n_vocab) logits of the final hidden states: with
        `int8_head` and an int8 logits head (the decode step, JAX
        :1362-1370), K6 over `logits_w_q`, sliced to n_vocab in float32;
        else ln(x) @ emb^T in the compute dtype, then float32."""
        if int8_head and self.logits_w_q is not None:
            y = int8_serve.w8a16_matmul(h, self.logits_w_q, self.logits_w_s)
            return y.float()[..., : self.cfg.n_vocab]
        if self.tp is not None:
            y = self.tp.gather_last(F.linear(self.tp.copy_in(h), self.logits_w()))
            return y.float()[..., : self.cfg.n_vocab]
        return F.linear(h, self.logits_w()).float()

    def logits_w(self) -> torch.Tensor:
        """The output head's weight in the compute dtype: cast in the
        forward when the table takes a gradient, else the kept copy, made
        anew when the table has changed since (an optimizer step)."""
        w = self.token_embedding.weight
        dtype = self.cfg.compute_dtype
        if w.requires_grad and torch.is_grad_enabled():
            return w.to(dtype)
        return derived(self._logits_cache, (w,), lambda: w.detach().to(dtype))


INT8_HEAD = ("token_emb_q", "token_emb_s", "logits_w_q", "logits_w_s")


def _blend(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(1 - sigmoid(g)) * a + sigmoid(g) * b, the gate cast to a's dtype
    (JAX `(1.0 - g) * down + g * h_side`)."""
    g = torch.sigmoid(g).to(a.dtype)
    return (1.0 - g) * a + g * b


class _Side(nn.Module):
    """What both side ladders share (JAX `_init_encoder_side` :654,
    `_init_decoder_side` :679): `downsample_input` (d -> n_dim), one
    `downsample_layers` tap per ladder block, the per-block `gates`
    (float32, sigmoid at use), the narrow `blocks` and `upsample_output`
    (n_dim -> d). Under tensor parallelism (`tp`) the downsamples are
    column-parallel and gathered, the upsample row-parallel."""

    tp = None

    def __init__(self, cfg: WhisperConfig, d: int, cross: bool, device, dtype):
        super().__init__()
        sc = cfg.side_network
        n = len(sc.layers)
        kw = dict(dtype=dtype or cfg.compute_dtype, device=device)
        self.layers = sc.layers
        self.downsample_input = Linear(d, sc.n_dim, **kw)
        self.downsample_layers = nn.ModuleList(Linear(d, sc.n_dim, **kw) for _ in range(n))
        self.gates = nn.Parameter(torch.zeros(n, device=device))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(sc.n_dim, sc.n_head, side_config(cfg), cross=cross,
                                   device=device, dtype=dtype) for _ in range(n))
        self.upsample_output = Linear(sc.n_dim, d, **kw)

    def tap(self, i: int, trunk_h: torch.Tensor, h_side: torch.Tensor) -> torch.Tensor:
        """Ladder block i's input: the gated mix of the trunk's tapped layer
        output (downsampled) and the ladder so far."""
        return _blend(self.gates[i], self.down(self.downsample_layers[i], trunk_h), h_side)

    def down(self, lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return lin(x) if self.tp is None else self.tp.col_gather(lin, x)

    def up(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.upsample_output(x)
        return self.tp.row_scatter(self.upsample_output, x)


class EncoderSide(_Side):
    """The encoder's side ladder (JAX `whisper_encode` :749-771): over the
    post-position trunk input and the trunk's layer outputs, then
    `upsample_output`, `ln_post`, and the output blend through
    `gate_output`."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype: torch.dtype | None = None):
        super().__init__(cfg, cfg.n_audio_state, False, device, dtype)
        self.ln_post = LayerNorm(cfg.n_audio_state, device=device)
        self.gate_output = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x_embed, layer_outs, out):
        h = self.down(self.downsample_input, x_embed)
        for i, layer in enumerate(self.layers):
            h, _ = self.blocks[i](self.tap(i, layer_outs[layer], h))
        h = self.ln_post(self.up(h))
        return _blend(self.gate_output[0], out, h)


class DecoderSide(_Side):
    """The decoder's side ladder (JAX `_decoder_side_fwd` :875-915): causal
    blocks with cross-attention over `downsample_encoder_input(xa)`; its
    `upsample_output` and `ln` replace the trunk's output head."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype: torch.dtype | None = None):
        super().__init__(cfg, cfg.n_text_state, True, device, dtype)
        self.downsample_encoder_input = Linear(
            cfg.n_text_state, cfg.side_network.n_dim,
            dtype=dtype or cfg.compute_dtype, device=device)
        self.ln = LayerNorm(cfg.n_text_state, device=device)

    def forward(self, x_embed, layer_outs, xa):
        h = self.down(self.downsample_input, x_embed)
        xa_side = self.down(self.downsample_encoder_input, xa)
        for i, layer in enumerate(self.layers):
            h, _ = self.blocks[i](self.tap(i, layer_outs[layer], h), xa_side)
        return self.ln(self.up(h))

    def step(self, x_embed, trunk_outs, pos: int, self_kv: dict, cross_kv: dict):
        """One cached token through the ladder (JAX `_side_decode_step`
        :1376-1452): each block writes its row of "side_k"/"side_v" and
        reads them and the precomputed "side_k_packed"/"side_v_packed"
        through K3 at the ladder's head width."""
        h = self.downsample_input(x_embed)
        for i, layer in enumerate(self.layers):
            h = self.blocks[i].step(self.tap(i, trunk_outs[layer], h), pos, i, self_kv,
                                    cross_kv, prefix="side_")
        return self.ln(self.upsample_output(h))


class Whisper(nn.Module):
    """With `ctc`, also the CTC head `ctc` (n_audio_state -> n_vocab; JAX's
    (d, V) `ctc/w` transposed) that a nonzero ctc_weight trains. With
    `estimate_c`, also `estimated_c_val` (1,) float32, the CS loss's
    learnable target (JAX `init_asr_params` :131-132); decoding ignores it.
    `parallel/tensor_parallel.shard_whisper` sets `tp` and `tp_dims` (the
    sharded tensors' dims) on a model it cuts."""

    tp = None

    def __init__(self, cfg: WhisperConfig, device=None,
                 param_dtype: torch.dtype | None = None, ctc: bool = False,
                 estimate_c: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg, device, param_dtype)
        self.decoder = WhisperDecoder(cfg, device, param_dtype)
        if cfg.side_network is not None:
            self.encoder_side = EncoderSide(cfg, device, param_dtype)
            self.decoder_side = DecoderSide(cfg, device, param_dtype)
        if ctc:
            self.ctc = nn.Linear(cfg.n_audio_state, cfg.n_vocab, device=device,
                                 dtype=param_dtype or cfg.compute_dtype)
        if estimate_c:
            self.estimated_c_val = nn.Parameter(torch.zeros(1, device=device))

    @classmethod
    def from_state_dict(cls, cfg: WhisperConfig, state_dict: dict,
                        device=None, param_dtype: torch.dtype | None = None
                        ) -> "Whisper":
        """Build on `device` and load (casting to `param_dtype`, by default
        the compute dtype, once)."""
        model = cls(cfg, device, param_dtype, ctc="ctc.weight" in state_dict,
                    estimate_c="estimated_c_val" in state_dict)
        int8 = {k[: -len(".weight_q")] for k in state_dict if k.endswith(".weight_q")}
        if int8:
            model.int8_structure_(int8)
        if "decoder.token_emb_q" in state_dict:
            model.decoder.set_int8_head(*(state_dict["decoder." + n] for n in INT8_HEAD))
        model.load_state_dict(state_dict)
        return model.eval()

    def cast_frozen_(self, dtype: torch.dtype) -> "Whisper":
        """Store every frozen (requires_grad False) float32 parameter in
        `dtype`, IN PLACE, as JAX's `cast_frozen_params` stores every frozen
        float32 leaf (`train/trainer.py:72-87`): linears, the conv stem,
        layer norms, the embeddings and the PE gate. What trains stays a
        float32 master."""
        for p in self.parameters():
            if not p.requires_grad and p.dtype == torch.float32:
                p.data = p.data.to(dtype)
        return self

    def _int8_sites(self):
        """(parent, child name, full name, Linear) of every Linear a JAX
        QUANT_LINEAR_KEYS name could quantise."""
        for pname, parent in list(self.named_modules()):
            for cname, child in list(parent.named_children()):
                if (isinstance(child, nn.Linear)
                        and _jax_module_name(parent, cname) in QUANT_LINEAR_KEYS):
                    yield parent, cname, f"{pname}.{cname}" if pname else cname, child

    def quantize_frozen_(self) -> "Whisper":
        """JAX `quantize_frozen_linears`, IN PLACE: each frozen Linear under a
        QUANT_LINEAR_KEYS name becomes an `Int8Linear` quantised from its
        weight as stored, so after `cast_frozen_` from the bf16 values, as
        in JAX. Trainable linears (the adapters' down/up are not eligible
        anyway) stay as they are; state-dict names keep their module paths
        (`encoder.blocks.0.mlp.0.weight_q`)."""
        for parent, cname, _, lin in self._int8_sites():
            if not lin.weight.requires_grad:
                setattr(parent, cname, Int8Linear.quantized(lin))
        return self

    def int8_structure_(self, names: set[str]) -> "Whisper":
        """Empty `Int8Linear`s in place of the Linears named in `names`
        (module paths), for loading a state dict of an int8 trunk."""
        missing = set(names)
        for parent, cname, full, lin in self._int8_sites():
            if full in missing:
                missing.discard(full)
                setattr(parent, cname, Int8Linear(
                    lin.in_features, lin.out_features, lin.bias is not None,
                    device=lin.weight.device,
                    bias_dtype=lin.bias.dtype if lin.bias is not None else torch.float32))
        if missing:
            raise KeyError(f"no quantisable linear at {sorted(missing)[:3]}")
        return self


def whisper_encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    return model.encoder(mel, getattr(model, "encoder_side", None))


def whisper_decode(
    model: Whisper,
    tokens: torch.Tensor,
    audio_feats: torch.Tensor,
    src_layer: int = 0,
    collect_lang_cols: bool = False,
    collect_full_maps: bool = False,
    need_probs: bool = False,
    collect_cross_maps: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Teacher-forced decoder forward (`whisper_decode` :785-872).

    tokens (B, T) sos-prefixed ids; audio_feats (B, T_audio, d). Returns
    the (B, T, n_vocab) float32 logits (ln(x) @ emb^T in the compute
    dtype, then float32) and aux, each entry stacked over layers
    src_layer..L-1 (the reference's `torch.stack(attention_scores)`):
    with `collect_lang_cols`, aux["qk_cols"] (L', B, h, T, 2), each layer's
    pre-softmax self-attention scores at the language columns 1:3, -inf
    where causally masked, and with `need_probs` aux["p_cols"], the same
    columns after the softmax; with `collect_full_maps`, aux["maps"]
    (L', B, h, T, T), the pre-softmax scores, -inf where masked. A PE
    decoder always returns "p_cols" with its columns (the CS loss reads
    them), and its "maps" are post-softmax (JAX :479-481, :863-864). With
    `collect_cross_maps`, aux["cross_maps"] (L, B, h, T, T_audio), every
    layer's pre-softmax cross-attention scores (JAX :869-871; word timing
    reads them); that cross-attention is the plain one. With
    a side network the decoder's side ladder, fed by every trunk layer's
    output, replaces the trunk's `ln` (JAX :845-848); the aux stays the
    trunk's."""
    dec = model.decoder
    x = dec.embed(tokens, slice(0, tokens.shape[1]))
    xa = audio_feats.to(model.cfg.compute_dtype)
    side = getattr(model, "decoder_side", None)
    x_embed, layer_outs, auxs = x, [], []
    for block in dec.blocks:
        x, a = block(x, xa, lang_cols=collect_lang_cols, need_probs=need_probs,
                     full_scores=collect_full_maps, cross_scores=collect_cross_maps)
        if side is not None:
            layer_outs.append(x)
        auxs.append(a)
    x = dec.ln(x) if side is None else side(x_embed, layer_outs, xa)
    logits = dec.logits(x)

    def stacked(key):
        return torch.stack([a[key] for a in auxs[src_layer:]])

    aux = {}
    if collect_lang_cols:
        aux["qk_cols"] = stacked("qk_cols")
        if need_probs or model.cfg.part("decoder").pe_attention:
            aux["p_cols"] = stacked("p_cols")
    if collect_full_maps:
        aux["maps"] = stacked("qk_full")
    if collect_cross_maps:
        aux["cross_maps"] = torch.stack([a["cross_qk"] for a in auxs])
    return logits, aux


def encoder_olens(ilens_frames: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """Output lengths after the stride-2 conv stem, clamped at n_audio_ctx."""
    return torch.clamp(1 + (ilens_frames - 1) // 2, max=cfg.n_audio_ctx)


def init_whisper_params(generator: torch.Generator, cfg: WhisperConfig) -> dict:
    """Random float32 state dict, on the generator's device (a CUDA
    generator makes whisper-large's 1.55B values on the card), with the JAX
    init's distributions: linears uniform(±1/sqrt(d_in)), layer norms 1/0,
    conv stem normal/sqrt(3·d_in) with zero bias, PE gates uniform(0, 1),
    the side ladders' gates and gate_output uniform(-1, 1), token_emb
    normal·0.02, pos_emb normal·0.01. Numbers differ from the JAX init
    (another generator)."""
    sd = {}
    dev = generator.device
    meta = Whisper(cfg, device="meta")

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    for name, mod in meta.named_modules():
        pre = name + "."
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            sd[pre + "weight"] = (rand(mod.weight.shape) * 2 - 1) * bound
            if mod.bias is not None:
                sd[pre + "bias"] = (rand(mod.bias.shape) * 2 - 1) * bound
        elif isinstance(mod, nn.LayerNorm):
            sd[pre + "weight"] = torch.ones(mod.weight.shape, device=dev)
            sd[pre + "bias"] = torch.zeros(mod.bias.shape, device=dev)
        elif isinstance(mod, nn.Conv1d):
            c_out, c_in, w = mod.weight.shape
            sd[pre + "weight"] = randn(mod.weight.shape) / math.sqrt(w * c_in)
            sd[pre + "bias"] = torch.zeros(c_out, device=dev)
        elif isinstance(mod, MultiHeadAttention) and mod.pe:
            sd[pre + "gate"] = rand(mod.n_head)
        elif isinstance(mod, _Side):
            sd[pre + "gates"] = rand(len(mod.layers)) * 2 - 1
            if isinstance(mod, EncoderSide):
                sd[pre + "gate_output"] = rand(1) * 2 - 1
    sd["decoder.token_embedding.weight"] = randn(cfg.n_vocab, cfg.n_text_state) * 0.02
    sd["decoder.positional_embedding"] = randn(cfg.n_text_ctx, cfg.n_text_state) * 0.01
    return sd


# ---------------------------------------------------------------------------
# KV-cached decoding
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX `_quantize_kv` (:925-932): symmetric per-channel int8 of a
    (B, T, d) buffer, one scale per channel over the whole batch and every
    (padded) time row: max |x| / 127 floored at 1e-8, round half to even,
    clipped to +-127. -> (int8 values, (d,) float32 scales)."""
    xf = x.float()
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can miss the quotient by an ulp
    s = torch.clamp(xf.abs().amax(dim=(0, 1)) / torch.full((), 127.0, device=x.device),
                    min=1e-8)
    return torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8), s


def precompute_cross_kv(model: Whisper, audio_feats: torch.Tensor) -> dict:
    """Per-layer cross-attention K/V, computed once per utterance batch:
    packed (B, Tp, d) buffers, k unscaled (the step's query carries
    d_head**-0.5), time zero-padded to `pad_time` (the step masks the pad
    with pos = T_audio - 1). With `cross_kv_int8` the padded buffers are
    stored int8 (Tp a multiple of TIME_ALIGN_I8, 750 -> 768) beside
    per-layer "k_scale" / "v_scale" (JAX :951-985). With a side network
    also "side_k_packed" / "side_v_packed": each ladder block's cross K/V
    over `downsample_encoder_input(xa)`, in the compute dtype, padded alike
    (JAX :987-1010)."""
    cfg = model.cfg
    xa = audio_feats.to(cfg.compute_dtype)
    t_audio = xa.shape[1]
    int8 = cfg.cross_kv_int8
    pad = pad_time(t_audio, TIME_ALIGN_I8 if int8 else TIME_ALIGN) - t_audio
    ks, vs, k_scales, v_scales = [], [], [], []
    for block in model.decoder.blocks:
        k = F.pad(block.cross_attn.key(xa), (0, 0, 0, pad))
        v = F.pad(block.cross_attn.value(xa), (0, 0, 0, pad))
        if int8:
            (k, s_k), (v, s_v) = quantize_kv(k), quantize_kv(v)
            k_scales.append(s_k)
            v_scales.append(s_v)
        ks.append(k)
        vs.append(v)
    out = {"k_packed": tuple(ks), "v_packed": tuple(vs), "t_audio": t_audio}
    if int8:
        out.update(k_scale=tuple(k_scales), v_scale=tuple(v_scales))
    side = getattr(model, "decoder_side", None)
    if side is not None:
        xa_side = side.downsample_encoder_input(xa)
        out["side_k_packed"] = tuple(F.pad(b.cross_attn.key(xa_side), (0, 0, 0, pad))
                                     for b in side.blocks)
        out["side_v_packed"] = tuple(F.pad(b.cross_attn.value(xa_side), (0, 0, 0, pad))
                                     for b in side.blocks)
    return out


def init_self_kv_cache(cfg: WhisperConfig, batch: int, max_len: int | None = None,
                       device=None, ancestry: bool = False) -> dict:
    """Per-layer (batch, pad_time(max_len), d) self-attention K/V buffers;
    rows past the current position are never read. With `ancestry`, also
    "anc" (1, batch, Tp) int32: anc[0, i, t] is the physical row holding
    position t of row i's hypothesis (JAX :1041-1050), initially i. Beam
    search reorders this map instead of gathering the k/v buffers. A PE
    decoder also gets "k_cs", its second key cache (JAX :1039-1040); a side
    network "side_k" / "side_v", (batch, Tp, n_dim) per ladder block (JAX
    :1051-1062)."""
    max_len = pad_time(max_len or cfg.n_text_ctx)

    def bufs(d=cfg.n_text_state, n=cfg.n_text_layer):
        return tuple(torch.zeros(batch, max_len, d, dtype=cfg.compute_dtype, device=device)
                     for _ in range(n))

    cache = {"k": bufs(), "v": bufs()}
    if cfg.side_network is not None:
        cache["side_k"] = bufs(cfg.side_network.n_dim, len(cfg.side_network.layers))
        cache["side_v"] = bufs(cfg.side_network.n_dim, len(cfg.side_network.layers))
    if cfg.part("decoder").pe_attention:
        cache["k_cs"] = bufs()
    if ancestry:
        cache["anc"] = torch.arange(batch, dtype=torch.int32, device=device)[
            None, :, None].expand(1, batch, max_len).contiguous()
    return cache


def whisper_decode_step(
    model: Whisper,
    tokens: torch.Tensor,
    pos: int,
    self_kv: dict,
    cross_kv: dict,
    beam_groups: int = 1,
) -> tuple[torch.Tensor, dict]:
    """One KV-cached decode step (`whisper_decode_step` :1066).

    tokens (N,) ids at position `pos` (a Python int). Updates `self_kv`
    IN PLACE (row `pos` of every layer's k/v and k_cs, and of "anc" when present)
    and returns it with the (N, n_vocab) float32 logits.

    beam_groups j > 1: the N = B*j rows are B utterances' beams and
    `cross_kv` holds B un-repeated rows (JAX :1146-1176, :1290-1306); the
    self-attention reads through "anc" when the cache has one.

    A side network's ladder (its caches in `self_kv`, its cross K/V in
    `cross_kv`) replaces the trunk's `ln`; a serving-quantised model embeds
    from its int8 table and runs its int8 logits head (K6)."""
    dec = model.decoder
    n = tokens.shape[0]
    h = dec.embed(tokens, pos, int8_head=True)
    anc_local = None
    anc = self_kv.get("anc")
    if anc is not None:
        # this step's rows live at their own physical rows; recorded
        # before the layer loop (in place, where JAX returns an updated
        # copy), so position pos resolves to each row's fresh k/v
        anc[:, :, pos] = torch.arange(n, dtype=anc.dtype, device=anc.device)
        if beam_groups > 1:
            anc_local = anc[0] % beam_groups
    x_embed, trunk_outs = h, []
    for l, block in enumerate(dec.blocks):
        h = block.step(h, pos, l, self_kv, cross_kv, anc_local, beam_groups)
        trunk_outs.append(h)
    side = getattr(model, "decoder_side", None)
    h = dec.ln(h) if side is None else side.step(x_embed, trunk_outs, pos, self_kv, cross_kv)
    return dec.logits(h, int8_head=True), self_kv
