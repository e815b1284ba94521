"""Conformer encoder and transformer decoder, the SEAME baseline recipe's
model (counterpart of `agacs_tpu/models/conformer.py`), as nn.Modules.

The recipe's shape (`recipes/seame/conf/train_asr_conformer.yaml`): d 256,
4 heads, FFN 2048, 12 blocks, conv kernel 15, rel-pos self-attention,
macaron FFNs, conv2d subsampling (T/4); decoder 6 blocks with sinusoidal
positions.

Counterparts of the JAX functions:

  _conv2d_subsample      -> Conv2dSubsample
  rel_positional_encoding, sinusoidal_pe -> the same (numpy constants)
  _rel_attn              -> RelPositionAttention: q/k/v as ONE product over
                            the concatenated weights (`qkv`, JAX's
                            `fused_linears` layout); inside
                            `relpos_flash.supports` (bf16, 64 <= T <= 640)
                            kernel K5 (`ops/relpos_flash.py`), else JAX's
                            einsum path with its bf16 / float32 rounding.
                            `supports` mirrors JAX's envelope and K5 on
                            the card takes all of it: heads above 128 (d
                            256 / 1 head, d 1024 / 4 heads) run its wide
                            route, padded to a multiple of 128
  _ffn_fwd / _ffn_fwd2   -> FFN (swish for the encoder, relu for the decoder)
  _conv_module           -> ConvModule, conv_norm "layer" (the recipe's) or
                            "batch": biased batch statistics over every
                            (B, T) position, padding included, in training;
                            running_mean/running_var at eval
  dropout                -> dropout (inverted, from a torch.Generator)
  conformer_encode       -> ConformerEncoder.forward: eval, or training with
                            dropout on the four residual branches of each
                            block, interCTC taps and the BN statistics
  collect_bn_batch_stats, apply_bn_stats -> the same
  transformer_decode, init_decoder_kv_cache, precompute_decoder_cross_kv,
  transformer_decode_step -> functions of the same names over a
                            TransformerDecoder; the step's self-attention is
                            kernel K3 (`decode_cache_attention`, K3-f32 on
                            float32 caches), its cross-attention a plain
                            einsum as in JAX

Linear, conv, embedding and position-bias parameters are stored in
`param_dtype`: by default the compute dtype (serving; JAX casts its float32
leaves at use: the same values), float32 masters for training, cast at use;
layer norms and batch-norm statistics in float32. The decoder has no
dropout, as in JAX. `unroll_layers` (scan against unroll) is TPU-only and
has no counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agacs_tpu_torch.models.whisper import LayerNorm, Linear
from agacs_tpu_torch.ops import relpos_flash
from agacs_tpu_torch.ops.decode_attn import decode_cache_attention, pad_time
from agacs_tpu_torch.ops.logmel import full_fp32
from agacs_tpu_torch.parallel.mesh import sum_over

BN_EPS = 1e-5  # torch.nn.BatchNorm1d's default


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 12
    cnn_module_kernel: int = 15
    macaron_style: bool = True
    use_cnn_module: bool = True
    dropout_rate: float = 0.1
    conv_norm: str = "layer"  # or "batch" (espnet's BatchNorm1d, eval mode)
    compute_dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class TransformerDecoderConfig:
    vocab_size: int = 51865
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    d_model: int = 256
    compute_dtype: torch.dtype = torch.float32


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA computes it: float32 as one op; bf16 (and
    other narrow types) as 1 / (1 + exp(-x)) with each op rounded to the
    type (XLA's logistic expansion), not as a float32 sigmoid rounded once:
    the two differ in a third of bf16 values."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(1 + torch.exp(-x))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (JAX `dropout`): each element kept with probability
    1 - rate (uniform draws from `generator`, on x's device) and scaled by
    1 / (1 - rate); identity without a generator or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


@functools.lru_cache(maxsize=None)
def sinusoidal_pe(length: int, d: int) -> np.ndarray:
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((length, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rel_positional_encoding(t: int, d: int) -> np.ndarray:
    """(2T-1, d): positions T-1 .. 0 .. -(T-1) (espnet RelPositionalEncoding)."""
    pos = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe_pos = np.zeros((t, d))
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((t, d))
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0).astype(np.float32)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, h, T, 2T-1) -> (B, h, T, T) Transformer-XL relative shift
    (out[q, j] = x[q, T-1-q+j]), by JAX's pad/reshape/slice."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)
    return x[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]


def _heads(y: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = y.shape
    return y.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge(y: torch.Tensor) -> torch.Tensor:
    b, h, t, dk = y.shape
    return y.transpose(1, 2).reshape(b, t, h * dk)


def _pe_rows(table: np.ndarray, device, dtype) -> torch.Tensor:
    return torch.from_numpy(table).to(device=device, dtype=dtype)


_PE_TABLES: dict = {}


def pe_table(length: int, d: int, device) -> torch.Tensor:
    """sinusoidal_pe(length, d) as a float32 tensor on `device`, kept: a
    decode step indexes its row there instead of copying it from the host
    (a pageable host-to-device copy waits for the stream)."""
    key = (length, d, str(device))
    if key not in _PE_TABLES:
        _PE_TABLES[key] = torch.from_numpy(sinusoidal_pe(length, d)).to(device)
    return _PE_TABLES[key]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


class FFN(nn.Module):
    """fc2(act(fc1(x))): swish in the encoder (`_ffn_fwd`), relu in the
    decoder and the LM (`_ffn_fwd2`)."""

    def __init__(self, d: int, units: int, act, dtype, device=None):
        super().__init__()
        self.fc1 = Linear(d, units, dtype=dtype, device=device)
        self.fc2 = Linear(units, d, dtype=dtype, device=device)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class Conv2dSubsample(nn.Module):
    """(B, T, F) -> (B, T', d), T' = ((T-1)//2 - 1)//2: two 3x3 stride-2
    VALID convs with relu, then a linear over (d, F') (JAX's NHWC layout
    transposed to (d, F') before the flatten, as it does)."""

    def __init__(self, f: int, d: int, dtype, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, d, 3, stride=2, dtype=dtype, device=device)
        self.conv2 = nn.Conv2d(d, d, 3, stride=2, dtype=dtype, device=device)
        self.out = Linear(d * (((f - 1) // 2 - 1) // 2), d, dtype=dtype, device=device)

    @staticmethod
    def _conv(conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(h, conv.weight.to(h.dtype), None, stride=2)
        return torch.relu(y + conv.bias.to(h.dtype)[:, None, None])

    def forward(self, x: torch.Tensor, ilens: torch.Tensor):
        with full_fp32():
            h = self._conv(self.conv2, self._conv(self.conv1, x[:, None]))
        b, d, t2, f2 = h.shape
        h = self.out(h.permute(0, 2, 1, 3).reshape(b, t2, d * f2))
        return h, ((ilens - 1) // 2 - 1) // 2


class RelPositionAttention(nn.Module):
    """`_rel_attn`: rel-pos multi-head self-attention (espnet
    RelPositionMultiHeadedAttention). `qkv` holds JAX's q, k, v linears
    concatenated along the output; `pos` is the bias-free position
    projection; pos_bias_u / pos_bias_v are (h, d_head)."""

    def __init__(self, d: int, n_head: int, dtype, device=None):
        super().__init__()
        self.n_head = n_head
        self.qkv = Linear(d, 3 * d, dtype=dtype, device=device)
        self.out = Linear(d, d, dtype=dtype, device=device)
        self.pos = Linear(d, d, bias=False, dtype=dtype, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, d // n_head, dtype=dtype,
                                                   device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, d // n_head, dtype=dtype,
                                                   device=device))

    def forward(self, x: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_head
        q, k, v = self.qkv(x).split(d, -1)
        pe = self.pos(pos)  # (2T-1, d)
        qu = q + self.pos_bias_u.reshape(d).to(q.dtype)
        qv = q + self.pos_bias_v.reshape(d).to(q.dtype)
        if relpos_flash.supports(t, d, h, q.dtype):
            mask = torch.where(valid, 0.0, relpos_flash.NEG_MASK).float()
            out = relpos_flash.relpos_mha(qu, qv, k.contiguous(), v.contiguous(),
                                          relpos_flash.pad_pe(pe, t), mask, h)
            return self.out(out)
        dk = d // h
        peh = pe.reshape(2 * t - 1, h, dk).transpose(0, 1)  # (h, 2T-1, dk)
        ac = _heads(qu, h) @ _heads(k, h).transpose(-1, -2)
        bd = rel_shift(_heads(qv, h) @ peh.transpose(-1, -2)[None])
        score = (ac + bd).float() / math.sqrt(dk)
        score = score.masked_fill(~valid[:, None, None, :], float("-inf"))
        w = torch.softmax(score, -1).to(v.dtype)
        return self.out(_merge(w @ _heads(v, h)))


class ConvModule(nn.Module):
    """`_conv_module`: pointwise -> GLU -> depthwise(k) -> norm -> swish ->
    pointwise, padded positions zeroed so the depthwise conv cannot read
    across them. `dw` holds JAX's (k, 1, d) `dw` as a grouped Conv1d (d, 1, k)
    and its `dw_b`. conv_norm "batch" normalises with the running
    statistics (eval mode) and `norm` as the affine. `sync` (a
    `parallel/mesh.Parallel`, set by `sync_batch_norm_`): the batch
    statistics are over every data rank's rows, as JAX's global program
    computes them."""

    sync = None

    def __init__(self, d: int, kernel: int, conv_norm: str, dtype, device=None):
        super().__init__()
        if conv_norm not in ("layer", "batch"):
            raise ValueError(f"conv_norm {conv_norm!r}: 'layer' or 'batch'")
        self.kernel, self.conv_norm = kernel, conv_norm
        self.pw1 = Linear(d, 2 * d, dtype=dtype, device=device)
        self.dw = nn.Conv1d(d, d, kernel, groups=d, dtype=dtype, device=device)
        self.norm = LayerNorm(d, device=device)
        self.pw2 = Linear(d, d, dtype=dtype, device=device)
        if conv_norm == "batch":
            self.register_buffer("running_mean", torch.zeros(d, device=device))
            self.register_buffer("running_var", torch.ones(d, device=device))

    def forward(self, x: torch.Tensor, valid: torch.Tensor, train: bool = False):
        """-> (out, (mean, var)): the batch statistics with conv_norm
        "batch" in training, else None."""
        m = valid[..., None].to(x.dtype)
        a, g = self.pw1(x * m).chunk(2, -1)
        h = a * sigmoid(g) * m
        pad = (self.kernel - 1) // 2
        with full_fp32():
            h = F.conv1d(h.transpose(1, 2), self.dw.weight.to(h.dtype), None, padding=pad,
                         groups=h.shape[-1]).transpose(1, 2)
        h = h + self.dw.bias.to(h.dtype)
        stats = None
        if self.conv_norm == "batch":
            hf = h.float()
            if train:
                stats = batch_moments(hf, self.sync)
            mean, var = stats or (self.running_mean, self.running_var)
            hf = (hf - mean) * torch.rsqrt(var + BN_EPS)
            h = (hf * self.norm.weight.float() + self.norm.bias.float()).to(h.dtype)
        else:
            h = self.norm(h)
        return self.pw2(swish(h)), stats


def batch_moments(h: torch.Tensor, par=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (mean, biased variance) over (B, T) of h (B, T, d) float32; on a
    mesh (`par`) over every data rank's rows, in two passes (the global
    mean, then the global mean squared deviation), differentiably."""
    if par is None or par.mesh is None:
        return h.mean((0, 1)), h.var((0, 1), unbiased=False)
    n = sum_over(h.new_tensor([float(h.shape[0] * h.shape[1])]), par)
    mean = sum_over(h.sum((0, 1)), par) / n
    var = sum_over(((h - mean) ** 2).sum((0, 1)), par) / n
    return mean, var


def sync_batch_norm_(model: nn.Module, par) -> nn.Module:
    """Every conv module of `model` takes its batch statistics over the
    mesh's data ranks (`ConvModule.sync`)."""
    for m in model.modules():
        if isinstance(m, ConvModule) and m.conv_norm == "batch":
            m.sync = par
    return model


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, param_dtype=None):
        super().__init__()
        d, dt = cfg.output_size, param_dtype or cfg.compute_dtype
        self.cfg = cfg
        self.ff1 = FFN(d, cfg.linear_units, swish, dt, device)
        self.ff1_ln = LayerNorm(d, device=device)
        self.attn = RelPositionAttention(d, cfg.attention_heads, dt, device)
        self.attn_ln = LayerNorm(d, device=device)
        self.ff2 = FFN(d, cfg.linear_units, swish, dt, device)
        self.ff2_ln = LayerNorm(d, device=device)
        self.final_ln = LayerNorm(d, device=device)
        if cfg.use_cnn_module:
            self.conv = ConvModule(d, cfg.cnn_module_kernel, cfg.conv_norm, dt, device)
            self.conv_ln = LayerNorm(d, device=device)

    def forward(self, h, pos, valid, train: bool = False,
                generator: torch.Generator | None = None):
        """-> (out, BN batch statistics or None); dropout on the four
        residual branches when `generator` is given."""
        rate = self.cfg.dropout_rate
        if self.cfg.macaron_style:
            h = h + 0.5 * dropout(self.ff1(self.ff1_ln(h)), rate, generator)
        h = h + dropout(self.attn(self.attn_ln(h), pos, valid), rate, generator)
        stats = None
        if self.cfg.use_cnn_module:
            conv, stats = self.conv(self.conv_ln(h), valid, train)
            h = h + dropout(conv, rate, generator)
        h = h + 0.5 * dropout(self.ff2(self.ff2_ln(h)), rate, generator)
        return self.final_ln(h), stats


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.subsample = Conv2dSubsample(cfg.input_size, cfg.output_size,
                                         param_dtype or cfg.compute_dtype, device)
        self.blocks = nn.ModuleList(ConformerBlock(cfg, device, param_dtype)
                                    for _ in range(cfg.num_blocks))
        self.after_ln = LayerNorm(cfg.output_size, device=device)

    def forward(self, feats: torch.Tensor, ilens: torch.Tensor,
                generator: torch.Generator | None = None, train: bool = False,
                interctc_layers: tuple[int, ...] = (), collect_bn_stats: bool = False):
        """(B, T, F) features -> ((B, T/4, d), olens) (JAX
        `conformer_encode`). `train` puts conv_norm "batch" on batch
        statistics (JAX: an rng is given); `generator` draws dropout. With
        `interctc_layers` (1-based) the result gains [(idx, that block's
        output), ...]; with `collect_bn_stats` the stacked (L, d) batch
        means and variances."""
        x, olens = self.subsample(feats.to(self.cfg.compute_dtype), ilens)
        t, d = x.shape[1], self.cfg.output_size
        x = x * math.sqrt(d)  # xscale
        pos = _pe_rows(rel_positional_encoding(t, d), x.device, x.dtype)
        valid = torch.arange(t, device=x.device)[None, :] < olens[:, None]
        taps, stats = {}, []
        for i, block in enumerate(self.blocks):
            x, st = block(x, pos, valid, train, generator)
            stats.append(st)
            taps[i + 1] = x
        x = self.after_ln(x)
        if collect_bn_stats:
            return x, olens, (torch.stack([m for m, _ in stats]),
                              torch.stack([v for _, v in stats]))
        if interctc_layers:
            return x, olens, [(li, taps[li]) for li in interctc_layers]
        return x, olens


def collect_bn_batch_stats(encoder: ConformerEncoder, feats: torch.Tensor,
                           ilens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block conv BatchNorm batch statistics ((L, d) mean, (L, d) var)
    of one batch, the recalibration probe: batch statistics, no dropout."""
    _, _, stats = encoder(feats, ilens, train=True, collect_bn_stats=True)
    return stats


def apply_bn_stats(encoder: ConformerEncoder, mean: torch.Tensor, var: torch.Tensor) -> None:
    """Write averaged (L, d) batch statistics into the blocks'
    running_mean / running_var buffers, IN PLACE (JAX returns a new tree):
    the post-epoch recalibration that stands in for torch BatchNorm's
    per-step running average."""
    with torch.no_grad():
        for i, block in enumerate(encoder.blocks):
            block.conv.running_mean.copy_(mean[i])
            block.conv.running_var.copy_(var[i])


# ---------------------------------------------------------------------------
# transformer decoder
# ---------------------------------------------------------------------------


class MHA(nn.Module):
    """The q, k, v and out linears of JAX's `_attn` (no rel-pos leaves)."""

    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        for name in ("q", "k", "v", "out"):
            setattr(self, name, Linear(d, d, dtype=dtype, device=device))


def _mha(m: MHA, xq: torch.Tensor, xkv: torch.Tensor, mask: torch.Tensor,
         n_head: int) -> torch.Tensor:
    """JAX `_mha`: float32 softmax over `mask` (True = attend); a fully
    masked row (a pad query) gets zero weights."""
    dk = xq.shape[-1] // n_head
    q, k, v = _heads(m.q(xq), n_head), _heads(m.k(xkv), n_head), _heads(m.v(xkv), n_head)
    score = (q @ k.transpose(-1, -2)).float() / math.sqrt(dk)
    w = torch.softmax(score.masked_fill(~mask, float("-inf")), -1).to(v.dtype)
    w = torch.where(torch.isnan(w), 0.0, w)
    return m.out(_merge(w @ v))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerDecoderConfig, device=None, param_dtype=None):
        super().__init__()
        d, dt = cfg.d_model, param_dtype or cfg.compute_dtype
        self.self_attn = MHA(d, dt, device)
        self.self_ln = LayerNorm(d, device=device)
        self.src_attn = MHA(d, dt, device)
        self.src_ln = LayerNorm(d, device=device)
        self.ffn = FFN(d, cfg.linear_units, torch.relu, dt, device)
        self.ffn_ln = LayerNorm(d, device=device)


class TransformerDecoder(nn.Module):
    """`embed` (V, d), the blocks, `after_ln` and the `output` linear."""

    def __init__(self, cfg: TransformerDecoderConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype or cfg.compute_dtype
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model, dtype=dt,
                                              device=device))
        self.blocks = nn.ModuleList(DecoderBlock(cfg, device, param_dtype)
                                    for _ in range(cfg.num_blocks))
        self.after_ln = LayerNorm(cfg.d_model, device=device)
        self.output = Linear(cfg.d_model, cfg.vocab_size, dtype=dt, device=device)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, pos_rows: torch.Tensor,
                 dtype) -> torch.Tensor:
    """embed[tokens] in `dtype`, times sqrt(d), plus the sinusoidal rows."""
    return embed[tokens].to(dtype) * math.sqrt(embed.shape[1]) + pos_rows.to(dtype)


def transformer_decode(decoder: TransformerDecoder, tokens: torch.Tensor,
                       memory: torch.Tensor, memory_lens: torch.Tensor,
                       token_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced forward -> (B, T, V) float32 logits."""
    cfg = decoder.cfg
    b, t = tokens.shape
    dev = tokens.device
    x = embed_tokens(decoder.embed, tokens,
                     _pe_rows(sinusoidal_pe(t, cfg.d_model), dev, cfg.compute_dtype),
                     cfg.compute_dtype)
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()[None, None]
    if token_lens is not None:
        causal = causal & (torch.arange(t, device=dev)[None, :]
                           < token_lens[:, None])[:, None, None, :]
    mem_valid = (torch.arange(memory.shape[1], device=dev)[None, :]
                 < memory_lens[:, None])[:, None, None, :]
    mem = memory.to(x.dtype)
    h = cfg.attention_heads
    for bp in decoder.blocks:
        hn = bp.self_ln(x)
        x = x + _mha(bp.self_attn, hn, hn, causal, h)
        x = x + _mha(bp.src_attn, bp.src_ln(x), mem, mem_valid, h)
        x = x + bp.ffn(bp.ffn_ln(x))
    return decoder.output(decoder.after_ln(x)).float()


def init_kv_cache(n_layers: int, d: int, dtype, batch: int, max_len: int,
                  device=None) -> dict:
    """Per-layer lists of (batch, pad_time(max_len), d) zero K and V caches."""
    tp = pad_time(max_len)

    def bufs():
        return [torch.zeros(batch, tp, d, dtype=dtype, device=device)
                for _ in range(n_layers)]

    return {"k": bufs(), "v": bufs()}


def init_decoder_kv_cache(cfg: TransformerDecoderConfig, batch: int, max_len: int,
                          device=None) -> dict:
    return init_kv_cache(cfg.num_blocks, cfg.d_model, cfg.compute_dtype, batch, max_len,
                         device)


def precompute_decoder_cross_kv(decoder: TransformerDecoder, memory: torch.Tensor) -> dict:
    """Per-layer lists of head-split (B, h, T_mem, d_head) cross K and V."""
    mem = memory.to(decoder.cfg.compute_dtype)
    h = decoder.cfg.attention_heads
    return {"k": [_heads(bp.src_attn.k(mem), h) for bp in decoder.blocks],
            "v": [_heads(bp.src_attn.v(mem), h) for bp in decoder.blocks]}


def cached_self_attention(m: MHA, hn: torch.Tensor, pos: int, kv: dict, layer: int,
                          n_head: int) -> torch.Tensor:
    """One cached step of causal self-attention over rows hn (N, d): the
    new key and value written into row `pos` of the layer's caches IN
    PLACE, then K3 (K3-f32 on float32 caches) over keys 0..pos."""
    kv["k"][layer][:, pos] = m.k(hn)
    kv["v"][layer][:, pos] = m.v(hn)
    q = m.q(hn) * (hn.shape[-1] // n_head) ** -0.5
    return m.out(decode_cache_attention(q, kv["k"][layer], kv["v"][layer], pos, n_head))


def transformer_decode_step(decoder: TransformerDecoder, tokens: torch.Tensor, pos: int,
                            self_kv: dict, cross_kv: dict, memory_lens: torch.Tensor):
    """One AR step: tokens (B,), pos a Python int -> (logits (B, V) float32,
    self_kv), the caches updated in place."""
    cfg = decoder.cfg
    h = cfg.attention_heads
    dk = cfg.d_model // h
    b = tokens.shape[0]
    tp = self_kv["k"][0].shape[1]
    x = embed_tokens(decoder.embed, tokens, pe_table(tp, cfg.d_model, tokens.device)[pos],
                     cfg.compute_dtype)
    t_mem = cross_kv["k"][0].shape[2]
    mem_mask = (torch.arange(t_mem, device=tokens.device)[None, :]
                < memory_lens[:, None])[:, None, None, :]
    for l, bp in enumerate(decoder.blocks):
        x = x + cached_self_attention(bp.self_attn, bp.self_ln(x), pos, self_kv, l, h)
        qc = bp.src_attn.q(bp.src_ln(x)).reshape(b, h, 1, dk)
        score = (qc @ cross_kv["k"][l].transpose(-1, -2)).float() / math.sqrt(dk)
        w = torch.softmax(score.masked_fill(~mem_mask, float("-inf")), -1).to(x.dtype)
        x = x + bp.src_attn.out((w @ cross_kv["v"][l]).reshape(b, cfg.d_model))
        x = x + bp.ffn(bp.ffn_ln(x))
    return decoder.output(decoder.after_ln(x)).float(), self_kv


# ---------------------------------------------------------------------------
# random init (JAX's distributions, torch's generator)
# ---------------------------------------------------------------------------


def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a float32 module IN PLACE with the JAX init's distributions:
    linears xavier-uniform with zero biases, layer norms 1/0, the conv stem
    normal * sqrt(2 / fan_in), depthwise kernels, position biases and
    embeddings normal * 0.02, a CTC head normal / sqrt(d); buffers keep
    their zeros / ones. The draws are made on the module's device, from a
    generator of that device (a CPU module takes a CPU generator)."""
    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)

    with torch.no_grad():
        for name, mod in module.named_modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                out_f, in_f = mod.weight.shape
                if name.split(".")[-1] == "ctc":
                    normal(mod.weight, in_f ** -0.5)
                else:
                    bound = math.sqrt(6.0 / (in_f + out_f))
                    mod.weight.copy_((torch.rand(mod.weight.shape, generator=generator,
                                                 device=mod.weight.device)
                                      * 2 - 1) * bound)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                normal(mod.weight, math.sqrt(2.0 / fan_in))
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv1d):
                normal(mod.weight, 0.02)
                mod.bias.zero_()
            elif isinstance(mod, RelPositionAttention):
                normal(mod.pos_bias_u, 0.02)
                normal(mod.pos_bias_v, 0.02)
            elif isinstance(getattr(mod, "embed", None), nn.Parameter):
                normal(mod.embed, 0.02)
    return module
