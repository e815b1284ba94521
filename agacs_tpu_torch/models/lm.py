"""Transformer language model of the conformer recipe's shallow fusion
(counterpart of `agacs_tpu/models/lm.py`, espnet2's transformer_lm).

A causal transformer over token ids: `lm_forward` (teacher-forced logits)
and the cached scorer of beam fusion, `init_lm_kv_cache` +
`lm_score_step_cached` (next-token log-probabilities). The decode CLI
builds it in float32 (`bin/decode.py _load_lm_config`, as JAX's), so its
caches are float32 and the cached step's self-attention is kernel K3-f32
(`ops/decode_attn.py`) on the card. `lm_loss` is the teacher-forced
next-token loss that `bin/lm_train` (the recipe's stage 2) trains with; it
runs no kernel of this package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from agacs_tpu_torch.models.conformer import (
    FFN,
    MHA,
    _mha,
    _pe_rows,
    cached_self_attention,
    embed_tokens,
    init_kv_cache,
    init_params_,
    pe_table,
    sinusoidal_pe,
)
from agacs_tpu_torch.models.whisper import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = 51865
    d_model: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 16
    compute_dtype: torch.dtype = torch.float32
    sos: int = 50258
    eos: int = 50257


class LMBlock(nn.Module):
    def __init__(self, cfg: TransformerLMConfig, device=None, param_dtype=None):
        super().__init__()
        d, dt = cfg.d_model, param_dtype or cfg.compute_dtype
        self.attn = MHA(d, dt, device)
        self.attn_ln = LayerNorm(d, device=device)
        self.ffn = FFN(d, cfg.linear_units, torch.relu, dt, device)
        self.ffn_ln = LayerNorm(d, device=device)


class TransformerLM(nn.Module):
    """`embed` (V, d), the blocks, `after_ln` and the `output` linear;
    parameters stored in `param_dtype` (default: the compute dtype)."""

    def __init__(self, cfg: TransformerLMConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype or cfg.compute_dtype
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model, dtype=dt,
                                              device=device))
        self.blocks = nn.ModuleList(LMBlock(cfg, device, param_dtype)
                                    for _ in range(cfg.num_blocks))
        self.after_ln = LayerNorm(cfg.d_model, device=device)
        self.output = Linear(cfg.d_model, cfg.vocab_size, dtype=dt, device=device)

    @classmethod
    def from_state_dict(cls, cfg: TransformerLMConfig, state_dict: dict,
                        device=None, param_dtype=None) -> "TransformerLM":
        model = cls(cfg, device="meta", param_dtype=param_dtype).to_empty(
            device=device or "cpu")
        model.load_state_dict(state_dict)
        return model.eval()


def init_lm_params(generator: torch.Generator, cfg: TransformerLMConfig) -> dict:
    """Random float32 state dict (CPU) with the JAX init's distributions."""
    model = TransformerLM(dataclasses.replace(cfg, compute_dtype=torch.float32), "cpu")
    init_params_(model, generator)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def lm_forward(lm: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) ids -> (B, T, V) float32 causal logits."""
    cfg = lm.cfg
    t = tokens.shape[1]
    x = embed_tokens(lm.embed, tokens,
                     _pe_rows(sinusoidal_pe(t, cfg.d_model), tokens.device, cfg.compute_dtype),
                     cfg.compute_dtype)
    causal = torch.ones(t, t, dtype=torch.bool, device=tokens.device).tril()[None, None]
    for bp in lm.blocks:
        hn = bp.attn_ln(x)
        x = x + _mha(bp.attn, hn, hn, causal, cfg.attention_heads)
        x = x + bp.ffn(bp.ffn_ln(x))
    return lm.output(lm.after_ln(x)).float()


def lm_loss(lm: TransformerLM, cfg: TransformerLMConfig, batch: dict, train: bool = True,
            generator: torch.Generator | None = None, return_preds: bool = False):
    """Next-token cross entropy over a (B, T) -1-padded text batch, the
    mean over its tokens (JAX `lm_loss`): (loss, {"loss", "ppl"})."""
    text = batch["text"]
    sos = torch.full_like(text[:, :1], cfg.sos)
    ys_in = torch.cat([sos, torch.where(text == -1, cfg.eos, text)], 1)[:, :-1]
    logits = lm_forward(lm, ys_in)
    mask = text != -1
    nll = F.cross_entropy(logits.transpose(1, 2), torch.where(mask, text, 0),
                          reduction="none")
    loss = torch.where(mask, nll, 0.0).sum() / mask.sum().clamp(min=1)
    return loss, {"loss": loss, "ppl": torch.exp(loss)}


def init_lm_kv_cache(cfg: TransformerLMConfig, batch: int, max_len: int,
                     device=None) -> dict:
    return init_kv_cache(cfg.num_blocks, cfg.d_model, cfg.compute_dtype, batch, max_len,
                         device)


def lm_score_step_cached(lm: TransformerLM, tokens: torch.Tensor, pos: int,
                         kv: dict) -> tuple[torch.Tensor, dict]:
    """One cached step: tokens (B,), pos a Python int -> ((B, V) float32
    log-probs, kv), the caches updated in place."""
    cfg = lm.cfg
    tp = kv["k"][0].shape[1]
    x = embed_tokens(lm.embed, tokens, pe_table(tp, cfg.d_model, tokens.device)[pos],
                     cfg.compute_dtype)
    for l, bp in enumerate(lm.blocks):
        x = x + cached_self_attention(bp.attn, bp.attn_ln(x), pos, kv, l, cfg.attention_heads)
        x = x + bp.ffn(bp.ffn_ln(x))
    logits = lm.output(lm.after_ln(x)).float()
    return torch.log_softmax(logits, -1), kv
