"""Weight converter: agacs_tpu (JAX) params -> this package's state dict.

Takes either
  * the JAX param pytree as numpy arrays (`jax.tree.map(np.asarray, params)`),
  * or the flat "/"-joined mapping that `agacs_tpu/train/checkpoint.py`
    `save_pytree` writes to `.params.npz` (`np.load(path)`), with keys like
    `decoder/blocks/attn/query/w` and a leading layer axis L,
and returns float32 CPU tensors under OpenAI's names. Translations: JAX
linear (in, out) -> nn.Linear (out, in); conv (3, in, out) -> nn.Conv1d
(out, in, 3); stacked (L, ...) leaves -> `blocks.{i}.*`. Checkpoints the
port cannot run (int8 trunk `w_q`, serving-quantized `token_emb_q` /
`logits_w_q`, PE attention, side networks) raise.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from agacs_tpu_torch.models.whisper import WhisperConfig, check_supported

_UNSUPPORTED = {
    "w_q": "the int8 frozen trunk",
    "token_emb_q": "serving-quantized token embeddings",
    "logits_w_q": "the int8 logits head",
    "query_cs": "PE attention",
    "encoder_side": "side networks",
    "decoder_side": "side networks",
}


def _nest(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for key in flat:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def _check_keys(tree: Mapping, path: str = "") -> None:
    for key, val in tree.items():
        if key in _UNSUPPORTED:
            raise NotImplementedError(
                f"{path}{key}: {_UNSUPPORTED[key]} is not ported yet")
        if isinstance(val, Mapping):
            _check_keys(val, f"{path}{key}/")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: dict, name: str, p: Mapping, i: int) -> None:
    sd[name + ".weight"] = _t(p["w"][i]).T.contiguous()
    if "b" in p:
        sd[name + ".bias"] = _t(p["b"][i])


def _ln(sd: dict, name: str, p: Mapping, i: int | None = None) -> None:
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    sd[name + ".weight"] = _t(pick(p["w"]))
    sd[name + ".bias"] = _t(pick(p["b"]))


def _blocks(sd: dict, prefix: str, blocks: Mapping, n_layer: int) -> None:
    for i in range(n_layer):
        pre = f"{prefix}.blocks.{i}."
        for attn in ("attn", "cross_attn"):
            if attn not in blocks:
                continue
            for proj in ("query", "key", "value", "out"):
                _linear(sd, pre + f"{attn}.{proj}", blocks[attn][proj], i)
            _ln(sd, pre + f"{attn}_ln", blocks[f"{attn}_ln"], i)
        _linear(sd, pre + "mlp.0", blocks["mlp"]["fc1"], i)
        _linear(sd, pre + "mlp.2", blocks["mlp"]["fc2"], i)
        _ln(sd, pre + "mlp_ln", blocks["mlp_ln"], i)
        for ad in ("adapter_attn", "adapter_mlp"):
            if ad in blocks:
                _linear(sd, pre + f"{ad}.model.0", blocks[ad]["down"], i)
                _linear(sd, pre + f"{ad}.model.2", blocks[ad]["up"], i)
                _ln(sd, pre + f"{ad}_ln", blocks[f"{ad}_ln"], i)


def params_from_numpy(tree: Mapping[str, Any], cfg: WhisperConfig) -> dict:
    """JAX params (nested tree or flat save_pytree mapping) -> state dict."""
    check_supported(cfg)
    if not any(isinstance(v, Mapping) for v in tree.values()):
        tree = _nest({k: tree[k] for k in tree})
    _check_keys(tree)
    enc, dec = tree["encoder"], tree["decoder"]
    sd = {}
    for conv in ("conv1", "conv2"):
        sd[f"encoder.{conv}.weight"] = _t(enc[conv]["w"]).permute(2, 1, 0).contiguous()
        sd[f"encoder.{conv}.bias"] = _t(enc[conv]["b"])
    _blocks(sd, "encoder", enc["blocks"], cfg.n_audio_layer)
    _ln(sd, "encoder.ln_post", enc["ln_post"])
    # token_emb rows may be padded to a tensor-parallel multiple
    sd["decoder.token_embedding.weight"] = _t(dec["token_emb"][: cfg.n_vocab])
    sd["decoder.positional_embedding"] = _t(dec["pos_emb"])
    _blocks(sd, "decoder", dec["blocks"], cfg.n_text_layer)
    _ln(sd, "decoder.ln", dec["ln"])
    return sd
