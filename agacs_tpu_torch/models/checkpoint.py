"""Weight converter between agacs_tpu (JAX) params and this package's state
dict, both ways.

`params_from_numpy` takes either
  * the JAX param pytree as numpy arrays (`jax.tree.map(np.asarray, params)`),
  * or the flat "/"-joined mapping that `agacs_tpu/train/checkpoint.py`
    `save_pytree` writes to `.params.npz` (`np.load(path)`), with keys like
    `decoder/blocks/attn/query/w` and a leading layer axis L,
and returns float32 CPU tensors under OpenAI's names. `numpy_from_params`
is its inverse: a state dict -> that flat mapping, which
`agacs_tpu.train.checkpoint.load_pytree_like` reads.

One name table (`jax_leaf`) serves both directions. Translations: JAX
linear (in, out) <-> nn.Linear (out, in); conv (3, in, out) <-> nn.Conv1d
(out, in, 3); stacked (L, ...) leaves <-> `blocks.{i}.*`. The int8 trunk
(`train/trainer.py quantize_frozen_linears` in JAX) maps `.../w_q` (int8,
JAX's (in, out) layout kept) and `.../w_s` (float32) to an `Int8Linear`'s
`weight_q` / `weight_s` buffers, both ways, in their own dtypes. PE
attention's `query_cs` / `key_cs` are linears like the others and its
per-head `gate` a plain (n_head,) leaf. Checkpoints the port cannot run
(serving-quantized `token_emb_q` / `logits_w_q`, side networks) raise.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from agacs_tpu_torch.models.whisper import (
    Whisper,
    WhisperConfig,
    check_supported,
    init_whisper_params,
)

_UNSUPPORTED = {
    "token_emb_q": "serving-quantized token embeddings",
    "logits_w_q": "the int8 logits head",
    "encoder_side": "side networks",
    "decoder_side": "side networks",
}
_RENAME = {".mlp.0.": ".mlp.fc1.", ".mlp.2.": ".mlp.fc2.",
           ".model.0.": ".down.", ".model.2.": ".up."}
_SPECIAL = {"decoder.token_embedding.weight": "decoder/token_emb",
            "decoder.positional_embedding": "decoder/pos_emb"}


def jax_leaf(name: str) -> tuple[str, int | None, str]:
    """State-dict name -> (flat JAX key, layer index or None, layout), e.g.
    `encoder.blocks.3.adapter_attn.model.0.weight` ->
    (`encoder/blocks/adapter_attn/down/w`, 3, "linear"). Layouts: "linear"
    (transposed), "conv" ((3, in, out) vs (out, in, 3)), "plain"."""
    if name in _SPECIAL:
        return _SPECIAL[name], None, "plain"
    parts = name.split(".")
    layer = int(parts.pop(2)) if len(parts) > 2 and parts[1] == "blocks" else None
    path = ".".join(parts)
    for a, b in _RENAME.items():
        path = path.replace(a, b)
    *mods, leaf = path.split(".")
    leaf = {"weight": "w", "bias": "b", "weight_q": "w_q", "weight_s": "w_s",
            "gate": "gate"}[leaf]
    layout = "plain"
    if leaf == "w" and mods[-1] in ("conv1", "conv2"):
        layout = "conv"
    elif leaf == "w" and not (mods[-1].endswith("ln") or mods[-1] == "ln_post"):
        layout = "linear"
    return "/".join(mods + [leaf]), layer, layout


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


def _check_keys(flat: Mapping[str, Any]) -> None:
    for key in flat:
        for part in key.split("/"):
            if part in _UNSUPPORTED:
                raise NotImplementedError(
                    f"{key}: {_UNSUPPORTED[part]} is not ported yet")


def params_from_numpy(tree: Mapping[str, Any], cfg: WhisperConfig,
                      strict: bool = True) -> dict:
    """JAX params (nested tree or flat save_pytree mapping) -> state dict.
    With strict=False, names whose leaf is missing are left out (for
    init_param's keep-the-init semantics)."""
    check_supported(cfg)
    flat = _flatten(tree) if any(isinstance(v, Mapping) for v in tree.values()) \
        else {k: tree[k] for k in tree}
    _check_keys(flat)
    meta = Whisper(cfg, device="meta")
    int8 = {name[: -len(".weight")] for name in meta.state_dict()
            if name.endswith(".weight") and jax_leaf(name)[0][:-1] + "w_q" in flat}
    if int8:
        meta.int8_structure_(int8)
    sd = {}
    for name in meta.state_dict():
        key, layer, layout = jax_leaf(name)
        if key not in flat and not strict:
            continue
        a = np.asarray(flat[key] if layer is None else flat[key][layer])
        a = a.astype(np.int8 if key.endswith("/w_q") else np.float32)
        if key == "decoder/token_emb":
            a = a[: cfg.n_vocab]  # rows may be padded to a tensor-parallel multiple
        if layout == "linear":
            a = a.T
        elif layout == "conv":
            a = a.transpose(2, 1, 0)
        sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def numpy_from_params(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """State dict -> the flat "/"-joined mapping `save_pytree` writes
    (per-layer tensors stacked on a leading L axis): float32, and the int8
    trunk's `w_q` int8."""
    out: dict[str, np.ndarray] = {}
    layers: dict[str, dict[int, np.ndarray]] = {}
    for name, t in state_dict.items():
        key, layer, layout = jax_leaf(name)
        t = t.detach().cpu()
        a = (t if t.dtype == torch.int8 else t.float()).numpy()
        if layout == "linear":
            a = a.T
        elif layout == "conv":
            a = a.transpose(2, 1, 0)
        if layer is None:
            out[key] = np.ascontiguousarray(a)
        else:
            layers.setdefault(key, {})[layer] = a
    for key, per in layers.items():
        out[key] = np.stack([per[i] for i in range(len(per))])
    return out


def load_model(cfg: WhisperConfig, params_path: str | None, device) -> Whisper:
    """A serving model on `device`: weights from a `.params.npz` in the JAX
    layout, or random from torch seed 0 when `params_path` is None."""
    if params_path:
        sd = params_from_numpy(np.load(params_path), cfg)
    else:
        sd = init_whisper_params(torch.Generator().manual_seed(0), cfg)
    return Whisper.from_state_dict(cfg, sd, device=device)
