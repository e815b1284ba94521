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
`weight_q` / `weight_s` buffers, both ways, in their own dtypes. A CTC
head's `ctc/w` (d, V) and `ctc/b` are the `ctc` linear, both ways, and
`estimated_c_val` (estimate_c) the parameter of that name. PE
attention's `query_cs` / `key_cs` are linears like the others and its
per-head `gate` a plain (n_head,) leaf. A serving-quantised tree (JAX
`int8_serve.quantize_for_serving`: every trunk linear's `w_q`/`w_s` and
the decoder's `token_emb_q`/`_s`, `logits_w_q`/`_s`) maps to the
`Int8Linear`s and the decoder's int8 head buffers, in their own dtypes and
JAX's layouts. Side networks: `encoder_side/...` and `decoder_side/...`
are the `encoder_side` / `decoder_side` modules, their stacked `blocks`
and `downsample_layers` leaves split per ladder block, `gates` and
`gate_output` plain leaves.

`load_torch_whisper` reads an OpenAI `.pt` (`{"dims", "model_state_dict"}`,
or a bare state dict and a config) into a state dict: the port keeps
OpenAI's names, so this is mostly a key check, plus the reference's side
network names (`encoder_sidenetwork.downsample_intermediate_layers.{i}`,
`sigmoid_gate_intermediate_layers.{i}`, `sigmoid_gate_output`) and ESPnet's
wrapper prefixes (`encoder.encoders.`, `decoder.decoders.`).

The conformer ASR model, the transducer ASR model and the transformer LM
have their own pair each (`conformer_params_from_numpy` /
`numpy_from_conformer_params`, `transducer_params_from_numpy` /
`numpy_from_transducer_params`, `lm_params_from_numpy` /
`numpy_from_lm_params`): JAX's stacked `blocks` (and the prediction
network's `layers`) leaves split per layer, linears transposed, the
encoder's q, k, v concatenated into one `qkv` linear, the conv stem HWIO <-> OIHW, the
depthwise kernel (k, 1, d) <-> (d, 1, k), `mvn/mean` <-> `mvn_mean`. The
transducer's tree is `encoder`, `mvn`, `ctc` and `transducer/{embed,
layers/{w_ih, b_ih, w_hh, b_hh}, joint/{lin_enc, lin_dec, lin_out}}`, its
layers' leaves in JAX's layout on both sides. `jax_paths` gives any port
model's parameter names their JAX paths (the freeze presets judge by
them).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from agacs_tpu_torch.models.whisper import (
    INT8_HEAD,
    Whisper,
    WhisperConfig,
    init_whisper_params,
    side_config,
)

_RENAME = {".mlp.0.": ".mlp.fc1.", ".mlp.2.": ".mlp.fc2.",
           ".model.0.": ".down.", ".model.2.": ".up."}
_SPECIAL = {"decoder.token_embedding.weight": "decoder/token_emb",
            "decoder.positional_embedding": "decoder/pos_emb",
            "estimated_c_val": "estimated_c_val",
            **{f"decoder.{n}": f"decoder/{n}" for n in INT8_HEAD}}
_STACKED = ("blocks", "downsample_layers")  # leaves with a leading layer axis in JAX


def jax_leaf(name: str) -> tuple[str, int | None, str]:
    """State-dict name -> (flat JAX key, layer index or None, layout), e.g.
    `encoder.blocks.3.adapter_attn.model.0.weight` ->
    (`encoder/blocks/adapter_attn/down/w`, 3, "linear"). Layouts: "linear"
    (transposed), "conv" ((3, in, out) vs (out, in, 3)), "plain"."""
    if name in _SPECIAL:
        return _SPECIAL[name], None, "plain"
    parts = name.split(".")
    layer = int(parts.pop(2)) if len(parts) > 2 and parts[1] in _STACKED else None
    path = ".".join(parts)
    for a, b in _RENAME.items():
        path = path.replace(a, b)
    *mods, leaf = path.split(".")
    leaf = {"weight": "w", "bias": "b", "weight_q": "w_q", "weight_s": "w_s",
            "gate": "gate", "gates": "gates", "gate_output": "gate_output"}[leaf]
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


def _flat(tree: Mapping[str, Any]) -> dict[str, Any]:
    """A nested tree or a flat save_pytree mapping -> the flat mapping."""
    return _flatten(tree) if any(isinstance(v, Mapping) for v in tree.values()) \
        else {k: tree[k] for k in tree}


def params_from_numpy(tree: Mapping[str, Any], cfg: WhisperConfig,
                      strict: bool = True) -> dict:
    """JAX params (nested tree or flat save_pytree mapping) -> state dict.
    With strict=False, names whose leaf is missing (or whose stacked leaf
    has no such layer) are left out (for init_param's keep-the-init
    semantics)."""
    flat = _flat(tree)
    meta = Whisper(cfg, device="meta", ctc="ctc/w" in flat,
                   estimate_c="estimated_c_val" in flat)
    int8 = {name[: -len(".weight")] for name in meta.state_dict()
            if name.endswith(".weight") and jax_leaf(name)[0][:-1] + "w_q" in flat}
    if int8:
        meta.int8_structure_(int8)
    if "decoder/token_emb_q" in flat:
        meta.decoder.set_int8_head(*(torch.empty(np.shape(flat["decoder/" + n]))
                                     for n in INT8_HEAD))
    sd = {}
    for name in meta.state_dict():
        key, layer, layout = jax_leaf(name)
        if not strict and (key not in flat or layer is not None
                           and layer >= np.shape(flat[key])[0]):
            continue
        a = np.asarray(flat[key] if layer is None else flat[key][layer])
        a = a.astype(np.int8 if key.endswith("_q") else np.float32)
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
    leaves (`w_q`, `token_emb_q`, `logits_w_q`) int8."""
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


_TORCH_PREFIXES = (("encoder.encoders.", "encoder."), ("decoder.decoders.", "decoder."),
                   ("encoder.encoders_sidenetwork.", "encoder_side."),
                   ("decoder.decoders_sidenetwork.", "decoder_side."),
                   ("encoder_sidenetwork.", "encoder_side."),
                   ("decoder_sidenetwork.", "decoder_side."))
_SIDE_GATE = re.compile(r"(encoder|decoder)_side\.sigmoid_gate_intermediate_layers\.(\d+)$")


def state_dict_from_torch(state_dict: Mapping[str, Any], cfg: WhisperConfig) -> dict:
    """The leaves of an OpenAI / reference-layout state dict that `cfg`'s
    model has, as float32 CPU tensors under the port's names (JAX
    `params_from_state_dict` without `_merge_missing`'s template: the
    caller decides what the missing leaves are). Every trunk weight must be
    there (KeyError otherwise); adapters, PE projections and side networks
    are taken when present. A PE stack whose `query_cs` the file lacks gets
    `query_cs` := `query` and `key_cs` := `key` (JAX `init_pe_from_base`,
    reference whisper/__init__.py:238-247); its gates are not set."""
    sd, gates = {}, {}
    for name, val in state_dict.items():
        for old, new in _TORCH_PREFIXES:
            if name.startswith(old):
                name = new + name[len(old):]
                break
        name = name.replace("_side.downsample_intermediate_layers.", "_side.downsample_layers.")
        t = torch.as_tensor(np.asarray(val)) if not torch.is_tensor(val) else val
        t = t.detach().to("cpu", torch.float32)
        if m := _SIDE_GATE.match(name):
            gates.setdefault(m.group(1), {})[int(m.group(2))] = t.reshape(())
        elif name == "encoder_side.sigmoid_gate_output":
            sd["encoder_side.gate_output"] = t.reshape(1)
        else:
            sd[name] = t
    for part, per in gates.items():
        sd[f"{part}_side.gates"] = torch.stack([per[i] for i in range(len(per))])
    meta = Whisper(cfg, device="meta").state_dict()
    trunk = Whisper(dataclasses.replace(side_config(cfg), side_network=None),
                    device="meta").state_dict()
    missing = [n for n in trunk if n not in sd and not n.endswith(".bias")]
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} trunk weights, e.g. {missing[:3]}")
    for part in ("encoder", "decoder"):
        if cfg.part(part).pe_attention and f"{part}.blocks.0.attn.query_cs.weight" not in sd:
            for name in [n for n in meta if n.startswith(f"{part}.blocks.")]:
                base = name.replace(".query_cs.", ".query.").replace(".key_cs.", ".key.")
                if base != name and base in sd:
                    sd[name] = sd[base]
    out = {}
    for name, t in sd.items():
        if name in meta:
            if t.shape != meta[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} in the checkpoint, "
                                 f"{tuple(meta[name].shape)} in the model")
            out[name] = t
    return out


def read_torch_whisper(path: str, cfg: WhisperConfig | None = None
                       ) -> tuple[dict, WhisperConfig]:
    """An OpenAI-format `.pt` file -> (`state_dict_from_torch` of it, the
    config: `cfg`, or else the file's `dims`). Read with weights_only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, Mapping) and "model_state_dict" in ckpt:
        if cfg is None:
            d = ckpt["dims"]
            cfg = WhisperConfig(**{k: d[k] for k in WhisperConfig.__dataclass_fields__
                                   if k in d})
        ckpt = ckpt["model_state_dict"]
    elif cfg is None:
        raise ValueError(f"{path}: a bare state dict needs a config")
    return state_dict_from_torch(ckpt, cfg), cfg


def load_torch_whisper(path: str, cfg: WhisperConfig | None = None
                       ) -> tuple[dict, WhisperConfig]:
    """JAX `load_torch_whisper`: an OpenAI-format `.pt` -> (a whole state
    dict, its config). What the file lacks (adapters, a side network, PE
    gates) keeps the init from torch seed 0, as JAX's `_merge_missing`
    keeps its PRNGKey(0) template's."""
    held, cfg = read_torch_whisper(path, cfg)
    sd = init_whisper_params(torch.Generator().manual_seed(0), cfg)
    sd.update(held)
    return sd, cfg


def load_model(cfg: WhisperConfig, params_path: str | None, device) -> Whisper:
    """A serving model on `device`: weights from a `.params.npz` in the JAX
    layout, or random from torch seed 0 when `params_path` is None."""
    if params_path:
        sd = params_from_numpy(np.load(params_path), cfg)
    else:
        sd = init_whisper_params(torch.Generator().manual_seed(0), cfg)
    return Whisper.from_state_dict(cfg, sd, device=device)


# ---------------------------------------------------------------------------
# the conformer ASR model and the transformer LM
# ---------------------------------------------------------------------------


def _module_leaves(model: nn.Module) -> dict[str, tuple[tuple[str, ...], int | None, str]]:
    """State-dict name -> (JAX flat keys, layer index or None, layout) for
    the conformer family's modules, decided by the owning module's type:
    Linear "linear" (JAX (in, out) transposed; the fused `qkv` is JAX's
    q, k, v concatenated, "qkv"), Conv2d "conv2d" (HWIO vs OIHW), the
    depthwise Conv1d "dwconv" ((k, 1, d) vs (d, 1, k), its bias JAX's
    `dw_b`), everything else "plain" (layer norms, embeddings, position
    biases, batch-norm and MVN statistics)."""
    owners = dict(model.named_modules())
    out = {}
    for name in model.state_dict():
        path, _, leaf = name.rpartition(".")
        mod = owners[path]
        parts = path.split(".") if path else []
        layer = None
        for stacked in ("blocks", "layers"):
            if stacked in parts:
                layer = int(parts.pop(parts.index(stacked) + 1))
        short = {"weight": "w", "bias": "b"}.get(leaf, leaf)
        layout = "plain"
        if isinstance(mod, nn.Linear):
            layout = "linear" if leaf == "weight" else "plain"
            if parts[-1] == "qkv":
                keys = tuple("/".join(parts[:-1] + [p, short]) for p in ("q", "k", "v"))
                out[name] = (keys, layer, "qkv" if leaf == "weight" else "qkv_b")
                continue
        elif isinstance(mod, nn.Conv2d):
            layout = "conv2d" if leaf == "weight" else "plain"
        elif isinstance(mod, nn.Conv1d):
            parts, short = parts[:-1], "dw" if leaf == "weight" else "dw_b"
            layout = "dwconv" if leaf == "weight" else "plain"
        elif leaf.startswith("mvn_"):
            parts, short = ["mvn"], leaf[len("mvn_"):]
        out[name] = (("/".join(parts + [short]),), layer, layout)
    return out


def _from_numpy(tree: Mapping[str, Any], meta: nn.Module, strict: bool = True) -> dict:
    flat = _flat(tree)
    sd = {}
    for name, (keys, layer, layout) in _module_leaves(meta).items():
        if not strict and any(k not in flat for k in keys):
            continue
        arrs = [np.asarray(flat[k] if layer is None else flat[k][layer], np.float32)
                for k in keys]
        a = arrs[0]
        if layout == "linear":
            a = a.T
        elif layout == "qkv":
            a = np.concatenate([x.T for x in arrs], 0)
        elif layout == "qkv_b":
            a = np.concatenate(arrs)
        elif layout == "conv2d":
            a = a.transpose(3, 2, 0, 1)
        elif layout == "dwconv":
            a = a.transpose(2, 1, 0)
        sd[name] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return sd


def _to_numpy(state_dict: Mapping[str, torch.Tensor], meta: nn.Module) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    layers: dict[str, dict[int, np.ndarray]] = {}
    for name, (keys, layer, layout) in _module_leaves(meta).items():
        if name not in state_dict:  # a subset (the optimizer's moments)
            continue
        a = state_dict[name].detach().float().cpu().numpy()
        if layout == "linear":
            arrs = [a.T]
        elif layout == "qkv":
            arrs = [x.T for x in np.split(a, 3, 0)]
        elif layout == "qkv_b":
            arrs = np.split(a, 3)
        elif layout == "conv2d":
            arrs = [a.transpose(2, 3, 1, 0)]
        elif layout == "dwconv":
            arrs = [a.transpose(2, 1, 0)]
        else:
            arrs = [a]
        for key, x in zip(keys, arrs):
            if layer is None:
                out[key] = np.ascontiguousarray(x)
            else:
                layers.setdefault(key, {})[layer] = x
    for key, per in layers.items():
        out[key] = np.stack([per[i] for i in range(len(per))])
    return out


def conformer_params_from_numpy(tree: Mapping[str, Any], cfg, strict: bool = True) -> dict:
    """JAX conformer-ASR params (`init_conformer_asr_params`'s tree as numpy
    arrays, or the flat mapping `save_pytree` writes) -> float32 state dict
    of `models.conformer_asr.ConformerASR` (with `mvn` and the `ctc` head).
    With strict=False, names whose leaves are missing are left out."""
    from agacs_tpu_torch.models.conformer_asr import ConformerASR

    return _from_numpy(tree, ConformerASR(cfg, device="meta"), strict)


def numpy_from_conformer_params(state_dict: Mapping[str, torch.Tensor], cfg) -> dict:
    """The inverse: the flat "/"-joined float32 mapping `save_pytree` writes
    (per-layer leaves stacked), which JAX's `load_pytree_like` reads. Names
    missing from `state_dict` are left out."""
    from agacs_tpu_torch.models.conformer_asr import ConformerASR

    return _to_numpy(state_dict, ConformerASR(cfg, device="meta"))


def transducer_params_from_numpy(tree: Mapping[str, Any], cfg, strict: bool = True) -> dict:
    """JAX transducer-ASR params (`init_transducer_asr_params`'s tree as
    numpy arrays, or the flat mapping `save_pytree` writes) -> float32 state
    dict of `models.transducer_asr.TransducerASR`. With strict=False, names
    whose leaves are missing are left out."""
    from agacs_tpu_torch.models.transducer_asr import TransducerASR

    return _from_numpy(tree, TransducerASR(cfg, device="meta"), strict)


def numpy_from_transducer_params(state_dict: Mapping[str, torch.Tensor], cfg) -> dict:
    """The inverse: the flat "/"-joined float32 mapping JAX's
    `load_pytree_like` reads. Names missing from `state_dict` are left out."""
    from agacs_tpu_torch.models.transducer_asr import TransducerASR

    return _to_numpy(state_dict, TransducerASR(cfg, device="meta"))


def jax_paths(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """Parameter name (and, outside the whisper family, buffer name) -> the
    "/"-joined JAX keys it holds (three for the conformer's fused `qkv`, one
    otherwise), for a `Whisper` or a conformer-family model."""
    if isinstance(model, Whisper):
        return {name: (jax_leaf(name)[0],) for name, _ in model.named_parameters()}
    return {name: keys for name, (keys, _, _) in _module_leaves(model).items()}


def lm_params_from_numpy(tree: Mapping[str, Any], cfg) -> dict:
    """JAX transformer-LM params (tree or flat npz) -> float32 state dict of
    `models.lm.TransformerLM`."""
    from agacs_tpu_torch.models.lm import TransformerLM

    return _from_numpy(tree, TransformerLM(cfg, device="meta"))


def numpy_from_lm_params(state_dict: Mapping[str, torch.Tensor], cfg) -> dict:
    from agacs_tpu_torch.models.lm import TransformerLM

    return _to_numpy(state_dict, TransformerLM(cfg, device="meta"))
