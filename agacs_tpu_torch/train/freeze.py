"""Parameter-freezing presets (counterpart of `agacs_tpu/train/freeze.py`,
the reference's `abs_task.py:1163-1222`).

Each preset is the JAX package's predicate over a parameter's '.'-joined
JAX pytree path, for any model family (JAX `freeze.py:42-73`); a port
parameter is judged by the path its name converts to
(`models/checkpoint.jax_paths`: the whisper family's names, the conformer
and transducer families' module layouts), so a preset or a prefix list
selects exactly the leaves JAX selects. The conformer's fused `qkv` holds
JAX's q, k and v: a preset that splits them raises. Frozen parameters get requires_grad=False,
so autograd computes no gradient for them at all. Under `whisper_pe` the
PE gate (path `.../attn/gate`, no "cs") stays frozen, as in the reference
(`abs_task.py:1165-1168`).
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from agacs_tpu_torch.models.checkpoint import jax_paths

PRESETS: dict[str, Callable[[str], bool]] = {
    "none": lambda n: True,
    "whisper_pe": lambda n: "cs" in n,
    "adapter": lambda n: "adapter" in n or "estimated_c" in n,
    "whisper_pe_adapter": lambda n: "adapter" in n or "cs" in n,
    "freeze_decoder_pe": lambda n: not ("decoder" in n and "cs" not in n),
    "freeze_decoder_adapter": lambda n: not ("decoder" in n and "adapter" not in n),
    "all_param": lambda n: False,
    "sidenetwork": lambda n: "side" in n,
    "decoder_sidenetwork": lambda n: "encoder_side" in n,
    "adapter_encoder": lambda n: ("encoder" in n and "adapter" in n),
}


def preset_predicate(preset: str | list[str] | None) -> Callable[[str], bool]:
    """Trainable-iff predicate over a JAX path for a preset name, or for a
    list of path prefixes to freeze. Paths with 'running_' (batch-norm
    buffers) never train."""
    if preset in (None, "", []):
        pred = PRESETS["none"]
    elif isinstance(preset, str):
        if preset not in PRESETS:
            raise KeyError(f"unknown freeze preset {preset!r}; have {sorted(PRESETS)}")
        pred = PRESETS[preset]
    else:
        prefixes = tuple(preset)

        def pred(n):
            return not any(n == p or n.startswith(p + ".") for p in prefixes)
    return lambda n: pred(n) and "running_" not in n


def trainable_names(model: nn.Module, preset: str | list[str] | None) -> list[str]:
    pred = preset_predicate(preset)
    paths = jax_paths(model)
    out = []
    for name, _ in model.named_parameters():
        keep = {pred(key.replace("/", ".")) for key in paths[name]}
        if len(keep) > 1:
            raise ValueError(f"freeze preset {preset!r} splits {name}, which holds "
                             f"{paths[name]}")
        if keep.pop():
            out.append(name)
    return out


def apply_freeze(model: nn.Module, preset: str | list[str] | None) -> list[nn.Parameter]:
    """Set requires_grad by the preset; return the trainable parameters."""
    keep = set(trainable_names(model, preset))
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)
        if name in keep:
            params.append(p)
    return params
