"""Recipe YAML -> configs (counterpart of `agacs_tpu/utils/config.py`): the
whisper model config with its training fields (model_conf, specaug_conf,
src_layer, head_mask), the optimizer/scheduler, and the trainer fields.
The same reference-schema YAML resolves to the same values as in the JAX
package. `yaml` is imported only when a file is read or written."""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.whisper import SideNetworkConfig, make_config
from agacs_tpu_torch.ops.specaug import SpecAugConfig
from agacs_tpu_torch.train.optim import OptimConfig


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_epoch: int = 15
    accum_grad: int = 1
    batch_bins: int = 8_000_000
    batch_type: str = "numel"
    keep_nbest_models: int = 3
    best_model_criterion: tuple[str, str, str] = ("valid", "acc", "max")
    seed: int = 2022
    log_interval: int = 100
    patience: int | None = None
    freeze_param: str | list | None = None
    freeze_quant: str | None = None
    optim_state_shard: bool = False
    init_param: str | None = None


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def dump_resolved(path: str, d: dict) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(d, f, allow_unicode=True, sort_keys=False)


def apply_overrides(config: dict, overrides: list[str]) -> dict:
    """'a.b.c=value' dotted overrides, YAML-parsed values."""
    import yaml

    config = copy.deepcopy(config)
    for ov in overrides:
        key, _, val = ov.partition("=")
        node = config
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = yaml.safe_load(val)
    return config


def _side_network_config(conf: dict | None) -> SideNetworkConfig | None:
    if not conf:
        return None
    return SideNetworkConfig(
        n_dim=conf.get("n_dim", 192),
        n_head=conf.get("n_head", 4),
        layers=tuple(conf.get("layers", (0, 2, 4, 6, 8, 10))),
    )


def model_config_from_dict(d: dict, compute_dtype: Any = torch.bfloat16) -> ASRModelConfig:
    """ASRModelConfig from a reference-schema config dict (e.g.
    train_asr_whisper_small_adapter_csloss_2stage.yaml)."""
    enc_conf = d.get("encoder_conf", {}) or {}
    dec_conf = d.get("decoder_conf", {}) or {}
    model_conf = d.get("model_conf", {}) or {}
    if d.get("encoder", "whisper") != "whisper":
        raise NotImplementedError(
            f"encoder family {d.get('encoder')!r}: only whisper is ported yet")
    side = _side_network_config(
        enc_conf.get("side_network_conf") or dec_conf.get("side_network_conf")
        if (enc_conf.get("side_network") or dec_conf.get("side_network"))
        else None
    )
    whisper = make_config(
        enc_conf.get("whisper_model", "small"),
        adapter=bool(enc_conf.get("adapter", False) or dec_conf.get("adapter", False)),
        pe_attention=bool(
            enc_conf.get("pe_whisper", False) or dec_conf.get("pe_whisper", False)
        ),
        adapter_encoder=bool(enc_conf.get("adapter", False)),
        adapter_decoder=bool(dec_conf.get("adapter", False)),
        pe_encoder=bool(enc_conf.get("pe_whisper", False)),
        pe_decoder=bool(dec_conf.get("pe_whisper", False)),
        side_network=side,
        compute_dtype=compute_dtype,
    )
    if float(model_conf.get("interctc_weight", 0.0)) != 0.0:
        raise ValueError("interctc_weight != 0 is not supported on the whisper path")
    head_mask = model_conf.get("head_mask")
    return ASRModelConfig(
        whisper=whisper,
        ctc_weight=float(model_conf.get("ctc_weight", 0.0)),
        cs_weight=float(model_conf.get("cs_weight", 0.0)),
        cs_loss_type=str(model_conf.get("cs_loss_type", "attention")),
        c_val_attention=float(model_conf.get("c_val_attention", 0.6)),
        lsm_weight=float(model_conf.get("lsm_weight", 0.1)),
        length_normalized_loss=bool(model_conf.get("length_normalized_loss", False)),
        src_layer=int(dec_conf.get("src_layer", 1)),
        estimate_c=bool(dec_conf.get("estimate_c", False)),
        use_specaug=bool(enc_conf.get("use_specaug", False)),
        specaug=SpecAugConfig.from_dict(enc_conf.get("specaug_conf")),
        head_mask=tuple(map(tuple, head_mask)) if head_mask else None,
    )


def optim_config_from_dict(d: dict) -> OptimConfig:
    oc = d.get("optim_conf", {}) or {}
    sc = d.get("scheduler_conf", {}) or {}
    return OptimConfig(
        optim=d.get("optim", "adamw"),
        lr=float(oc.get("lr", 1.0e-3)),
        weight_decay=float(oc.get("weight_decay", 0.01)),
        betas=tuple(oc.get("betas", (0.9, 0.99))),
        eps=float(oc.get("eps", 1.0e-6)),
        scheduler=d.get("scheduler", "warmuplr"),
        warmup_steps=int(sc.get("warmup_steps", 25000)),
        grad_clip=float(d.get("grad_clip", 1.0)),
    )


def trainer_config_from_dict(d: dict) -> TrainerConfig:
    crit = d.get("best_model_criterion", [["valid", "acc", "max"]])
    if crit and isinstance(crit[0], list):
        crit = crit[0]
    return TrainerConfig(
        max_epoch=int(d.get("max_epoch", 15)),
        accum_grad=int(d.get("accum_grad", 1)),
        batch_bins=int(d.get("batch_bins", 8_000_000)),
        batch_type=d.get("batch_type", "numel"),
        keep_nbest_models=int(d.get("keep_nbest_models", 3)),
        best_model_criterion=tuple(crit),
        seed=int(d.get("seed", 2022)),
        log_interval=int(d.get("log_interval", 100)),
        patience=d.get("patience") if d.get("patience") not in ("none", None) else None,
        freeze_param=d.get("freeze_param"),
        freeze_quant=d.get("freeze_quant"),
        optim_state_shard=bool(d.get("optim_state_shard", False)),
        init_param=d.get("init_param"),
    )
