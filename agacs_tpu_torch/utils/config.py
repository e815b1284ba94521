"""Recipe YAML -> configs (counterpart of `agacs_tpu/utils/config.py`): the
whisper model config with its training fields (model_conf, specaug_conf,
src_layer, head_mask), the optimizer/scheduler, the trainer fields, and
`task_from_dict`, the model family the `encoder:` key selects (whisper or
the conformer recipe's hybrid CTC/attention model; the transducer is not
ported yet). The same reference-schema YAML resolves to the same values as
in the JAX package. `yaml` is imported only when a file is read or
written."""

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
    # sorted / unsorted / folded batches hold batch_size utterances, folded
    # shrinks it by the length folds; fixed_shapes' bucket-grid ratio
    batch_size: int = 20
    fold_length: tuple[int, ...] = (80000, 150)
    shape_ratio: float = 1.3
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
        raise ValueError(f"encoder family {d.get('encoder')!r}: model_config_from_dict "
                         "builds the whisper family; use task_from_dict")
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
    head_mask = model_conf.get("head_mask")
    return ASRModelConfig(
        whisper=whisper,
        ctc_weight=float(model_conf.get("ctc_weight", 0.0)),
        interctc_weight=float(model_conf.get("interctc_weight", 0.0)),
        cs_weight=float(model_conf.get("cs_weight", 0.0)),
        cs_loss_type=str(model_conf.get("cs_loss_type", "attention")),
        c_val_attention=float(model_conf.get("c_val_attention", 0.6)),
        head_percentage=float(model_conf.get("head_percentage", 100.0)),
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
        batch_size=int(d.get("batch_size", 20)),
        fold_length=tuple(d.get("fold_length", (80000, 150))),
        shape_ratio=float(d.get("shape_ratio", 1.3)),
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


@dataclasses.dataclass(frozen=True)
class Task:
    """Model family selected by the config's `encoder:` key (JAX `Task`):
    kind "whisper" (cfg an ASRModelConfig) or "conformer" (a
    ConformerASRConfig), with the family's `init_fn(generator, cfg)` (a
    float32 state dict) and `loss_fn(model, cfg, batch, train, generator,
    return_preds)` (the training forward)."""

    kind: str
    cfg: Any
    init_fn: Any
    loss_fn: Any


def conformer_config_from_dict(d: dict, compute_dtype: Any = torch.bfloat16):
    """ConformerASRConfig from a reference-schema dict (the conformer branch
    of JAX `task_from_dict`, :206-297, with its key defaults;
    encoder_conf.unroll_layers is accepted and has no counterpart)."""
    from agacs_tpu_torch.models.conformer import ConformerConfig, TransformerDecoderConfig
    from agacs_tpu_torch.models.conformer_asr import ConformerASRConfig
    from agacs_tpu_torch.ops.frontend_default import DefaultFrontendConfig

    enc_conf = d.get("encoder_conf", {}) or {}
    dec_conf = d.get("decoder_conf", {}) or {}
    model_conf = d.get("model_conf", {}) or {}
    frontend_conf = d.get("frontend_conf", {}) or {}
    enc = ConformerConfig(
        input_size=int(frontend_conf.get("n_mels", 80)),
        output_size=int(enc_conf.get("output_size", 256)),
        attention_heads=int(enc_conf.get("attention_heads", 4)),
        linear_units=int(enc_conf.get("linear_units", 2048)),
        num_blocks=int(enc_conf.get("num_blocks", 12)),
        cnn_module_kernel=int(enc_conf.get("cnn_module_kernel", 15)),
        macaron_style=bool(enc_conf.get("macaron_style", True)),
        use_cnn_module=bool(enc_conf.get("use_cnn_module", True)),
        conv_norm=str(enc_conf.get("conv_norm", "layer")),
        compute_dtype=compute_dtype,
    )
    dec = TransformerDecoderConfig(
        vocab_size=int(d.get("vocab_size", 51865)),
        attention_heads=int(dec_conf.get("attention_heads", 4)),
        linear_units=int(dec_conf.get("linear_units", 2048)),
        num_blocks=int(dec_conf.get("num_blocks", 6)),
        d_model=enc.output_size,
        compute_dtype=compute_dtype,
    )
    normalize = d.get("normalize", "utterance_mvn")
    norm_conf = d.get("normalize_conf", {}) or {}
    frontend = DefaultFrontendConfig(
        n_fft=int(frontend_conf.get("n_fft", 512)),
        hop_length=int(frontend_conf.get("hop_length", 128)),
        n_mels=int(frontend_conf.get("n_mels", 80)),
        normalize=normalize if normalize not in ("none",) else None,
    )
    return ConformerASRConfig(
        encoder=enc,
        decoder=dec,
        frontend=frontend,
        mvn_stats_path=norm_conf.get("stats_file"),
        ctc_weight=float(model_conf.get("ctc_weight", 0.3)),
        interctc_weight=float(model_conf.get("interctc_weight", 0.0)),
        interctc_layers=tuple(enc_conf.get("interctc_layer_idx", ()) or ()),
        lsm_weight=float(model_conf.get("lsm_weight", 0.1)),
        length_normalized_loss=bool(model_conf.get("length_normalized_loss", False)),
        use_specaug=d.get("specaug") == "specaug",
        specaug=SpecAugConfig.from_dict(d.get("specaug_conf")),
    )


def task_from_dict(d: dict, compute_dtype: Any = torch.bfloat16) -> Task:
    encoder = d.get("encoder", "whisper")
    if encoder == "whisper":
        from agacs_tpu_torch.models import asr_model

        return Task("whisper", model_config_from_dict(d, compute_dtype),
                    asr_model.init_asr_params, asr_model.forward)
    if encoder == "conformer":
        if d.get("decoder") == "transducer":
            raise NotImplementedError("the transducer family (decoder: transducer) is not "
                                      "ported yet")
        from agacs_tpu_torch.models import conformer_asr

        return Task("conformer", conformer_config_from_dict(d, compute_dtype),
                    conformer_asr.init_conformer_asr_params, conformer_asr.forward)
    raise ValueError(f"unknown encoder family: {encoder}")
