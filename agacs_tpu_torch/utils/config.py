"""Recipe YAML -> model config (counterpart of `agacs_tpu/utils/config.py`
`load_yaml` and the whisper part of `model_config_from_dict`). The same
reference-schema YAML resolves to the same WhisperConfig flags, including
the per-component adapter / PE overrides. `yaml` is imported only when a
file is read."""

from __future__ import annotations

from typing import Any

import torch

from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.whisper import SideNetworkConfig, make_config


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def _side_network_config(conf: dict | None) -> SideNetworkConfig | None:
    if not conf:
        return None
    return SideNetworkConfig(
        n_dim=conf.get("n_dim", 192),
        n_head=conf.get("n_head", 4),
        layers=tuple(conf.get("layers", (0, 2, 4, 6, 8, 10))),
    )


def model_config_from_dict(d: dict, compute_dtype: Any = torch.bfloat16) -> ASRModelConfig:
    """ASRModelConfig (serving fields) from a reference-schema config dict
    (e.g. train_asr_whisper_small_adapter_csloss_2stage.yaml)."""
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
    return ASRModelConfig(
        whisper=whisper, ctc_weight=float(model_conf.get("ctc_weight", 0.0)))
