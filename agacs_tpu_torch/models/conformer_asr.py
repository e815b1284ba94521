"""Hybrid CTC/attention conformer ASR model, the SEAME baseline recipe's
(counterpart of `agacs_tpu/models/conformer_asr.py`): DefaultFrontend ->
(global MVN) -> conformer encoder -> {CTC head, transformer decoder}.

Serving only: `encode` is JAX's eval-mode `encode`, and the CTC head's
frame log-probabilities come from `ctc_log_probs`. The training loss
(`forward`: SpecAug, dropout, the CTC and attention losses) is not ported
yet and raises. Token ids are the Whisper ones, sos/eos the Whisper
specials by default, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from agacs_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerEncoder,
    TransformerDecoder,
    TransformerDecoderConfig,
    init_params_,
)
from agacs_tpu_torch.ops.frontend_default import (
    DefaultFrontendConfig,
    default_frontend,
    global_mvn,
)
from agacs_tpu_torch.ops.specaug import SpecAugConfig

IGNORE_ID = -1


@dataclasses.dataclass(frozen=True)
class ConformerASRConfig:
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    frontend: DefaultFrontendConfig = DefaultFrontendConfig()
    # collect_stats' feats_stats.npz for global_mvn; a checkpoint carries
    # the statistics as its `mvn` leaves, which is what the port reads
    mvn_stats_path: str | None = None
    ctc_weight: float = 0.3
    interctc_weight: float = 0.0
    interctc_layers: tuple[int, ...] = ()
    lsm_weight: float = 0.1
    length_normalized_loss: bool = False
    use_specaug: bool = True
    specaug: SpecAugConfig = SpecAugConfig()
    sos: int = 50258
    eos: int = 50257
    ignore_id: int = IGNORE_ID

    def __post_init__(self):
        v = self.decoder.vocab_size
        if not (0 <= self.sos < v and 0 <= self.eos < v):
            raise ValueError(
                f"sos/eos ({self.sos}/{self.eos}) must lie inside the decoder vocab "
                f"(size {v}); set sos=/eos= for non-whisper token lists")


class ConformerASR(nn.Module):
    """`encoder`, `decoder`, the `ctc` linear (d -> V; JAX's (d, V) `ctc/w`
    transposed) and, with global_mvn, the `mvn_mean` / `mvn_std` buffers."""

    def __init__(self, cfg: ConformerASRConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, v = cfg.encoder.output_size, cfg.decoder.vocab_size
        self.encoder = ConformerEncoder(cfg.encoder, device)
        self.decoder = TransformerDecoder(cfg.decoder, device)
        self.ctc = nn.Linear(d, v, dtype=cfg.encoder.compute_dtype, device=device)
        if cfg.frontend.normalize == "global_mvn":
            n = cfg.frontend.n_mels
            self.register_buffer("mvn_mean", torch.zeros(n, device=device))
            self.register_buffer("mvn_std", torch.ones(n, device=device))

    @classmethod
    def from_state_dict(cls, cfg: ConformerASRConfig, state_dict: dict,
                        device=None) -> "ConformerASR":
        """Built on `device` with parameters in their storage dtypes (the
        float32 state dict cast once) and loaded, in eval mode."""
        model = cls(cfg, device="meta").to_empty(device=device or "cpu")
        model.load_state_dict(state_dict)
        return model.eval()


def init_conformer_asr_params(generator: torch.Generator, cfg: ConformerASRConfig) -> dict:
    """Random float32 state dict (CPU) with the JAX init's distributions;
    identity MVN statistics."""
    cfg32 = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, compute_dtype=torch.float32),
        decoder=dataclasses.replace(cfg.decoder, compute_dtype=torch.float32))
    model = ConformerASR(cfg32, device="cpu")
    init_params_(model, generator)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _featurize(model: ConformerASR, speech: torch.Tensor, speech_lengths: torch.Tensor):
    """Frontend, then the corpus MVN from the model's statistics when the
    config asks for global_mvn (the frontend then skips its own)."""
    cfg = model.cfg
    fe_cfg = cfg.frontend
    if fe_cfg.normalize == "global_mvn":
        fe_cfg = dataclasses.replace(fe_cfg, normalize=None)
    feats, flens = default_frontend(speech, speech_lengths, fe_cfg)
    if cfg.frontend.normalize == "global_mvn":
        feats = global_mvn(feats, flens, model.mvn_mean, model.mvn_std)
    return feats, flens


def encode(model: ConformerASR, speech: torch.Tensor, speech_lengths: torch.Tensor):
    """(B, T) waveform -> (encoder output (B, T', d) in the compute dtype,
    olens (B,))."""
    feats, flens = _featurize(model, speech, speech_lengths)
    return model.encoder(feats, flens)


def ctc_log_probs(model: ConformerASR, enc: torch.Tensor) -> torch.Tensor:
    """(B, T', V) float32 CTC frame log-probabilities: the head's product
    in the encoder's dtype, then a float32 log-softmax (JAX
    `bin/decode.py:191-198`)."""
    w = model.ctc.weight.to(enc.dtype)
    logits = (enc @ w.t() + model.ctc.bias.to(enc.dtype)).float()
    return torch.log_softmax(logits, -1)


def forward(model: ConformerASR, cfg: ConformerASRConfig, batch: dict, train: bool = True,
            **kw):
    """The training loss (hybrid CTC/attention) is not ported yet."""
    raise NotImplementedError("conformer training (conformer_asr.forward: the CTC and "
                              "attention losses) is not ported yet")
