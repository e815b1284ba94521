"""Hybrid CTC/attention conformer ASR model, the SEAME baseline recipe's
(counterpart of `agacs_tpu/models/conformer_asr.py`): DefaultFrontend ->
(global MVN) -> conformer encoder -> {CTC head, transformer decoder}.

Serving: `encode` is JAX's eval-mode `encode`, and the CTC head's frame
log-probabilities come from `ctc_log_probs`. Training: `forward` is JAX's
hybrid loss, ctc_weight * loss_ctc + (1 - ctc_weight) * loss_att, with
SpecAug, dropout, batch-statistics batch norm, interCTC and the streaming
CTC head (`train/losses.ctc_loss_streaming`, kernel K4 on the card);
`bn_calibration_stats` is the post-epoch BN probe. Token ids are the
Whisper ones, sos/eos the Whisper specials by default, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

import numpy as np

from agacs_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerEncoder,
    TransformerDecoder,
    TransformerDecoderConfig,
    collect_bn_batch_stats,
    init_params_,
    transformer_decode,
)
from agacs_tpu_torch.ops.frontend_default import (
    DefaultFrontendConfig,
    default_frontend,
    global_mvn,
)
from agacs_tpu_torch.ops.specaug import SpecAugConfig, specaug
from agacs_tpu_torch.train.losses import (
    IGNORE_ID,
    add_sos_eos,
    ctc_loss_streaming,
    label_smoothing_loss,
    th_accuracy,
)


@dataclasses.dataclass(frozen=True)
class ConformerASRConfig:
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    frontend: DefaultFrontendConfig = DefaultFrontendConfig()
    # collect_stats' feats_stats.npz for global_mvn, read by
    # `init_conformer_asr_params`; a checkpoint carries them as `mvn` leaves
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
    transposed) and, with global_mvn, the `mvn_mean` / `mvn_std` buffers.
    Linear, conv, embedding and position-bias parameters are stored in
    `param_dtype` (default: the compute dtype)."""

    def __init__(self, cfg: ConformerASRConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        d, v = cfg.encoder.output_size, cfg.decoder.vocab_size
        self.encoder = ConformerEncoder(cfg.encoder, device, param_dtype)
        self.decoder = TransformerDecoder(cfg.decoder, device, param_dtype)
        self.ctc = nn.Linear(d, v, dtype=param_dtype or cfg.encoder.compute_dtype,
                             device=device)
        if cfg.frontend.normalize == "global_mvn":
            n = cfg.frontend.n_mels
            self.register_buffer("mvn_mean", torch.zeros(n, device=device))
            self.register_buffer("mvn_std", torch.ones(n, device=device))

    @classmethod
    def from_state_dict(cls, cfg: ConformerASRConfig, state_dict: dict,
                        device=None, param_dtype=None) -> "ConformerASR":
        """Built on `device` with parameters in `param_dtype` (default: the
        compute dtype; float32 masters to train) and loaded, in eval mode."""
        model = cls(cfg, device="meta", param_dtype=param_dtype).to_empty(
            device=device or "cpu")
        model.load_state_dict(state_dict)
        return model.eval()


def init_conformer_asr_params(generator: torch.Generator, cfg: ConformerASRConfig) -> dict:
    """Random float32 state dict (CPU) with the JAX init's distributions;
    with global_mvn the MVN statistics of `cfg.mvn_stats_path` (identity
    without one), as JAX's init loads them (:85-97)."""
    cfg32 = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, compute_dtype=torch.float32),
        decoder=dataclasses.replace(cfg.decoder, compute_dtype=torch.float32))
    model = ConformerASR(cfg32, device="cpu")
    init_params_(model, generator)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if cfg.frontend.normalize == "global_mvn" and cfg.mvn_stats_path:
        with np.load(cfg.mvn_stats_path) as stats:
            sd["mvn_mean"] = torch.from_numpy(np.asarray(stats["mean"], np.float32))
            sd["mvn_std"] = torch.from_numpy(np.asarray(stats["std"], np.float32))
    return sd


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


def device_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on `device` seeded by one draw of `generator`: the
    encoder's dropout masks are drawn where the activations live."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def bn_calibration_stats(model: ConformerASR, speech: torch.Tensor,
                         speech_lengths: torch.Tensor):
    """Per-block conv BatchNorm batch statistics ((L, d) mean, (L, d) var)
    of one raw-speech batch, no SpecAug, no dropout (JAX
    `bn_calibration_stats`)."""
    feats, flens = _featurize(model, speech, speech_lengths)
    return collect_bn_batch_stats(model.encoder, feats, flens)


def forward(model: ConformerASR, cfg: ConformerASRConfig, batch: dict, train: bool = True,
            generator: torch.Generator | None = None, return_preds: bool = False,
            par=None):
    """The training loss (JAX `forward`, :145-231) -> (loss, stats), stats
    loss_att, acc, loss_ctc (ctc_weight > 0), loss_interctc_layer{i} and
    loss, all 0-dim tensors; with `return_preds` also (argmax ids, ys_out).
    With `train` and a generator (JAX: an rng): SpecAug drawn from it,
    dropout from a device generator it seeds, batch-statistics batch norm.
    On a mesh (`par`, this rank's rows; batch["rows"] as in `asr_model`)
    SpecAug draws at the global batch and the accuracy is global; the
    batch statistics are global when the encoder's conv modules carry the
    mesh (`sync_batch_norm_`); dropout is drawn per rank, as DDP draws it."""
    feats, flens = _featurize(model, batch["speech"], batch["speech_lengths"])
    enc_train = train and generator is not None
    drop_gen = None
    if enc_train:
        if cfg.use_specaug:
            feats = specaug(generator, feats, cfg.specaug, batch.get("rows"))
        drop_gen = device_generator(generator, feats.device)
    taps = tuple(cfg.interctc_layers) if cfg.interctc_weight > 0.0 else ()
    enc_out, enc_lens, *rest = model.encoder(feats, flens, generator=drop_gen,
                                             train=enc_train, interctc_layers=taps)
    inter = rest[0] if taps else []
    text = batch["text"]
    ys_in, ys_out = add_sos_eos(text, cfg.sos, cfg.eos, cfg.ignore_id)
    ys_in_lens = (text != cfg.ignore_id).sum(-1) + 1
    logits = transformer_decode(model.decoder, ys_in, enc_out, enc_lens, ys_in_lens)
    loss_att = label_smoothing_loss(logits, ys_out, cfg.lsm_weight, cfg.ignore_id,
                                    cfg.length_normalized_loss, par)
    stats = {"loss_att": loss_att, "acc": th_accuracy(logits, ys_out, cfg.ignore_id, par)}
    loss = loss_att
    if cfg.ctc_weight > 0.0:
        text_lens = (text != cfg.ignore_id).sum(-1)

        def head_loss(h):
            return ctc_loss_streaming(h, model.ctc.weight.t(), model.ctc.bias, enc_lens, text,
                                      text_lens)

        loss_ctc = head_loss(enc_out)
        stats["loss_ctc"] = loss_ctc
        if inter:
            # the shared CTC head over the taps (espnet_model.py:597-640)
            inter_losses = [head_loss(h) for _, h in inter]
            for (li, _), l_i in zip(inter, inter_losses):
                stats[f"loss_interctc_layer{li}"] = l_i
            loss_ctc = ((1.0 - cfg.interctc_weight) * loss_ctc
                        + cfg.interctc_weight * sum(inter_losses) / len(inter_losses))
        loss = cfg.ctc_weight * loss_ctc + (1.0 - cfg.ctc_weight) * loss_att
    stats["loss"] = loss
    if return_preds:
        return loss, stats, (logits.argmax(-1), ys_out)
    return loss, stats
