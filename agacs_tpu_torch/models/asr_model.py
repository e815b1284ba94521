"""ASR model config, encoder front half and training forward (counterpart
of `agacs_tpu/models/asr_model.py`): waveform -> log-mel (+SpecAug in
training) -> Whisper encoder -> teacher-forced decoder with the language
columns -> label-smoothed CE + CS loss.

  loss = loss_att;  with ctc_weight: ctc_weight * loss_ctc
  + (1 - ctc_weight) * loss_att, loss_ctc from the CTC head over the
  encoder output (`ctc_loss_streaming`, kernel K4 on the card);
  with cs_weight: loss = cs_weight * loss_cs + loss_att
  (loss_cs over the pre-softmax language columns, or the post-softmax
  mixed ones for a PE decoder; with `cs_loss_type: lid_ce`, the lid-CE
  loss over the full pre-softmax maps, `collect_full_maps`)
  (the reference overwrites the CTC mix here, espnet_model.py:694; the
  JAX package keeps that quirk at asr_model.py:247-248 and so does this
  port).

With `estimate_c` the CS loss's target value is the learnable parameter
`estimated_c_val` (init `[c_val_attention]`, trained by the `adapter`
preset), as in JAX (asr_model.py:227-229).

Batch layout (tensors on the model's device):
  speech (B, S) float32, speech_lengths (B,), text (B, T) ids -1 padded,
  cs_labels (B, T+1) int8 (needed when cs_weight != 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from agacs_tpu_torch.adapt.cs_loss import (
    REFERENCE_50PCT_HEAD_MASK,
    cs_attention_loss,
    cs_lid_ce_loss,
)
from agacs_tpu_torch.models.whisper import (
    Whisper,
    WhisperConfig,
    encoder_olens,
    init_whisper_params,
    whisper_decode,
    whisper_encode,
)
from agacs_tpu_torch.ops.logmel import WhisperAudioConfig, log_mel_spectrogram
from agacs_tpu_torch.ops.specaug import SpecAugConfig, specaug
from agacs_tpu_torch.train.losses import (
    IGNORE_ID,
    add_sos_eos,
    ctc_loss_streaming,
    label_smoothing_loss,
    th_accuracy,
)


@dataclasses.dataclass(frozen=True)
class ASRModelConfig:
    whisper: WhisperConfig
    ctc_weight: float = 0.0
    interctc_weight: float = 0.0  # interCTC taps exist on the conformer only
    cs_weight: float = 0.0
    # "attention" (the shipped column loss) or "lid_ce" (full maps, lid labels)
    cs_loss_type: str = "attention"
    c_val_attention: float = 0.6
    head_percentage: float = 100.0
    lsm_weight: float = 0.1
    length_normalized_loss: bool = False
    src_layer: int = 1  # 1-based, like the YAML configs
    sos: int = 50258
    eos: int = 50257
    ignore_id: int = IGNORE_ID
    use_specaug: bool = True
    estimate_c: bool = False
    specaug: SpecAugConfig = SpecAugConfig()
    audio: WhisperAudioConfig = WhisperAudioConfig()
    # (L, h) 0/1 head mask of the CS loss, tuple of tuples; None = the
    # reference's 50% mask for 12 x 12 decoders, all heads otherwise
    head_mask: tuple | None = None

    def __post_init__(self):
        if (self.cs_weight != 0.0 and self.cs_loss_type == "lid_ce"
                and self.whisper.part("decoder").pe_attention):
            # JAX asr_model.py:88-103: lid_ce reads pre-softmax maps, a PE
            # decoder's are post-softmax
            raise ValueError(
                "cs_loss_type 'lid_ce' is incompatible with a pe_attention "
                "decoder: the PE map collection is post-softmax; use "
                "cs_loss_type 'attention' (p_cols) with PE decoders")
        if self.interctc_weight != 0.0:
            raise ValueError("interctc_weight != 0 is not supported on the whisper path; "
                             "use the conformer model family (ConformerASRConfig)")
        if self.cs_loss_type not in ("attention", "lid_ce"):
            raise ValueError(f"unknown cs_loss_type {self.cs_loss_type!r}")

    def head_mask_array(self) -> np.ndarray:
        if self.head_mask is not None:
            return np.asarray(self.head_mask, np.float32)
        n_l, n_h = self.whisper.n_text_layer, self.whisper.n_text_head
        if (n_l, n_h) == (12, 12):
            return REFERENCE_50PCT_HEAD_MASK
        return np.ones((n_l, n_h), np.float32)


def init_asr_params(generator: torch.Generator, cfg: ASRModelConfig) -> dict:
    """Random float32 state dict (CPU): the whisper parameters, with
    `estimate_c` the learnable `estimated_c_val` [c_val_attention], and,
    with a nonzero ctc_weight, the CTC head (normal / sqrt(d), zero bias;
    JAX `init_asr_params`)."""
    sd = init_whisper_params(generator, cfg.whisper)
    if cfg.estimate_c:
        sd["estimated_c_val"] = torch.tensor([cfg.c_val_attention], dtype=torch.float32)
    if cfg.ctc_weight != 0.0:
        d, v = cfg.whisper.n_audio_state, cfg.whisper.n_vocab
        sd["ctc.weight"] = torch.randn(v, d, generator=generator) / np.sqrt(d)
        sd["ctc.bias"] = torch.zeros(v)
    return sd


def encode(
    model: Whisper,
    cfg: ASRModelConfig,
    speech: torch.Tensor,
    speech_lengths: torch.Tensor,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) waveform -> (encoder_out (B, T_enc, d), encoder_out_lens (B,)).
    SpecAug runs when `train`, `cfg.use_specaug` and a generator is given
    (its draws come from `generator`)."""
    feats, feat_lens = log_mel_spectrogram(speech, speech_lengths, cfg.audio)
    if train and cfg.use_specaug and generator is not None:
        feats = specaug(generator, feats, cfg.specaug)
    return whisper_encode(model, feats), encoder_olens(feat_lens, cfg.whisper)


def forward(
    model: Whisper,
    cfg: ASRModelConfig,
    batch: dict,
    train: bool = True,
    generator: torch.Generator | None = None,
    return_preds: bool = False,
):
    """Training forward: (loss, stats) with stats loss_att, acc, loss_cs
    (when cs_weight != 0) and loss, all 0-dim tensors; with
    `return_preds` also (argmax ids, ys_out) for the eval epoch."""
    text = batch["text"]
    enc_out, enc_lens = encode(model, cfg, batch["speech"], batch["speech_lengths"],
                               train=train, generator=generator)
    ys_in, ys_out = add_sos_eos(text, cfg.sos, cfg.eos, cfg.ignore_id)
    collect = cfg.cs_weight != 0.0
    lid_ce = collect and cfg.cs_loss_type == "lid_ce"
    logits, aux = whisper_decode(model, ys_in, enc_out, src_layer=cfg.src_layer - 1,
                                 collect_lang_cols=collect and not lid_ce,
                                 collect_full_maps=lid_ce)
    loss_att = label_smoothing_loss(logits, ys_out, cfg.lsm_weight, cfg.ignore_id,
                                    cfg.length_normalized_loss)
    stats = {"loss_att": loss_att, "acc": th_accuracy(logits, ys_out, cfg.ignore_id)}
    loss = loss_att
    if cfg.ctc_weight != 0.0:
        loss_ctc = ctc_loss_streaming(enc_out, model.ctc.weight.t(), model.ctc.bias, enc_lens,
                                      text, (text != cfg.ignore_id).sum(-1))
        stats["loss_ctc"] = loss_ctc
        loss = cfg.ctc_weight * loss_ctc + (1.0 - cfg.ctc_weight) * loss_att
    if collect:
        head_mask = torch.from_numpy(cfg.head_mask_array()[cfg.src_layer - 1:]).to(
            logits.device)
        if lid_ce:
            loss_cs = cs_lid_ce_loss(aux["maps"], batch["cs_labels"],
                                     (text != cfg.ignore_id).sum(-1) + 1, head_mask,
                                     lsm_weight=cfg.lsm_weight)
        else:
            # a PE decoder's CS loss reads the post-softmax mixed columns
            # (JAX asr_model.py:238-242)
            cols = aux["p_cols" if cfg.whisper.part("decoder").pe_attention else "qk_cols"]
            c_val = model.estimated_c_val[0] if cfg.estimate_c else cfg.c_val_attention
            loss_cs = cs_attention_loss(cols, batch["cs_labels"], head_mask, c_val,
                                        layer_offset=cfg.src_layer - 1)
        loss = cfg.cs_weight * loss_cs + loss_att
        stats["loss_cs"] = loss_cs
    stats["loss"] = loss
    if return_preds:
        return loss, stats, (logits.argmax(-1), ys_out)
    return loss, stats


def nll(model: Whisper, cfg: ASRModelConfig, encoder_out: torch.Tensor,
        ys_pad: torch.Tensor) -> torch.Tensor:
    """Per-utterance negative log-likelihood of the attention decoder (B,):
    teacher-forced logits, unsmoothed CE per token, ignore positions 0."""
    ys_in, ys_out = add_sos_eos(ys_pad, cfg.sos, cfg.eos, cfg.ignore_id)
    logits, _ = whisper_decode(model, ys_in, encoder_out)
    ignore = ys_out == cfg.ignore_id
    tok = F.cross_entropy(logits.float().transpose(1, 2),
                          torch.where(ignore, 0, ys_out), reduction="none")
    return torch.where(ignore, 0.0, tok).sum(-1)
