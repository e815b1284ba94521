"""Transducer ASR model family (counterpart of
`agacs_tpu/models/transducer_asr.py`): DefaultFrontend -> (global MVN) ->
SpecAug -> conformer encoder -> {prediction + joint network} (+ an
auxiliary CTC head), the reference's transducer branch
(`espnet2/asr/espnet_model.py:117-130, 642-668, 980-1027`):

    loss = loss_transducer + ctc_weight * loss_ctc        (:655-657)

with the decoder fed the blank-prefixed labels. The RNN-T loss is
`train/rnnt_loss.py` over the blank and emit log-prob planes, which come
from one of three routes, chosen as JAX's accelerator route chooses them
on every device (JAX gates the first on `vocab_lse.use_streaming()`, true
on its TPU):
  * V >= 1024: `_blank_emit_streaming`, the V reduction through
    `ops/vocab_lse.streaming_lse` (kernel K4 on the card, its plain version
    on the CPU), so the (B, T, U+1, V) logits are never formed;
  * else with `joint_chunk_t`: `_blank_emit_chunked`, the joint per chunk
    of frames under activation checkpointing;
  * else the dense lattice (`joint_lattice` + `rnnt_loss`).
The auxiliary CTC is `train/losses.ctc_loss_streaming` (K4 at the
encoder's width). `eval_step_with_greedy` runs the encoder once for the
losses and the batched greedy search of the CER/WER.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from agacs_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder, init_params_
from agacs_tpu_torch.models.conformer_asr import _featurize, device_generator
from agacs_tpu_torch.models.transducer import (
    Transducer,
    TransducerConfig,
    _act,
    greedy_search_scan,
    init_transducer_params_,
    joint_lattice,
    transducer_decoder,
)
from agacs_tpu_torch.ops.frontend_default import DefaultFrontendConfig
from agacs_tpu_torch.ops.specaug import SpecAugConfig, specaug
from agacs_tpu_torch.train.losses import IGNORE_ID, ctc_loss_streaming
from agacs_tpu_torch.train.rnnt_loss import rnnt_loss, rnnt_loss_from_blank_emit

STREAMING_MIN_VOCAB = 1024  # V from which the joint's lse streams (JAX :158)


@dataclasses.dataclass(frozen=True)
class TransducerASRConfig:
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransducerConfig = TransducerConfig(vocab_size=51865)
    frontend: DefaultFrontendConfig = DefaultFrontendConfig()
    mvn_stats_path: str | None = None
    # loss_transducer + ctc_weight * loss_ctc (not the attention branch's
    # interpolation)
    ctc_weight: float = 0.0
    fastemit_lambda: float = 0.0
    use_specaug: bool = True
    specaug: SpecAugConfig = SpecAugConfig()
    ignore_id: int = IGNORE_ID
    # frames of a joint chunk below STREAMING_MIN_VOCAB; None: one dense
    # joint
    joint_chunk_t: int | None = None


class TransducerASR(nn.Module):
    """`encoder` (in `param_dtype`, default the compute dtype), the `ctc`
    linear (ctc_weight > 0), the `mvn_mean` / `mvn_std` buffers (global_mvn)
    and `transducer`, float32 always."""

    def __init__(self, cfg: TransducerASRConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        d, v = cfg.encoder.output_size, cfg.decoder.vocab_size
        self.encoder = ConformerEncoder(cfg.encoder, device, param_dtype)
        if cfg.ctc_weight > 0.0:
            self.ctc = nn.Linear(d, v, dtype=param_dtype or cfg.encoder.compute_dtype,
                                 device=device)
        if cfg.frontend.normalize == "global_mvn":
            n = cfg.frontend.n_mels
            self.register_buffer("mvn_mean", torch.zeros(n, device=device))
            self.register_buffer("mvn_std", torch.ones(n, device=device))
        self.transducer = Transducer(cfg.decoder, d, device)

    @classmethod
    def from_state_dict(cls, cfg: TransducerASRConfig, state_dict: dict, device=None,
                        param_dtype=None) -> "TransducerASR":
        model = cls(cfg, device="meta", param_dtype=param_dtype).to_empty(
            device=device or "cpu")
        model.load_state_dict(state_dict)
        return model.eval()


def init_transducer_asr_params(generator: torch.Generator, cfg: TransducerASRConfig) -> dict:
    """Random float32 state dict (CPU) with JAX's init distributions, the
    MVN statistics of `cfg.mvn_stats_path` (identity without one)."""
    cfg32 = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, compute_dtype=torch.float32))
    model = TransducerASR(cfg32, device="cpu")
    init_params_(model.encoder, generator)
    if cfg.ctc_weight > 0.0:
        with torch.no_grad():
            model.ctc.weight.copy_(torch.randn(model.ctc.weight.shape, generator=generator)
                                   / cfg.encoder.output_size ** 0.5)
            model.ctc.bias.zero_()
    init_transducer_params_(model.transducer, generator)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if cfg.frontend.normalize == "global_mvn" and cfg.mvn_stats_path:
        with np.load(cfg.mvn_stats_path) as stats:
            sd["mvn_mean"] = torch.from_numpy(np.asarray(stats["mean"], np.float32))
            sd["mvn_std"] = torch.from_numpy(np.asarray(stats["std"], np.float32))
    return sd


def encode(model: TransducerASR, speech: torch.Tensor, speech_lengths: torch.Tensor,
           train: bool = False, generator: torch.Generator | None = None,
           rows: tuple[int, int, int] | None = None):
    """(B, S) waveform -> (encoder output (B, T, d) in the compute dtype,
    olens (B,)). With `train` and a generator: SpecAug drawn from it (at
    the global batch with `rows`), dropout and batch statistics as in
    `conformer_asr.forward`."""
    cfg = model.cfg
    feats, flens = _featurize(model, speech, speech_lengths)
    enc_train = train and generator is not None
    drop_gen = None
    if enc_train:
        if cfg.use_specaug:
            feats = specaug(generator, feats, cfg.specaug, rows)
        drop_gen = device_generator(generator, feats.device)
    return model.encoder(feats, flens, generator=drop_gen, train=enc_train)


def forward(model: TransducerASR, cfg: TransducerASRConfig, batch: dict, train: bool = True,
            generator: torch.Generator | None = None, return_preds: bool = False,
            par=None):
    """The training loss -> (loss, stats): loss_transducer, loss_ctc
    (ctc_weight > 0) and loss, 0-dim tensors; with `return_preds` a third
    item None (a transducer's predictions come from a search). Its losses
    are batch means, so on a mesh (`par`) the trainer's mean over the data
    ranks is the global loss."""
    enc_out, enc_lens = encode(model, batch["speech"], batch["speech_lengths"], train,
                               generator, batch.get("rows"))
    dec_gen = (device_generator(generator, enc_out.device)
               if train and generator is not None else None)
    loss, stats = losses_from_encoder(model, cfg, batch, enc_out, enc_lens, train, dec_gen)
    return (loss, stats, None) if return_preds else (loss, stats)


def losses_from_encoder(model: TransducerASR, cfg: TransducerASRConfig, batch: dict,
                        enc_out: torch.Tensor, enc_lens: torch.Tensor, train: bool = True,
                        generator: torch.Generator | None = None):
    """The RNN-T (+ auxiliary CTC) losses of an encoder output."""
    text = batch["text"]
    blank = cfg.decoder.blank_id
    u_lens = (text != cfg.ignore_id).sum(-1)
    targets = torch.where(text == cfg.ignore_id, blank, text).long()
    decoder_in = torch.cat([torch.full_like(targets[:, :1], blank), targets], 1)
    tmodel = model.transducer
    dec_out = transducer_decoder(tmodel, decoder_in, train, generator)
    if cfg.decoder.vocab_size >= STREAMING_MIN_VOCAB:
        blank_lp, emit = _blank_emit_streaming(tmodel, enc_out, dec_out, targets, blank)
        loss_trans = rnnt_loss_from_blank_emit(blank_lp, emit, enc_lens, u_lens,
                                               cfg.fastemit_lambda)
    elif cfg.joint_chunk_t:
        blank_lp, emit = _blank_emit_chunked(tmodel, enc_out.float(), dec_out.float(),
                                             targets, blank, cfg.joint_chunk_t)
        loss_trans = rnnt_loss_from_blank_emit(blank_lp, emit, enc_lens, u_lens,
                                               cfg.fastemit_lambda)
    else:
        logits = joint_lattice(tmodel, enc_out.float(), dec_out.float())
        loss_trans = rnnt_loss(logits, targets, enc_lens, u_lens, blank, cfg.fastemit_lambda)
    stats = {"loss_transducer": loss_trans}
    loss = loss_trans
    if cfg.ctc_weight > 0.0:
        loss_ctc = ctc_loss_streaming(enc_out, model.ctc.weight.t(), model.ctc.bias, enc_lens,
                                      targets, u_lens)
        stats["loss_ctc"] = loss_ctc
        loss = loss_trans + cfg.ctc_weight * loss_ctc
    stats["loss"] = loss
    return loss, stats


@torch.no_grad()
def eval_step_with_greedy(model: TransducerASR, cfg: TransducerASRConfig, batch: dict,
                          max_symbols: int):
    """One eval pass, the encoder run once for both the losses and the
    batched greedy search of the CER/WER (the ErrorCalculatorTransducer
    role, espnet_model.py:131-147): (stats, (tokens, n_emitted))."""
    enc_out, enc_lens = encode(model, batch["speech"], batch["speech_lengths"])
    _, stats = losses_from_encoder(model, cfg, batch, enc_out, enc_lens, train=False)
    return stats, greedy_search_scan(model.transducer, enc_out, enc_lens,
                                     max_symbols=max_symbols)


def _blank_emit_streaming(tmodel, enc_out, dec_out, targets, blank):
    """blank_lp (B, T, U+1) and emit (B, T, U) log-probs without the
    (B, T, U+1, V) logits: the joint-space activations h = act(lin_enc(enc)
    + lin_dec(dec)) are formed in bf16 ((B, T, U+1, j), 196 MB at 16 x 15 s
    and 40 labels a row, against 63.7 GB for the float32 logits), the V
    reduction is `streaming_lse` over h and lin_out, and the blank and
    target logits are float32 products of h with the gathered columns of
    lin_out; the log-probs are z - lse. bf16 on every device, as JAX's
    accelerator route computes them."""
    from agacs_tpu_torch.ops.vocab_lse import streaming_lse

    jn = tmodel.joint
    b, t, _ = enc_out.shape
    u1, u_max = dec_out.shape[1], targets.shape[1]
    cd = torch.bfloat16
    encp = enc_out.to(cd) @ jn.lin_enc.weight.to(cd).t() + jn.lin_enc.bias.to(cd)
    decp = dec_out.to(cd) @ jn.lin_dec.weight.to(cd).t()
    h = _act(tmodel.cfg.joint_activation)(encp[:, :, None, :] + decp[:, None, :, :])
    w_out = jn.lin_out.weight.to(cd)  # (V, j)
    b_out = jn.lin_out.bias.float()
    lse = streaming_lse(h.reshape(b * t * u1, h.shape[-1]), w_out.t().contiguous(),
                        b_out).reshape(b, t, u1)
    h32 = h.float()
    z_blank = h32 @ w_out[blank].float() + b_out[blank]
    w_tgt = w_out[targets].float()  # (B, U, j)
    z_emit = (h32[:, :, :u_max] * w_tgt[:, None]).sum(-1) + b_out[targets][:, None, :]
    return z_blank - lse, z_emit - lse[:, :, :u_max]


def _blank_emit_chunked(tmodel, enc_out, dec_out, targets, blank, chunk):
    """blank_lp (B, T, U+1) and emit (B, T, U) log-probs, the joint per
    chunk of `chunk` frames under activation checkpointing: peak memory one
    (B, chunk, U+1, V) chunk, whose joint the backward computes again."""
    from torch.utils.checkpoint import checkpoint

    u_max = targets.shape[1]

    def planes(e_chunk):
        lp = torch.log_softmax(joint_lattice(tmodel, e_chunk, dec_out).float(), -1)
        em = lp[:, :, :u_max].gather(3, targets[:, None, :, None].expand(
            -1, e_chunk.shape[1], -1, 1))[..., 0]
        return lp[..., blank], em

    outs = [checkpoint(planes, enc_out[:, i:i + chunk], use_reentrant=False)
            for i in range(0, enc_out.shape[1], chunk)]
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)
