"""Joint CTC/attention beam search with optional transformer-LM shallow
fusion, the conformer recipe's decoding (counterpart of
`agacs_tpu/decode/joint_beam.py`).

  s(g.c) = (1-l)·log p_att(c|g,X) + l·[psi_ctc(g.c) - psi_ctc(g)]
           + m·log p_lm(c|g) + length_bonus

The loop (pre-beam, ended pool, eos at the cap, end detection) is
`decode/composed_beam.py`'s; this binds the transformer decoder's cached
step (`models/conformer.transformer_decode_step`: K3 on its self-attention
caches) and the LM's (`models/lm.lm_score_step_cached`: K3-f32 on the
float32 LM's). Both cache sets are reordered physically after each
selection (rows gathered along the batch axis), as in JAX.
"""

from __future__ import annotations

import torch

from agacs_tpu_torch.decode.composed_beam import _gather_axis0, composed_beam_decode
from agacs_tpu_torch.models.conformer import (
    TransformerDecoder,
    init_decoder_kv_cache,
    precompute_decoder_cross_kv,
    transformer_decode_step,
)
from agacs_tpu_torch.models.lm import TransformerLM, init_lm_kv_cache, lm_score_step_cached


@torch.inference_mode()
def joint_beam_decode(
    decoder: TransformerDecoder,
    memory: torch.Tensor,
    memory_lens: torch.Tensor,
    ctc_logp: torch.Tensor | None = None,
    ctc_frame_lens: torch.Tensor | None = None,
    lm: TransformerLM | None = None,
    beam_size: int = 5,
    pre_beam: int = 8,
    max_steps: int = 64,
    sos: int = 50258,
    eos: int = 50257,
    ctc_weight: float = 0.3,
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
    use_end_detect: bool = True,
    loop: str = "while",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_steps+2), lengths (B,), scores (B,)).

    memory (B, T_enc, d) encoder output; ctc_logp (B, T_enc, V) float32
    CTC frame log-probs (None disables the CTC score); lm with lm_weight > 0
    enables LM fusion."""
    b = memory.shape[0]
    k = beam_size
    total = max_steps + 1  # decoder input positions: sos + max_steps
    dev = memory.device
    mem_r = memory.repeat_interleave(k, 0)
    mlens_r = memory_lens.repeat_interleave(k, 0)
    cross_kv = precompute_decoder_cross_kv(decoder, mem_r)
    self_kv = init_decoder_kv_cache(decoder.cfg, b * k, total, device=dev)

    def step(cur, pos, kv):
        return transformer_decode_step(decoder, cur, pos, kv, cross_kv, mlens_r)

    lm_step = lm_state0 = None
    if lm is not None and lm_weight > 0.0:
        lm_state0 = init_lm_kv_cache(lm.cfg, b * k, total, device=dev)

        def lm_step(cur, pos, kv):
            return lm_score_step_cached(lm, cur, pos, kv)

    return composed_beam_decode(
        step, self_kv, batch=b, vocab=decoder.cfg.vocab_size, beam_size=k, primer=(sos,),
        max_steps=max_steps, eot=eos, max_pos=total - 1, length_bonus=length_bonus,
        ctc_weight=ctc_weight, ctc_logp=ctc_logp, ctc_frame_lens=ctc_frame_lens,
        pre_beam=pre_beam, lm_step_fn=lm_step, lm_state0=lm_state0, lm_weight=lm_weight,
        use_end_detect=use_end_detect, loop=loop, reorder_state_fn=_gather_axis0,
        device=dev)


@torch.inference_mode()
def decode_conformer_batch(model, lm: TransformerLM | None, speech: torch.Tensor,
                           lengths: torch.Tensor, *, beam_size: int = 10,
                           ctc_weight: float = 0.4, lm_weight: float = 0.2,
                           max_steps: int = 200, length_bonus: float = 0.0,
                           loop: str = "scan") -> tuple[list[list[int]], torch.Tensor]:
    """One batch of the conformer recipe's serving (JAX `_decode_conformer`'s
    `decode_chunk`): encode, CTC log-probs when ctc_weight > 0, the joint
    beam with `lm` at lm_weight, pre-beam max(2 * beam, 4); max_steps 0 =
    the encoder's frame count. Returns each utterance's token ids without
    sos / eos, and the (B,) scores."""
    from agacs_tpu_torch.models.conformer_asr import ctc_log_probs, encode

    cfg = model.cfg
    enc, enc_lens = encode(model, speech, lengths)
    ctc_logp = ctc_log_probs(model, enc) if ctc_weight > 0 else None
    tokens, lens, scores = joint_beam_decode(
        model.decoder, enc, enc_lens, ctc_logp=ctc_logp, ctc_frame_lens=enc_lens, lm=lm,
        beam_size=beam_size, pre_beam=max(2 * beam_size, 4),
        max_steps=max_steps if max_steps > 0 else int(enc.shape[1]), sos=cfg.sos,
        eos=cfg.eos, ctc_weight=ctc_weight if ctc_logp is not None else 0.0,
        lm_weight=lm_weight if lm is not None else 0.0, length_bonus=length_bonus,
        loop=loop)
    tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
    rows = [[t for t in row[1:n].tolist() if t not in (cfg.sos, cfg.eos)]
            for row, n in zip(tokens, lens)]
    return rows, scores.cpu()
