"""Whisper beam search over the KV-cached `whisper_decode_step`
(counterpart of `agacs_tpu/decode/beam.py` `beam_decode`), through the
dense loop of `decode/composed_beam.py`.

The cross-attention K/V is computed once per utterance and shared by its
beams (`beam_groups = beam`: kernel K3s on the card). With `ancestry`
(the default) the self-attention caches are never moved: the search
reorders only the (1, B*beam, Tp) ancestry map, which the attention reads
through (K3a). `ancestry=False` gathers the k/v buffers physically after
every selection (a PE decoder's k_cs with them, as JAX's
`decode/beam.py:105-111`), the oracle path (plain-row K3 for the
self-attention).
A side network keeps the physical gather (JAX `decode/beam.py:82-115`): its
ladder caches are keyed per decoding row, so cross-KV is precomputed on
the encoder output repeated per beam, `beam_groups` is 1 (the trunk's
cross-attention runs plain-row K3, not K3s), there is no ancestry map, and
`_reorder_caches` gathers the side caches with the trunk's.
The hypothesis primer is the dual-language prompt
`[50258, 50260, 50259, 50359, 50363]` (asr_inference.py:319-331).
The CTC prefix scorer, the transformer LM and the n-gram fuse through the
same loop (`composed_beam.py`'s score).
"""

from __future__ import annotations

import torch

from agacs_tpu_torch.decode.composed_beam import composed_beam_decode
from agacs_tpu_torch.decode.greedy import WHISPER_CS_PRIMER
from agacs_tpu_torch.models.lm import TransformerLM, init_lm_kv_cache, lm_score_step_cached
from agacs_tpu_torch.models.ngram import NgramLM, ngram_score_step
from agacs_tpu_torch.models.whisper import (
    Whisper,
    init_self_kv_cache,
    precompute_cross_kv,
    whisper_decode_step,
)


def _reorder_ancestry(state: dict, flat_parent: torch.Tensor) -> dict:
    return {**state, "anc": state["anc"][:, flat_parent]}


def _reorder_caches(state: dict, flat_parent: torch.Tensor) -> dict:
    return {key: tuple(x[flat_parent] for x in val) for key, val in state.items()}


@torch.inference_mode()
def beam_decode(
    model: Whisper,
    enc_out: torch.Tensor,
    beam_size: int = 5,
    primer: tuple[int, ...] = WHISPER_CS_PRIMER,
    max_steps: int = 200,
    eot: int = 50257,
    length_bonus: float = 0.0,
    ctc_weight: float = 0.0,
    ctc_logp: torch.Tensor | None = None,
    ctc_frame_lens: torch.Tensor | None = None,
    lm: TransformerLM | None = None,
    lm_weight: float = 0.0,
    ngram_lm: NgramLM | None = None,
    ngram_weight: float = 0.0,
    pre_beam: int = 0,
    use_end_detect: bool = True,
    loop: str = "while",
    ancestry: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam-search a batch of encoded utterances (B, T_enc, d). Returns
    (tokens (B, n_primer+max_steps+1), lengths (B,), scores (B,)) of each
    utterance's best ended hypothesis.

    ctc_logp (B, T_enc, V) float32 CTC frame log-probs with ctc_weight > 0
    add the CTC prefix scorer (`ctc_frame_lens` (B,) valid frames); `lm`
    with lm_weight > 0 the transformer LM's shallow fusion (its float32
    caches for B*beam rows, reordered physically: K3-f32 on the card);
    `ngram_lm` with ngram_weight > 0 the n-gram over the token buffer
    (JAX :120-135). Each scorer sees the primer as context."""
    b, dev = enc_out.shape[0], enc_out.device
    k = beam_size
    max_ctx = min(model.cfg.n_text_ctx, len(primer) + max_steps)
    if model.cfg.side_network is None:
        cross_kv, groups = precompute_cross_kv(model, enc_out), k
    else:
        cross_kv = precompute_cross_kv(model, enc_out.repeat_interleave(k, 0))
        groups = 1
    use_anc = ancestry and groups > 1
    self_kv = init_self_kv_cache(model.cfg, b * k, max_ctx, device=dev, ancestry=use_anc)

    def step(cur, pos, kv):
        return whisper_decode_step(model, cur, pos, kv, cross_kv, beam_groups=groups)

    lm_step = lm_state0 = None
    if lm is not None and lm_weight > 0.0:
        lm_state0 = init_lm_kv_cache(lm.cfg, b * k, max_ctx, device=dev)

        def lm_step(cur, pos, kv):
            return lm_score_step_cached(lm, cur, pos, kv)

    ngram_step = None
    if ngram_lm is not None and ngram_weight > 0.0:
        def ngram_step(tokens, pos):
            return ngram_score_step(ngram_lm, tokens, pos)

    return composed_beam_decode(
        step, self_kv, batch=b, vocab=model.cfg.n_vocab, beam_size=k,
        primer=tuple(primer), max_steps=max_steps, eot=eot, max_pos=max_ctx - 1,
        length_bonus=length_bonus, ctc_weight=ctc_weight, ctc_logp=ctc_logp,
        ctc_frame_lens=ctc_frame_lens, pre_beam=pre_beam, lm_step_fn=lm_step,
        lm_state0=lm_state0, lm_weight=lm_weight, ngram_step_fn=ngram_step,
        ngram_weight=ngram_weight, use_end_detect=use_end_detect, loop=loop,
        reorder_state_fn=_reorder_ancestry if use_anc else _reorder_caches,
        device=dev,
    )
