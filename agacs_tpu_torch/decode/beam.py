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
"""

from __future__ import annotations

import torch

from agacs_tpu_torch.decode.composed_beam import composed_beam_decode
from agacs_tpu_torch.decode.greedy import WHISPER_CS_PRIMER
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
    lm_weight: float = 0.0,
    ngram_weight: float = 0.0,
    pre_beam: int = 0,
    use_end_detect: bool = True,
    loop: str = "while",
    ancestry: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam-search a batch of encoded utterances (B, T_enc, d). Returns
    (tokens (B, n_primer+max_steps+1), lengths (B,), scores (B,)) of each
    utterance's best ended hypothesis. CTC, LM and n-gram fusion raise."""
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

    return composed_beam_decode(
        step, self_kv, batch=b, vocab=model.cfg.n_vocab, beam_size=k,
        primer=tuple(primer), max_steps=max_steps, eot=eot, max_pos=max_ctx - 1,
        length_bonus=length_bonus, ctc_weight=ctc_weight, ctc_logp=ctc_logp,
        pre_beam=pre_beam, lm_weight=lm_weight, ngram_weight=ngram_weight,
        use_end_detect=use_end_detect, loop=loop,
        reorder_state_fn=_reorder_ancestry if use_anc else _reorder_caches,
        device=dev,
    )
