"""Scorer-composed beam search over dense (B, beam, L) hypotheses
(counterpart of `agacs_tpu/decode/composed_beam.py`).

Score of extending hypothesis g with token c (espnet's BeamSearch with the
decoder and the LM as full scorers and CTC as a partial one):

  s(g.c) = s(g) + (1-l)·log p_att(c | g, X) + l·[psi_ctc(g.c) - psi_ctc(g)]
           + m·log p_lm(c | g) + n·S_ngram(c | g) + length_bonus
                     (l = ctc_weight, m = lm_weight, n = ngram_weight)

Semantics, as in JAX (:1-41):
  * the primer is forced token by token through the decoder and the LM at
    zero score, outside the search loop (not through the CTC state);
  * with CTC, each row's `pre_beam` best tokens by the full (attention +
    LM) score are the candidates; CTC prefix scoring
    (`decode/ctc_prefix.py`) adds its increment to them, and an eot
    candidate takes the CTC end-of-sentence score;
  * each step takes the global top-k over beam x vocab; a selected eot
    moves its hypothesis into a per-utterance top-k ENDED pool and leaves
    a dead slot (score NEG_INF) among the running beams;
  * end detection (maxlenratio 0): a row stops after M = 3 consecutive
    steps whose endings all fall more than D = -10 below its best ended
    score; a row whose running slots are all dead stops too; a stopped
    row's registers freeze;
  * at the cap, eot is appended to every running hypothesis of a row that
    did not stop and they join the pool at unchanged scores; the best of
    the pool is returned.

The decoder is a `step_fn(cur (N,), pos, state) -> (logits (N, V), state)`
over flat N = B*beam rows, so tests can drive the loop with a synthetic
step; the LM an `lm_step_fn(cur, pos, state) -> (log-probs (N, V),
state)` whose state (per-layer lists of (N, ...) caches) is reordered
along axis 0; the n-gram an `ngram_step_fn(tokens (N, total), pos) ->
(N, V)` scorer over the hypotheses' token buffer, added at `ngram_weight`
to the full score before the pre-beam (JAX :174-178). The CTC frames
(B, T, V) are read per utterance, not repeated per beam row.

Ties: `jax.lax.top_k` ranks equal values by the lower index, and
`torch.topk` promises no order among them. Ties are common here: dead
slots and the initial empty slots all score NEG_INF, and the ended-pool
merge ranks a (B, 2k) pool that is mostly NEG_INF. `top_k` below ranks
like JAX, so the same tokens come out.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30
END_DETECT_M = 3
END_DETECT_D = -10.0


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis of a float32 tensor: the k largest
    values in descending order, equal values by the lower index. Each
    value is mapped to an int64 key that orders like the float and carries
    the index as a tie-break, so one `torch.topk` over distinct keys gives
    JAX's order."""
    bits = x.float().contiguous().view(torch.int32).long()
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # monotone in the float
    n = x.shape[-1]
    key = key * n + (n - 1 - torch.arange(n, device=x.device))
    idx = torch.topk(key, k, dim=-1).indices
    return x.gather(-1, idx), idx


def _gather_axis0(state, idx):
    if isinstance(state, torch.Tensor):
        return state[idx]
    if isinstance(state, dict):
        return {key: _gather_axis0(x, idx) for key, x in state.items()}
    return type(state)(_gather_axis0(x, idx) for x in state)


def _gather_axis1(state, idx):
    if isinstance(state, torch.Tensor):
        return state[:, idx]
    if isinstance(state, dict):
        return {key: _gather_axis1(x, idx) for key, x in state.items()}
    return type(state)(_gather_axis1(x, idx) for x in state)


@torch.inference_mode()
def composed_beam_decode(
    step_fn,
    dec_state0,
    batch: int,
    vocab: int,
    beam_size: int,
    primer: tuple[int, ...],
    max_steps: int,
    eot: int,
    max_pos: int,
    length_bonus: float = 0.0,
    ctc_weight: float = 0.0,
    ctc_logp: torch.Tensor | None = None,
    ctc_frame_lens: torch.Tensor | None = None,
    pre_beam: int = 0,
    lm_step_fn=None,
    lm_state0=None,
    lm_weight: float = 0.0,
    ngram_step_fn=None,
    ngram_weight: float = 0.0,
    use_end_detect: bool = True,
    loop: str = "while",
    reorder_state_fn=None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, n_primer+max_steps+1) int64, lengths (B,),
    scores (B,) float32) of each utterance's best ended hypothesis.

    `max_pos` caps the loop at the decoder context (n_text_ctx - 1
    positions). reorder_state_fn(state, flat_parent) reorders the decoder
    state after each selection (default: axis 1 of every tensor in it, for
    stacked (L, N, ...) states, as in JAX).
    ctc_logp (B, T, V) float32 frame log-probs with ctc_weight > 0 enables
    the CTC scorer (ctc_frame_lens (B,): valid frames, default T); pre_beam
    candidates per row (0: int(1.5 * beam) + 1, espnet's ratio). lm_step_fn
    with lm_weight > 0 enables LM fusion, ngram_step_fn with ngram_weight >
    0 the n-gram (a weight without its scorer raises). loop "scan" runs to the step cap
    with stopped rows frozen; "while" reads `stopped.all()` once per step
    and exits when every row has stopped. Both give identical results."""
    from agacs_tpu_torch.decode.ctc_prefix import (
        CTCPrefixState,
        ctc_eos_score,
        ctc_prefix_init,
        ctc_prefix_score,
    )

    if ngram_weight > 0.0 and ngram_step_fn is None:
        raise ValueError("composed_beam_decode: ngram_weight > 0 without an ngram_step_fn")
    if loop not in ("scan", "while"):
        raise ValueError(f"composed_beam_decode: loop {loop!r}")
    b, k, v = batch, beam_size, vocab
    n_primer = len(primer)
    # layout: primer | max_steps searched tokens | one appended eot slot
    total = n_primer + max_steps + 1
    limit = min(n_primer + max_steps - 1, max_pos)
    rows = torch.arange(b, device=device)[:, None]
    if reorder_state_fn is None:
        reorder_state_fn = _gather_axis1
    use_ctc = ctc_logp is not None and ctc_weight > 0.0
    use_lm = lm_step_fn is not None and lm_weight > 0.0
    use_ngram = ngram_step_fn is not None and ngram_weight > 0.0
    w_att = (1.0 - ctc_weight) if use_ctc else 1.0
    n_pre = pre_beam if pre_beam > 0 else int(1.5 * k) + 1
    ctc = None
    if use_ctc:
        t_ctc = ctc_logp.shape[1]
        lens = (ctc_frame_lens if ctc_frame_lens is not None
                else torch.full((b,), t_ctc, device=ctc_logp.device))
        lens_r = lens.long().repeat_interleave(k)
        ctc_rows = torch.arange(b, device=ctc_logp.device).repeat_interleave(k)
        valid_frames = (int(lens.min()), int(lens.max()))  # one host read per request
        s0 = ctc_prefix_init(ctc_logp)
        ctc = CTCPrefixState(r_nb=s0.r_nb[ctc_rows], r_b=s0.r_b[ctc_rows],
                             last=s0.last[ctc_rows], score=s0.score[ctc_rows])

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    tokens0 = full((b, k, total), eot, torch.long)
    tokens0[:, :, :n_primer] = torch.tensor(primer, dtype=torch.long, device=device)

    # primer prefill: tokens 0..n_primer-2 forced through the decoder; the
    # loop starts at pos = n_primer-1, whose logits pick the first token
    dec, lm = dec_state0, lm_state0
    for p in range(n_primer - 1):
        cur_p = full((b * k,), primer[p], torch.long)
        _, dec = step_fn(cur_p, p, dec)
        if use_lm:
            _, lm = lm_step_fn(cur_p, p, lm)

    scores0 = full((b, k), NEG_INF, torch.float32)
    scores0[:, 0] = 0.0
    carry = {
        "tokens": tokens0,
        "scores": scores0,
        "ended_scores": full((b, k), NEG_INF, torch.float32),
        "ended_tokens": full((b, k, total), eot, torch.long),
        "ended_lens": full((b, k), 0, torch.long),
        "best_ended": full((b,), NEG_INF, torch.float32),
        "dry_count": full((b,), 0, torch.long),
        "stopped": full((b,), False, torch.bool),
    }

    def body(c: dict, pos: int, dec, lm, ctc):
        tokens, scores = c["tokens"], c["scores"]
        cur = tokens.reshape(b * k, total)[:, pos]
        logits, dec_state = step_fn(cur, pos, dec)
        full_sc = w_att * torch.log_softmax(logits.float(), -1)
        lm_state = lm
        if use_lm:
            lm_lp, lm_state = lm_step_fn(cur, pos, lm)
            full_sc = full_sc + lm_weight * lm_lp
        if use_ngram:  # stateless: reads the hypotheses' token buffer
            full_sc = full_sc + ngram_weight * ngram_step_fn(tokens.reshape(b * k, total), pos)
        cands = cand_state = None
        n_cand = v
        if use_ctc:
            pre_scores, cands = top_k(full_sc, n_pre)  # (N, C)
            psi, cand_state = ctc_prefix_score(ctc_logp, ctc, cands, frame_lens=lens_r,
                                               rows=ctc_rows, valid_frames=valid_frames)
            ctc_inc = psi - ctc.score[:, None]
            eos_inc = ctc_eos_score(ctc, lens_r) - ctc.score
            ctc_inc = torch.where(cands == eot, eos_inc[:, None], ctc_inc)
            full_sc = pre_scores + ctc_weight * ctc_inc
            n_cand = n_pre
        totals = scores[:, :, None] + (full_sc + length_bonus).reshape(b, k, n_cand)
        active = ~c["stopped"]

        # the step's global top-k: only selected candidates can end a
        # hypothesis (an eot outside the top-k is pruned, not ended)
        sel_scores, sel_idx = top_k(totals.reshape(b, k * n_cand), k)
        sel_parent, sel_cand = sel_idx // n_cand, sel_idx % n_cand
        sel_tok = sel_cand if cands is None else \
            cands.reshape(b, k, n_cand)[rows, sel_parent, sel_cand]
        ended_cand = torch.where((sel_tok == eot) & active[:, None], sel_scores,
                                 NEG_INF)

        # ended merge: selected eot candidates join the ended pool
        ended_scores, pool_idx = top_k(torch.cat([c["ended_scores"], ended_cand], 1), k)
        from_old = pool_idx < k
        old_idx = pool_idx.clamp(max=k - 1)
        new_parent = sel_parent.gather(1, (pool_idx - k).clamp(0, k - 1))
        newly_tokens = tokens[rows, new_parent]
        newly_tokens[:, :, pos + 1] = eot
        ended_tokens = torch.where(from_old[:, :, None],
                                   c["ended_tokens"][rows, old_idx], newly_tokens)
        ended_lens = torch.where(from_old, c["ended_lens"].gather(1, old_idx), pos + 2)

        # end detection (Eq. 50): M dry steps below best - D
        best_this = ended_cand.amax(1)
        best_ended = torch.maximum(c["best_ended"], best_this)
        dry = (best_ended > NEG_INF / 2) & (best_this - best_ended < END_DETECT_D)
        dry_count = torch.where(dry, c["dry_count"] + 1, 0)
        stopped = c["stopped"]
        if use_end_detect:
            stopped = stopped | (dry_count >= END_DETECT_M)

        # live beams: the selected non-eot candidates; a selected eot leaves
        # a dead slot, so the running set shrinks as the reference's does
        new_scores = torch.where(sel_tok == eot, NEG_INF, sel_scores)
        tokens_new = tokens[rows, sel_parent]
        tokens_new[:, :, pos + 1] = sel_tok
        flat_parent = (rows * k + sel_parent).reshape(-1)
        dec_new = reorder_state_fn(dec_state, flat_parent)
        lm_new = _gather_axis0(lm_state, flat_parent) if use_lm else lm_state
        ctc_new = ctc
        if use_ctc:
            flat_cand = sel_cand.reshape(-1)
            ctc_new = CTCPrefixState(
                r_nb=cand_state.r_nb[flat_parent, :, flat_cand],
                r_b=cand_state.r_b[flat_parent, :, flat_cand],
                last=cand_state.last[flat_parent, flat_cand],
                score=cand_state.score[flat_parent, flat_cand])
        # "no hypothesis. Finish decoding.": all live slots dead
        stopped = stopped | (new_scores.amax(1) <= NEG_INF / 2)

        keep = c["stopped"]  # freeze the registers of rows already stopped

        def sel(new, old):
            return torch.where(keep.reshape((b,) + (1,) * (new.ndim - 1)), old, new)

        return {
            "tokens": sel(tokens_new, tokens),
            "scores": sel(new_scores, scores),
            "ended_scores": sel(ended_scores, c["ended_scores"]),
            "ended_tokens": sel(ended_tokens, c["ended_tokens"]),
            "ended_lens": sel(ended_lens, c["ended_lens"]),
            "best_ended": sel(best_ended, c["best_ended"]),
            "dry_count": sel(dry_count, c["dry_count"]),
            "stopped": stopped,
        }, dec_new, lm_new, ctc_new

    pos = n_primer - 1
    while pos < limit and (loop == "scan" or not bool(carry["stopped"].all())):
        carry, dec, lm, ctc = body(carry, pos, dec, lm, ctc)
        pos += 1

    # "adding <eos> in the last position": live beams (eot appended, score
    # unchanged) join the ended pool; rows stopped by end detection discard
    # their running hypotheses (the reference breaks before the append)
    live_tokens = carry["tokens"].clone()
    live_tokens[:, :, pos + 1] = eot
    live_scores = torch.where(carry["stopped"][:, None], NEG_INF, carry["scores"])
    pool_scores = torch.cat([carry["ended_scores"], live_scores], 1)
    pool_tokens = torch.cat([carry["ended_tokens"], live_tokens], 1)
    pool_lens = torch.cat([carry["ended_lens"], full((b, k), pos + 2, torch.long)], 1)
    best = pool_scores.argmax(1)  # the first maximum, as jnp.argmax
    r = torch.arange(b, device=device)
    return pool_tokens[r, best], pool_lens[r, best], pool_scores[r, best]
