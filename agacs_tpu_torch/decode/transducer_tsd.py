"""Batched transducer beam searches, TSD and ALSD (counterpart of
`agacs_tpu/decode/transducer_tsd.py`; the reference's `time_sync_decoding`
and `align_length_sync_decoding`,
`espnet2/asr/transducer/beam_search_transducer.py:356-556`).

TSD: per encoder frame each hypothesis takes up to `max_sym_exp` symbol
expansions; blank extensions collect in a pool where identical label
sequences merge by log-add, and the next frame starts from the pool's top
`beam`. ALSD walks the alignment diagonal i = t + u instead, each
hypothesis reading its own frame t = i - |y|; blank extensions at an
utterance's last frame collect in the final pool.

Both are dense, as in JAX: a hypothesis set is (B, beam, L) blank-padded
token tensors, scores and stacked decoder states, the batch an explicit
tensor dimension (JAX vmaps one utterance's search), and merging is a
pairwise-equality matrix with a masked logsumexp (identical sequences have
identical decoder states, so the first occurrence is kept). The loop over
frames (or diagonal steps) runs on the host and reads nothing back from
the device. Top-k is a stable descending sort, so ties go to the lower
index as in `lax.top_k`. Token rows have one column more than `l_max`,
which takes the writes that JAX drops (a full row's or a dead candidate's
symbol); it is never compared and never returned.
"""

from __future__ import annotations

import torch

from agacs_tpu_torch.models.transducer import (
    Transducer,
    _first_step,
    joint,
    transducer_decoder_step,
)

NEG_INF = -1.0e30


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, A, ...) rows idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _take_state(state: dict, idx: torch.Tensor) -> dict:
    """State leaves (L, B, A, H) rows idx (B, K) -> (L, B, K, H)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: s[:, rows, idx] for k, s in state.items()}


def _write(tokens: torch.Tensor, n: torch.Tensor, sym: torch.Tensor, l_max: int
           ) -> torch.Tensor:
    """tokens (B, A, l_max + 1) with sym written at column n (n = l_max and
    beyond into the spare column)."""
    tokens = tokens.clone()
    b, a = n.shape
    tokens[torch.arange(b, device=n.device)[:, None], torch.arange(a, device=n.device)[None],
           n.clamp(max=l_max)] = sym
    return tokens


def _merge_scores(tokens: torch.Tensor, n_tok: torch.Tensor, scores: torch.Tensor
                  ) -> torch.Tensor:
    """Duplicates merged, per utterance: tokens (B, A, L), n_tok and scores
    (B, A) -> (B, A) scores, each group's first occurrence holding the
    logsumexp of its group and the rest NEG_INF."""
    same = (tokens[:, :, None, :] == tokens[:, None, :, :]).all(-1)
    same &= n_tok[:, :, None] == n_tok[:, None, :]
    alive = scores > NEG_INF / 2
    same &= alive[:, :, None] & alive[:, None, :]
    first = same.to(torch.uint8).argmax(-1)  # the lowest j with same[i, j]
    is_rep = (first == torch.arange(tokens.shape[1], device=tokens.device)) & alive
    merged = torch.logsumexp(torch.where(same, scores[:, None, :], NEG_INF), -1)
    return torch.where(is_rep, merged, NEG_INF)


def _log_probs(model: Transducer, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(joint(model, enc, dec).float(), -1)


def _start(model: Transducer, b: int, beam: int, l_max: int, dev):
    """The initial beam: every row blank, only the first alive."""
    tokens = torch.full((b, beam, l_max + 1), model.cfg.blank_id, dtype=torch.long, device=dev)
    n = torch.zeros(b, beam, dtype=torch.long, device=dev)
    scores = torch.full((b, beam), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    dec, state = _first_step(model, (b, beam), dev)
    return tokens, n, scores, dec, state


def _best_first(tokens, n_tok, scores, l_max):
    order = torch.argsort(-scores, dim=-1, stable=True)
    return _take(tokens, order)[..., :l_max], _take(n_tok, order), _take(scores, order)


@torch.no_grad()
def tsd_beam_search(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                    beam: int = 5, max_sym_exp: int = 3, l_max: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched TSD: enc_out (B, T, D), enc_lens (B,) -> (tokens (B, beam,
    l_max), n (B, beam), scores (B, beam)), best first per utterance; l_max
    defaults to T."""
    blank, v_size = model.cfg.blank_id, model.cfg.vocab_size
    b, t_max, _ = enc_out.shape
    dev = enc_out.device
    l_max = int(l_max or t_max)
    carry = _start(model, b, beam, l_max, dev)
    valid = torch.arange(t_max, device=dev)[:, None] < enc_lens[None, :]
    for t in range(t_max):
        tokens, n_tok, scores, dec, state = carry
        enc_t = enc_out[:, t, None]  # (B, 1, D)
        pool = []  # (tokens, n, scores, dec, state) blank extensions per round
        for v in range(max_sym_exp):
            logp = _log_probs(model, enc_t, dec)  # (B, beam, V)
            pool.append((tokens, n_tok, scores + logp[..., blank], dec, state))
            if v == max_sym_exp - 1:
                break
            nb = logp.clone()
            nb[..., blank] = NEG_INF
            cand = torch.where((n_tok < l_max)[..., None], scores[..., None] + nb, NEG_INF)
            top_v, top_i = _topk(cand.reshape(b, -1), beam)
            parent, sym = top_i // v_size, top_i % v_size
            new_n = _take(n_tok, parent)
            tokens = _write(_take(tokens, parent), new_n, sym, l_max)
            dec, state = transducer_decoder_step(model, sym, _take_state(state, parent))
            n_tok, scores = new_n + 1, top_v
        a_tokens = torch.cat([p[0] for p in pool], 1)
        a_n = torch.cat([p[1] for p in pool], 1)
        a_dec = torch.cat([p[3] for p in pool], 1)
        a_state = {k: torch.cat([p[4][k] for p in pool], 2) for k in state}
        merged = _merge_scores(a_tokens[..., :l_max], a_n,
                               torch.cat([p[2] for p in pool], 1))
        top_v, top_i = _topk(merged, beam)
        new = (_take(a_tokens, top_i), _take(a_n, top_i), top_v, _take(a_dec, top_i),
               _take_state(a_state, top_i))
        ok = valid[t]  # frames past an utterance's end keep its beam
        carry = (torch.where(ok[:, None, None], new[0], carry[0]),
                 torch.where(ok[:, None], new[1], carry[1]),
                 torch.where(ok[:, None], new[2], carry[2]),
                 torch.where(ok[:, None, None], new[3], carry[3]),
                 {k: torch.where(ok[None, :, None, None], new[4][k], carry[4][k])
                  for k in carry[4]})
    return _best_first(carry[0], carry[1], carry[2], l_max)


@torch.no_grad()
def alsd_beam_search(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                     beam: int = 5, u_max: int = 50, l_max: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ALSD: enc_out (B, T, D), enc_lens (B,) -> (tokens (B, beam,
    l_max), n (B, beam), scores (B, beam)) best first from the final pool
    (or from the beam where the pool is empty). u_max caps the label length
    as the reference's u_max = min(u_max, T - 1) does; l_max defaults to
    min(u_max, T). As in JAX, candidates merge before each beam cut, and the
    final pool keeps a running merged top `beam`."""
    blank = model.cfg.blank_id
    b, t_max, _ = enc_out.shape
    dev = enc_out.device
    l_max = int(l_max or min(u_max, t_max))
    tokens, n_tok, scores, dec, state = _start(model, b, beam, l_max, dev)
    fin_tokens, fin_n = tokens, n_tok
    fin_scores = torch.full((b, beam), NEG_INF, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    par = torch.arange(beam, device=dev)
    cand_parent = torch.cat([par, par.repeat_interleave(beam)]).expand(b, -1)
    t_len = enc_lens[:, None]
    for i in range(t_max + min(u_max, l_max)):
        t = i - n_tok  # each hypothesis's frame on the diagonal
        active = (t < t_len) & (scores > NEG_INF / 2)
        logp = _log_probs(model, enc_out[rows, t.clamp(0, t_max - 1)], dec)
        blank_scores = torch.where(active, scores + logp[..., blank], NEG_INF)
        nb = logp.clone()
        nb[..., blank] = NEG_INF
        sym_scores = torch.where((active & (n_tok < l_max))[..., None],
                                 scores[..., None] + nb, NEG_INF)
        top_v, top_sym = _topk(sym_scores, beam)  # (B, beam, beam): each parent's best
        cand_tokens = torch.cat([tokens, _write(
            tokens.repeat_interleave(beam, 1), n_tok.repeat_interleave(beam, 1),
            top_sym.reshape(b, -1), l_max)], 1)
        cand_n = torch.cat([n_tok, n_tok.repeat_interleave(beam, 1) + 1], 1)
        cand_scores = torch.cat([blank_scores, top_v.reshape(b, -1)], 1)
        cand_sym = torch.cat([torch.full_like(n_tok, blank), top_sym.reshape(b, -1)], 1)
        merged = _merge_scores(cand_tokens[..., :l_max], cand_n, cand_scores)
        best_v, best_i = _topk(merged, beam)
        sel_parent, sel_sym = _take(cand_parent, best_i), _take(cand_sym, best_i)
        parent_state = _take_state(state, sel_parent)
        parent_dec = _take(dec, sel_parent)
        new_dec, new_state = transducer_decoder_step(model, sel_sym, parent_state)
        is_sym = sel_sym != blank
        # blank extensions taken at an utterance's last frame enter the final pool
        fin_cand = torch.where(t == t_len - 1, blank_scores, NEG_INF)
        pool_tokens = torch.cat([fin_tokens, tokens], 1)
        pool_n = torch.cat([fin_n, n_tok], 1)
        pool_merged = _merge_scores(pool_tokens[..., :l_max], pool_n,
                                    torch.cat([fin_scores, fin_cand], 1))
        fin_scores, fi = _topk(pool_merged, beam)
        fin_tokens, fin_n = _take(pool_tokens, fi), _take(pool_n, fi)
        tokens, n_tok, scores = _take(cand_tokens, best_i), _take(cand_n, best_i), best_v
        dec = torch.where(is_sym[..., None], new_dec, parent_dec)
        state = {k: torch.where(is_sym[None, ..., None], new_state[k], parent_state[k])
                 for k in state}
    have_final = (fin_scores.max(-1).values > NEG_INF / 2)[:, None]
    return _best_first(torch.where(have_final[..., None], fin_tokens, tokens),
                       torch.where(have_final, fin_n, n_tok),
                       torch.where(have_final, fin_scores, scores), l_max)
