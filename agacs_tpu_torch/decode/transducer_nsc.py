"""N-step constrained (NSC) and modified adaptive expansion (mAES)
transducer beam searches (counterpart of
`agacs_tpu/decode/transducer_nsc.py`; the reference's `nsc_beam_search`
and `modified_adaptive_expansion_search`,
`espnet2/asr/transducer/beam_search_transducer.py:557-885`, with the
helpers of `espnet/nets/pytorch_backend/transducer/utils.py:93-220`).

As `models.transducer.default_beam_search`, they keep the reference's
ragged hypotheses on the host and run each joint and decoder step for the
whole hypothesis set at once on the device. A hypothesis carries its
decoder output after every prefix (`dec_outs[m]`, after m tokens), so the
prefix search can re-score prefix extensions as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from agacs_tpu_torch.models.transducer import (
    Transducer,
    _first_step,
    joint_logp,
    transducer_decoder_step,
)


@dataclasses.dataclass
class _Hyp:
    score: float
    toks: tuple
    dec_outs: list  # [m]: the (1, H) decoder output after m tokens
    state: Any      # decoder state, leaves (L, 1, H)


def _is_prefix(x: tuple, pref: tuple) -> bool:
    return len(pref) < len(x) and x[:len(pref)] == pref


def _batch_logp(model, enc_t, hyps) -> np.ndarray:
    return joint_logp(model, enc_t, torch.cat([h.dec_outs[-1] for h in hyps]))


def _batch_step(model, hyps) -> list[tuple[torch.Tensor, dict]]:
    """One decoder step for every hypothesis on its last token: per
    hypothesis ((1, H) output, state)."""
    dev = hyps[0].dec_outs[-1].device
    toks = torch.tensor([h.toks[-1] for h in hyps], dtype=torch.long, device=dev)
    state = {k: torch.cat([h.state[k] for h in hyps], 1) for k in hyps[0].state}
    dec, new_state = transducer_decoder_step(model, toks, state)
    return [(dec[i:i + 1], {k: s[:, i:i + 1] for k, s in new_state.items()})
            for i in range(len(hyps))]


def _prefix_search(model, hyps, enc_t, prefix_alpha):
    """Prefix re-scoring (beam_search_transducer.py:185-220): where hyp_i's
    sequence is a short prefix of hyp_j's, the probability of reaching
    hyp_j through hyp_i is added (log-add) to hyp_j's score, in place."""
    hyps = sorted(hyps, key=lambda h: len(h.toks), reverse=True)
    for j, hyp_j in enumerate(hyps[:-1]):
        for hyp_i in hyps[j + 1:]:
            li, lj = len(hyp_i.toks), len(hyp_j.toks)
            if not (_is_prefix(hyp_j.toks, hyp_i.toks) and lj - li <= prefix_alpha):
                continue
            logp = joint_logp(model, enc_t, hyp_i.dec_outs[-1])[0]
            curr = hyp_i.score + float(logp[hyp_j.toks[li]])
            for k in range(li + 1, lj):
                logp_k = joint_logp(model, enc_t, hyp_j.dec_outs[k])[0]
                curr += float(logp_k[hyp_j.toks[k]])
            hyp_j.score = float(np.logaddexp(hyp_j.score, curr))
    return hyps


def _init_hyp(model, dev) -> _Hyp:
    dec0, state0 = _first_step(model, (1,), dev)
    return _Hyp(score=0.0, toks=(), dec_outs=[dec0], state=state0)


@torch.no_grad()
def nsc_beam_search(model: Transducer, enc_out: torch.Tensor, beam_size: int = 5,
                    nstep: int = 1, prefix_alpha: int = 1) -> list[tuple[float, list[int]]]:
    """N-step constrained beam search for one utterance, enc_out (T, D).
    Returns [(score, tokens)] best first (sort_nbest, score_norm=False)."""
    cfg = model.cfg
    blank = cfg.blank_id
    beam_k = min(beam_size, cfg.vocab_size - 1)
    nb = np.delete(np.arange(cfg.vocab_size), blank)
    kept = [_init_hyp(model, enc_out.device)]
    for t in range(enc_out.shape[0]):
        enc_t = enc_out[t][None]
        hyps = _prefix_search(model, kept, enc_t, prefix_alpha)
        s_pool: list[_Hyp] = []
        v_pool: list[_Hyp] = []
        for n in range(nstep):
            logp = _batch_logp(model, enc_t, hyps)
            for i, hyp in enumerate(hyps):
                s_pool.append(dataclasses.replace(
                    hyp, score=hyp.score + float(logp[i, blank]), dec_outs=hyp.dec_outs[:]))
                for k in nb[np.argsort(-logp[i, nb])][:beam_k]:
                    v_pool.append(_Hyp(score=hyp.score + float(logp[i, k]),
                                       toks=hyp.toks + (int(k),), dec_outs=hyp.dec_outs[:],
                                       state=hyp.state))
            v_pool.sort(key=lambda h: -h.score)
            # subtract: drop the extensions whose sequence is already a hypothesis
            seen = {h.toks for h in hyps}
            v_pool = [v for v in v_pool if v.toks not in seen][:beam_size]
            if not v_pool:
                break
            stepped = _batch_step(model, v_pool)
            if n < nstep - 1:
                for v, (d, st) in zip(v_pool, stepped):
                    v.dec_outs.append(d)
                    v.state = st
                hyps, v_pool = v_pool[:], []
            else:
                logp_b = joint_logp(model, enc_t, torch.cat([d for d, _ in stepped]))
                for i, (v, (d, st)) in enumerate(zip(v_pool, stepped)):
                    if nstep != 1:
                        v.score += float(logp_b[i, blank])
                    v.dec_outs.append(d)
                    v.state = st
        kept = sorted(s_pool + v_pool, key=lambda h: -h.score)[:beam_size]
    return [(h.score, list(h.toks)) for h in kept]


def _select_k_expansions(hyps, logp, max_candidates, gamma):
    """Prune-by-value expansions (transducer/utils.py:137-176): per
    hypothesis its top max_candidates expansions within gamma of its best."""
    out = []
    for i, hyp in enumerate(hyps):
        cand = [(int(k), hyp.score + float(logp[i, k]))
                for k in np.argsort(-logp[i])[:max_candidates]]
        best = max(c[1] for c in cand)
        out.append([c for c in cand if c[1] >= best - gamma])
    return out


@torch.no_grad()
def maes_beam_search(model: Transducer, enc_out: torch.Tensor, beam_size: int = 5,
                     nstep: int = 2, prefix_alpha: int = 1, expansion_gamma: float = 2.3,
                     expansion_beta: int = 2) -> list[tuple[float, list[int]]]:
    """Modified adaptive expansion search for one utterance, enc_out (T, D);
    nstep is at least 2, as in the reference (:127)."""
    cfg = model.cfg
    blank = cfg.blank_id
    nstep = max(nstep, 2)
    max_candidates = beam_size + expansion_beta
    if cfg.vocab_size < max_candidates:
        raise ValueError(f"beam_size+expansion_beta ({max_candidates}) must be <= vocab "
                         f"({cfg.vocab_size})")
    kept = [_init_hyp(model, enc_out.device)]
    for t in range(enc_out.shape[0]):
        enc_t = enc_out[t][None]
        hyps = _prefix_search(model, kept, enc_t, prefix_alpha)
        dup_check = {h.toks for h in hyps}
        list_b: list[_Hyp] = []
        for n in range(nstep):
            logp = _batch_logp(model, enc_t, hyps)
            list_exp: list[_Hyp] = []
            for hyp, expansions in zip(hyps, _select_k_expansions(
                    hyps, logp, max_candidates, expansion_gamma)):
                for k, new_score in expansions:
                    if k == blank:
                        list_b.append(dataclasses.replace(hyp, score=new_score,
                                                          dec_outs=hyp.dec_outs[:]))
                    elif hyp.toks + (k,) not in dup_check:
                        list_exp.append(_Hyp(score=new_score, toks=hyp.toks + (k,),
                                             dec_outs=hyp.dec_outs[:], state=hyp.state))
            if not list_exp:
                kept = sorted(list_b, key=lambda h: -h.score)[:beam_size]
                break
            stepped = _batch_step(model, list_exp)
            if n < nstep - 1:
                for h, (d, st) in zip(list_exp, stepped):
                    h.dec_outs.append(d)
                    h.state = st
                hyps = list_exp[:]
            else:
                logp_b = joint_logp(model, enc_t, torch.cat([d for d, _ in stepped]))
                for i, (h, (d, st)) in enumerate(zip(list_exp, stepped)):
                    h.score += float(logp_b[i, blank])
                    h.dec_outs.append(d)
                    h.state = st
                kept = sorted(list_b + list_exp, key=lambda h: -h.score)[:beam_size]
    return [(h.score, list(h.toks)) for h in kept]
