"""(RNN-)Transducer prediction network, joint network and searches
(counterpart of `agacs_tpu/models/transducer.py`; the reference's
`espnet2/asr/decoder/transducer_decoder.py`,
`espnet2/asr_transducer/joint_network.py` and
`espnet2/asr/transducer/beam_search_transducer.py`).

`Transducer` holds the prediction network (an embedding whose blank row is
the padding row, then N LSTM or GRU layers) and the joint network
lin_out(act(lin_enc(enc) + lin_dec(dec))), lin_dec without a bias. Its
parameters keep JAX's layout leaf for leaf: a layer's `w_ih` / `w_hh` are
(H, gates x H) with the gates in torch's order ([i|f|g|o] for the LSTM,
[r|z|n] for the GRU), so the JAX package's checkpoints and the reference's
(transposed) map onto it. The transducer is kept in float32 whatever the
encoder's compute dtype, as JAX keeps its float32 parameters: the joint runs
the encoder's projection in the encoder's dtype and the rest in float32.

Searches:
  * `greedy_search`: the while form (stay on a frame until blank wins, or
    with `advance_on_emit` the reference's one symbol a frame), reading a
    flag on the host each step to stop;
  * `greedy_search_scan`: the production greedy, a loop over frames with
    at most `max_symbols_per_frame` symbol steps each and no host read
    inside it (JAX's lax.scan);
  * `default_beam_search`: the reference's default beam for one utterance,
    its hypotheses ragged on the host, with the LM shallow fusion over the
    port's `models/lm.py lm_forward`.
The batched TSD / ALSD beams are `decode/transducer_tsd.py`, NSC / mAES
`decode/transducer_nsc.py`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from agacs_tpu_torch.models.whisper import Linear


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    vocab_size: int
    rnn_type: str = "lstm"  # lstm | gru
    num_layers: int = 1
    hidden_size: int = 320
    dropout: float = 0.0
    dropout_embed: float = 0.0
    blank_id: int = 0  # also the embedding's padding row
    joint_space_size: int = 256
    joint_activation: str = "tanh"  # tanh | relu

    def __post_init__(self):
        if self.rnn_type not in ("lstm", "gru"):
            raise ValueError(f"rnn_type must be lstm|gru, got {self.rnn_type!r}")

    @property
    def gates(self) -> int:
        return 4 if self.rnn_type == "lstm" else 3


def _act(name: str):
    return {"tanh": torch.tanh, "relu": torch.relu}[name]


class RNNLayer(nn.Module):
    """One LSTM / GRU layer's parameters in JAX's layout: x @ w_ih + b_ih +
    h @ w_hh + b_hh."""

    def __init__(self, hidden: int, gates: int, device=None):
        super().__init__()
        g = gates * hidden
        self.w_ih = nn.Parameter(torch.zeros(hidden, g, device=device))
        self.w_hh = nn.Parameter(torch.zeros(hidden, g, device=device))
        self.b_ih = nn.Parameter(torch.zeros(g, device=device))
        self.b_hh = nn.Parameter(torch.zeros(g, device=device))


class JointNetwork(nn.Module):
    def __init__(self, encoder_size: int, hidden: int, joint: int, vocab: int,
                 activation: str, device=None):
        super().__init__()
        self.lin_enc = Linear(encoder_size, joint, device=device)
        self.lin_dec = Linear(hidden, joint, bias=False, device=device)
        self.lin_out = Linear(joint, vocab, device=device)
        self.act = _act(activation)

    def forward(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """enc (..., D_enc) and dec (..., H), broadcast -> (..., V) logits:
        the encoder's projection in enc's dtype, the rest in dec's."""
        return self.lin_out(self.act(self.lin_enc(enc) + self.lin_dec(dec)))


class Transducer(nn.Module):
    """`embed` (V, H), `layers` (N `RNNLayer`s) and `joint`, float32."""

    def __init__(self, cfg: TransducerConfig, encoder_size: int, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, h, device=device))
        self.layers = nn.ModuleList(RNNLayer(h, cfg.gates, device)
                                    for _ in range(cfg.num_layers))
        self.joint = JointNetwork(encoder_size, h, cfg.joint_space_size, cfg.vocab_size,
                                  cfg.joint_activation, device)


@torch.no_grad()
def init_transducer_params_(model: Transducer, generator: torch.Generator) -> Transducer:
    """Fill a CPU `Transducer` in place with JAX's init distributions: the
    layers and the joint's weights uniform in +-1/sqrt(fan in), the joint's
    biases 0, the embedding normal with its blank row 0."""
    def uni(p, fan):
        bound = 1.0 / math.sqrt(fan)
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    cfg = model.cfg
    for layer in model.layers:
        for p in (layer.w_ih, layer.w_hh, layer.b_ih, layer.b_hh):
            uni(p, cfg.hidden_size)
    model.embed.copy_(torch.randn(model.embed.shape, generator=generator))
    model.embed[cfg.blank_id] = 0.0
    jn = model.joint
    uni(jn.lin_enc.weight, jn.lin_enc.in_features)
    uni(jn.lin_dec.weight, cfg.hidden_size)
    uni(jn.lin_out.weight, cfg.joint_space_size)
    jn.lin_enc.bias.zero_()
    jn.lin_out.bias.zero_()
    return model


def init_decoder_state(cfg: TransducerConfig, shape, device=None) -> dict:
    """Zero recurrent state for rows of `shape` (an int or a tuple):
    {"h": (L, *shape, H)} and, for the LSTM, "c"."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    zeros = torch.zeros((cfg.num_layers, *shape, cfg.hidden_size), device=device)
    return {"h": zeros, "c": zeros} if cfg.rnn_type == "lstm" else {"h": zeros}


def _rnn_cell(cfg: TransducerConfig, zi: torch.Tensor, layer: RNNLayer, h, c):
    """One torch-layout LSTM / GRU step from zi = x @ w_ih + b_ih."""
    hid = cfg.hidden_size
    if cfg.rnn_type == "lstm":
        z = zi + h @ layer.w_hh + layer.b_hh
        i, f, g, o = z.split(hid, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    zh = h @ layer.w_hh + layer.b_hh
    r = torch.sigmoid(zi[..., :hid] + zh[..., :hid])
    zg = torch.sigmoid(zi[..., hid:2 * hid] + zh[..., hid:2 * hid])
    n = torch.tanh(zi[..., 2 * hid:] + r * zh[..., 2 * hid:])
    return (1.0 - zg) * n + zg * h, c


def _embed(model: Transducer, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows, the blank's zero in value AND gradient (a mask, as
    padding_idx would have it)."""
    emb = model.embed[tokens]
    return emb * (tokens != model.cfg.blank_id)[..., None].to(emb.dtype)


def _dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=generator.device) >= p
    return x * keep.to(x.device, x.dtype) / (1.0 - p)


def transducer_decoder(model: Transducer, tokens: torch.Tensor, train: bool = False,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """Teacher-forced pass: (B, U) blank-prefixed label ids -> (B, U, H).
    With `train` and a generator, the embedding's and each layer's dropout
    are drawn from it."""
    cfg = model.cfg
    x = _embed(model, tokens)
    drop = train and generator is not None
    if drop and cfg.dropout_embed > 0.0:
        x = _dropout(x, cfg.dropout_embed, generator)
    for layer in model.layers:
        zi = x @ layer.w_ih + layer.b_ih  # every position's input projection at once
        h = c = torch.zeros(x.shape[0], cfg.hidden_size, device=x.device, dtype=x.dtype)
        outs = []
        for u in range(x.shape[1]):
            h, c = _rnn_cell(cfg, zi[:, u], layer, h, c)
            outs.append(h)
        x = torch.stack(outs, 1)
        if drop and cfg.dropout > 0.0:
            x = _dropout(x, cfg.dropout, generator)
    return x


def transducer_decoder_step(model: Transducer, token: torch.Tensor, state: dict
                            ) -> tuple[torch.Tensor, dict]:
    """One autoregressive step for rows of any shape S: token S -> ((*S, H)
    output, the new state)."""
    cfg = model.cfg
    x = _embed(model, token)
    hs, cs = [], []
    for li, layer in enumerate(model.layers):
        c_li = state["c"][li] if cfg.rnn_type == "lstm" else state["h"][li]
        x, c_new = _rnn_cell(cfg, x @ layer.w_ih + layer.b_ih, layer, state["h"][li], c_li)
        hs.append(x)
        cs.append(c_new)
    new_state = {"h": torch.stack(hs)}
    if cfg.rnn_type == "lstm":
        new_state["c"] = torch.stack(cs)
    return x, new_state


def joint(model: Transducer, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """The joint network (joint_network.py:42-59): (..., D_enc) x (..., H)
    broadcast -> (..., V) logits."""
    return model.joint(enc, dec)


def joint_lattice(model: Transducer, enc_out: torch.Tensor, dec_out: torch.Tensor
                  ) -> torch.Tensor:
    """(B, T, D_enc) x (B, U+1, H) -> (B, T, U+1, V) joint logits."""
    return joint(model, enc_out[:, :, None, :], dec_out[:, None, :, :])


def _select(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """The state rows of `new` where mask (rows), else `old`'s."""
    return {k: torch.where(mask[None, ..., None], new[k], old[k]) for k in old}


def _first_step(model: Transducer, shape, device) -> tuple[torch.Tensor, dict]:
    """The decoder output and state after the blank start symbol."""
    cfg = model.cfg
    return transducer_decoder_step(
        model, torch.full(shape, cfg.blank_id, dtype=torch.long, device=device),
        init_decoder_state(cfg, shape, device))


@torch.no_grad()
def greedy_search(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                  max_symbols: int | None = None, advance_on_emit: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy decoding, the while form. By default the standard
    (Graves) greedy: emit the argmax symbol and stay on the frame until
    blank wins. `advance_on_emit` moves to the next frame after every
    prediction, the reference's greedy_search (:221-253). Stops when no row
    is active or after T + max_symbols steps (a host read a step).
    Returns (tokens (B, max_symbols) blank-padded, n_emitted (B,));
    max_symbols defaults to T."""
    cfg = model.cfg
    bsz, t_max, _ = enc_out.shape
    dev = enc_out.device
    u_cap = int(max_symbols or t_max)
    rows = torch.arange(bsz, device=dev)
    dec, state = _first_step(model, (bsz,), dev)
    # one column more: rows that do not emit at n = u_cap write their own value there
    tokens = torch.full((bsz, u_cap + 1), cfg.blank_id, dtype=torch.long, device=dev)
    t = torch.zeros(bsz, dtype=torch.long, device=dev)
    n = torch.zeros_like(t)
    for _ in range(t_max + u_cap):
        active = (t < enc_lens) & (n < u_cap)
        if not bool(active.any()):
            break
        enc_t = enc_out[rows, t.clamp(max=t_max - 1)]
        best = joint(model, enc_t, dec).argmax(-1)
        emit = active & (best != cfg.blank_id)
        new_dec, new_state = transducer_decoder_step(
            model, torch.where(emit, best, cfg.blank_id), state)
        state = _select(emit, new_state, state)
        dec = torch.where(emit[:, None], new_dec, dec)
        tokens[rows, n] = torch.where(emit, best, tokens[rows, n])
        n = n + emit.long()
        t = t + (active if advance_on_emit else active & ~emit).long()
    return tokens[:, :u_cap], n


@torch.no_grad()
def greedy_search_scan(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                       max_symbols_per_frame: int = 4, max_symbols: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding as a loop over frames: per frame a chain of up to
    `max_symbols_per_frame` argmax emissions, stopping at blank (JAX's
    lax.scan form). It equals `greedy_search` whenever no frame emits more
    than the cap. Every step runs on the device for every row, masked, with
    no host read: the trip count is T x max_symbols_per_frame."""
    cfg = model.cfg
    bsz, t_max, _ = enc_out.shape
    dev = enc_out.device
    u_cap = int(max_symbols or t_max)
    rows = torch.arange(bsz, device=dev)
    dec, state = _first_step(model, (bsz,), dev)
    tokens = torch.full((bsz, u_cap + 1), cfg.blank_id, dtype=torch.long, device=dev)
    n_tok = torch.zeros(bsz, dtype=torch.long, device=dev)
    valid = torch.arange(t_max, device=dev)[:, None] < enc_lens[None, :]
    for t in range(t_max):
        enc_t = enc_out[:, t]
        done = ~valid[t]
        for _ in range(max_symbols_per_frame):
            best = joint(model, enc_t, dec).argmax(-1)
            emit = ~done & (best != cfg.blank_id) & (n_tok < u_cap)
            new_dec, new_state = transducer_decoder_step(
                model, torch.where(emit, best, cfg.blank_id), state)
            dec = torch.where(emit[:, None], new_dec, dec)
            state = _select(emit, new_state, state)
            tokens[rows, n_tok] = torch.where(emit, best, tokens[rows, n_tok])
            n_tok = n_tok + emit.long()
            done = done | ~emit
    return tokens[:, :u_cap], n_tok


def _lm_next_logp(lm, prefix: list[int]) -> np.ndarray:
    """The LM's float32 next-token log-probabilities after `prefix`."""
    from agacs_tpu_torch.models.lm import lm_forward

    dev = lm.embed.device
    logits = lm_forward(lm, torch.tensor([prefix], dtype=torch.long, device=dev))
    return torch.log_softmax(logits[0, -1].float(), -1).cpu().numpy()


def joint_logp(model: Transducer, enc: torch.Tensor, dec: torch.Tensor) -> np.ndarray:
    """float32 joint log-probabilities, on the host."""
    return torch.log_softmax(joint(model, enc, dec).float(), -1).cpu().numpy()


@torch.no_grad()
def default_beam_search(model: Transducer, enc_out: torch.Tensor, beam_size: int = 5,
                        max_symbols_per_frame: int = 3, lm=None, lm_weight: float = 0.0,
                        lm_sos: int = 50258) -> list[tuple[float, list[int]]]:
    """The reference's default_beam_search (:255-354) for one utterance,
    enc_out (T, D_enc): hypotheses ragged on the host, each expansion a
    joint and decoder step on the device. Returns [(score, tokens)]
    best-first, scores unnormalised log-probs. With `lm` (a
    `models.lm.TransformerLM`) and `lm_weight`, non-blank expansions get
    shallow fusion over the [lm_sos] + tokens prefix, cached per hypothesis
    (:314-336); blank extensions are not LM scored."""
    cfg = model.cfg
    dev = enc_out.device
    dec0, state0 = _first_step(model, (1,), dev)
    kept = [(0.0, (), dec0, state0)]
    cache_lm: dict[tuple, np.ndarray] = {}
    for t in range(enc_out.shape[0]):
        enc_t = enc_out[t][None]
        hyps, kept = kept, []
        for _ in range(beam_size * max_symbols_per_frame):
            if not hyps:
                break
            hyps.sort(key=lambda h: -h[0])
            score, toks, dec, st = hyps.pop(0)
            logp = joint_logp(model, enc_t, dec)[0]
            kept.append((score + float(logp[cfg.blank_id]), toks, dec, st))
            lm_scores = None
            if lm is not None and lm_weight:
                if toks not in cache_lm:
                    cache_lm[toks] = _lm_next_logp(lm, [lm_sos, *toks])
                lm_scores = cache_lm[toks]
            n_exp = 0
            for v in np.argsort(-logp):
                if v == cfg.blank_id:
                    continue
                new_dec, new_st = transducer_decoder_step(
                    model, torch.tensor([int(v)], device=dev), st)
                new_score = score + float(logp[v])
                if lm_scores is not None:
                    new_score += lm_weight * float(lm_scores[v])
                hyps.append((new_score, toks + (int(v),), new_dec, new_st))
                n_exp += 1
                if n_exp >= beam_size:
                    break
            kept.sort(key=lambda h: -h[0])
            if len(kept) >= beam_size and (
                    not hyps or kept[beam_size - 1][0] >= max(h[0] for h in hyps)):
                break
        best: dict[tuple, tuple] = {}
        for h in kept:
            if h[1] not in best or h[0] > best[h[1]][0]:
                best[h[1]] = h
        kept = sorted(best.values(), key=lambda h: -h[0])[:beam_size]
    return [(s, list(toks)) for s, toks, _, _ in kept]
