"""N-gram LM scorer for beam fusion (counterpart of `agacs_tpu/models/ngram.py`):
hashed count tables scored with STUPID BACKOFF

  S(t | ctx) = count(ctx.t) / count(ctx)        if count(ctx.t) > 0
             = alpha . S(t | ctx[1:])            otherwise

one hashed lookup per (hypothesis, candidate, order), vectorised over the
whole vocabulary on the model's device.

Keys are two independent 32-bit FNV-style hashes; a match needs both
lanes. The hash is uint32 arithmetic, `(h ^ (t + 1)) * M mod 2^32`. PyTorch
has no uint32 multiply on CUDA, so the lanes are int64 tensors holding
values below 2^32, and each product is formed from M's 16-bit halves
(`_mul_u32`): every partial product stays below 2^49, so nothing relies on
signed wrap-around, and the bits equal JAX's on the CPU and on the card.
Every score is a float32 sum in JAX's order, so the scores equal JAX's.

Training counts on the host (`train_ngram`, numpy and Python ints, as in
JAX); `save_ngram` / `load_ngram` read and write JAX's npz layout (uint32
keys), so a table written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_M1 = 2654435761
_M2 = 0x9E3779B1
_SEED1 = 2166136261
_SEED2 = 0x811C9DC5 ^ 0x5BD1E995
_EMPTY = 0xFFFFFFFF
_MASK = 0xFFFFFFFF
_PROBES = 8


def _hash_ngram_host(ngram) -> tuple[int, int]:
    h1, h2 = _SEED1, _SEED2
    for t in ngram:
        t = int(t)  # numpy ints would overflow-warn / change dtype
        h1 = ((h1 ^ (t + 1)) * _M1) & _MASK
        h2 = ((h2 ^ (t + 2)) * _M2) & _MASK
    return h1, h2


def _mul_u32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32) and a constant m < 2^32,
    from m's 16-bit halves: h * lo < 2^48 and ((h * hi) mod 2^16) << 16 <
    2^32, so no int64 product overflows."""
    hi, lo = m >> 16, m & 0xFFFF
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


@dataclasses.dataclass
class NgramLM:
    """Per-order hash tables. For order o+2 n-grams: keys1/keys2[o]: (S,)
    int64 lanes (values below 2^32; linear probing from lane 1), logps[o]:
    (S,) float32 log S(t|ctx). The unigram is dense (V,) float32."""

    order: int
    alpha: float
    unigram: torch.Tensor
    keys1: list
    keys2: list
    logps: list

    def to(self, device) -> "NgramLM":
        def mv(xs):
            return [x.to(device) for x in xs]

        return NgramLM(self.order, self.alpha, self.unigram.to(device), mv(self.keys1),
                       mv(self.keys2), mv(self.logps))


def train_ngram(
    seqs: list[list[int]],
    vocab_size: int,
    order: int = 3,
    alpha: float = 0.4,
    sos: int | None = None,
) -> NgramLM:
    """Count n-grams (orders 1..order) over token sequences. Each sequence
    is sos-prefixed when `sos` is given (context for the first token).
    The tables are CPU tensors; `.to(device)` moves them."""
    from collections import Counter

    grams = [Counter() for _ in range(order)]  # grams[o]: (o+1)-grams
    for seq in seqs:
        s = ([sos] if sos is not None else []) + list(seq)
        start = 1 if sos is not None else 0
        for i in range(start, len(s)):
            for o in range(order):
                if i - o < 0:
                    break
                grams[o][tuple(s[i - o : i + 1])] += 1

    # unigram: dense log p with add-1 smoothing over the full vocab
    uni = np.ones(vocab_size, np.float64)
    for (t,), c in grams[0].items():
        uni[t] += c
    unigram = np.log(uni / uni.sum()).astype(np.float32)

    keys1, keys2, logps = [], [], []
    for o in range(1, order):
        # denominator = continuation count of the context (sum_t c(ctx.t)),
        # not the context's own n-gram count: contexts containing sos are
        # never themselves counted as lower-order grams
        denom = Counter()
        for g, c in grams[o].items():
            denom[g[:-1]] += c
        items = []
        for g, c in grams[o].items():
            items.append((g, np.log(c / denom[g[:-1]])))
        size = max(64, 1 << int(np.ceil(np.log2(max(len(items), 1) * 2))))
        k1 = np.full(size, _EMPTY, np.uint32)
        k2 = np.zeros(size, np.uint32)
        v_arr = np.zeros(size, np.float32)
        for g, lp in items:
            h1, h2 = _hash_ngram_host(g)
            slot = h1 % size
            for _ in range(size):
                if k1[slot] == _EMPTY:
                    k1[slot], k2[slot], v_arr[slot] = h1, h2, lp
                    break
                if k1[slot] == h1 and k2[slot] == h2:
                    break  # full 64-bit collision: keep the first (~never)
                slot = (slot + 1) % size
        keys1.append(k1)
        keys2.append(k2)
        logps.append(v_arr)
    return _from_numpy(order, alpha, unigram, keys1, keys2, logps)


def _from_numpy(order, alpha, unigram, keys1, keys2, logps) -> NgramLM:
    def keys(xs):
        return [torch.from_numpy(np.asarray(x).astype(np.int64)) for x in xs]

    return NgramLM(order=int(order), alpha=float(alpha),
                   unigram=torch.from_numpy(np.asarray(unigram, np.float32)),
                   keys1=keys(keys1), keys2=keys(keys2),
                   logps=[torch.from_numpy(np.asarray(x, np.float32)) for x in logps])


def _hash_rows(ctx: torch.Tensor, cand: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ctx: (N, L) int64 contexts; cand: (V,) candidates -> two (N, V) int64
    hash lanes of ctx.cand (the host hasher's recurrence)."""
    n = ctx.shape[0]
    h1 = torch.full((n,), _SEED1, dtype=torch.int64, device=ctx.device)
    h2 = torch.full((n,), _SEED2, dtype=torch.int64, device=ctx.device)
    for i in range(ctx.shape[1]):
        t = ctx[:, i] & _MASK
        h1 = _mul_u32(h1 ^ ((t + 1) & _MASK), _M1)
        h2 = _mul_u32(h2 ^ ((t + 2) & _MASK), _M2)
    c = cand & _MASK
    h1 = _mul_u32(h1[:, None] ^ ((c + 1) & _MASK)[None, :], _M1)
    h2 = _mul_u32(h2[:, None] ^ ((c + 2) & _MASK)[None, :], _M2)
    return h1, h2


def _lookup(keys1, keys2, logps, h1, h2) -> tuple[torch.Tensor, torch.Tensor]:
    """Open-addressing probe -> (found bool, logp), vectorised."""
    size = keys1.shape[0]
    slot = h1 % size
    found = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    val = torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
    done = torch.zeros_like(found)
    for _ in range(_PROBES):
        k1 = keys1[slot]
        hit = (k1 == h1) & (keys2[slot] == h2) & ~done
        val = torch.where(hit, logps[slot], val)
        found = found | hit
        done = done | hit | (k1 == _EMPTY)
        slot = torch.where(done, slot, (slot + 1) % size)
    return found, val


def ngram_score_step(lm: NgramLM, tokens: torch.Tensor, pos: int) -> torch.Tensor:
    """(N, total) token buffer + the current position (a Python int) ->
    (N, V) float32 log scores of every next-token candidate under stupid
    backoff. Positions before the sequence start fall through to shorter
    orders."""
    n = tokens.shape[0]
    v = lm.unigram.shape[0]
    dev = lm.unigram.device
    cand = torch.arange(v, dtype=torch.int64, device=dev)
    log_alpha = np.float32(np.log(lm.alpha))

    # the backoff level counts only FAILED lookups among AVAILABLE context
    # lengths: a short history at the sequence start is not a backoff
    max_avail = min(lm.order - 1, pos + 1)

    # default: the unigram with full backoff from the longest context
    score = (lm.unigram[None, :] + float(log_alpha * np.float32(max_avail))).expand(n, v)
    resolved = torch.zeros((n, v), dtype=torch.bool, device=dev)

    for o in range(lm.order - 1, 0, -1):  # context length o, high first
        if pos - o + 1 < 0:  # no context of this length yet: nothing found
            continue
        ctx = tokens[:, pos - o + 1 : pos + 1].to(device=dev, dtype=torch.int64)  # (N, o)
        h1, h2 = _hash_rows(ctx, cand)
        found, lp = _lookup(lm.keys1[o - 1], lm.keys2[o - 1], lm.logps[o - 1], h1, h2)
        use = found & ~resolved
        backoff = float(log_alpha * np.float32(max_avail - o))
        score = torch.where(use, lp + backoff, score)
        resolved = resolved | found
    return score


def save_ngram(path: str, lm: NgramLM) -> None:
    """JAX's npz layout: order, alpha, unigram, keys1_i / keys2_i (uint32)
    and logps_i per order."""
    arrs = {"unigram": lm.unigram.cpu().numpy()}
    for i in range(lm.order - 1):
        arrs[f"keys1_{i}"] = lm.keys1[i].cpu().numpy().astype(np.uint32)
        arrs[f"keys2_{i}"] = lm.keys2[i].cpu().numpy().astype(np.uint32)
        arrs[f"logps_{i}"] = lm.logps[i].cpu().numpy()
    np.savez(path, order=lm.order, alpha=lm.alpha, **arrs)


def load_ngram(path: str, device=None) -> NgramLM:
    with np.load(path) as d:
        order = int(d["order"])
        lm = _from_numpy(order, float(d["alpha"]), d["unigram"],
                         [d[f"keys1_{i}"] for i in range(order - 1)],
                         [d[f"keys2_{i}"] for i in range(order - 1)],
                         [d[f"logps_{i}"] for i in range(order - 1)])
    return lm.to(device) if device is not None else lm
