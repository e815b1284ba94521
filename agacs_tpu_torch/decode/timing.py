"""Word-level timestamps from cross-attention alignment (counterpart of
`agacs_tpu/decode/timing.py`, the bundled whisper `timing.py`
find_alignment + DTW).

Pipeline (timing.py:163-255 find_alignment):
  teacher-forced decode collecting cross-attention scores
  -> select alignment heads -> softmax over audio frames (qk_scale)
  -> per-head standardize over tokens -> median filter (width 7)
  -> mean over heads -> DTW over -matrix -> token->frame jump times
  -> group tokens into words, attach start/end/probability.

The DTW is the native C++ DP `native/dtw.cpp` (JAX's, copied), built with
g++ on first use (`utils/native.py`). A failed build raises, where JAX
falls back to Python; `_dtw_py` is the plain version the tests hold the
library against. Alignment heads default to every head of the upper half
of the decoder layers, and words split on leading spaces and CJK
characters, as in JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from agacs_tpu_torch.utils.native import NativeLibrary

TOKENS_PER_SECOND = 50  # encoder frames per second (20 ms hop after the conv stem)


def _declare(lib: ctypes.CDLL) -> None:
    lib.dtw_path.restype = ctypes.c_longlong
    lib.dtw_path.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]


DTW = NativeLibrary("dtw", _declare)


def dtw(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path over an (N, M) cost matrix
    (timing.py:83-106 dtw_cpu). Returns (text_indices, time_indices)."""
    x = np.ascontiguousarray(x, np.float32)
    n, m = x.shape
    pi = np.empty(n + m, np.int32)
    pj = np.empty(n + m, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    length = DTW().dtw_path(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, m,
                            pi.ctypes.data_as(i32), pj.ctypes.data_as(i32))
    if length <= 0:
        raise ValueError(f"dtw: empty cost matrix {x.shape}")
    return pi[:length], pj[:length]


def _dtw_py(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The literal DP (slow): the native DTW's plain version."""
    n, m = x.shape
    cost = np.full((n + 1, m + 1), np.inf, np.float32)
    trace = -np.ones((n + 1, m + 1), np.int8)
    cost[0, 0] = 0.0
    for j in range(1, m + 1):
        for i in range(1, n + 1):
            c0, c1, c2 = cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = x[i - 1, j - 1] + c
            trace[i, j] = t
    trace[0, :] = 2
    trace[:, 0] = 1
    i, j = n, m
    ri, rj = [], []
    while i > 0 or j > 0:
        ri.append(i - 1)
        rj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ri[::-1], np.int32), np.asarray(rj[::-1], np.int32)


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis, reflect-padded (timing.py:19-55)."""
    assert width > 0 and width % 2 == 1
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1).astype(x.dtype)


@dataclasses.dataclass
class WordTiming:
    word: str
    tokens: list[int]
    start: float
    end: float
    probability: float


PREPEND_PUNCT = "\"'“¿([{-"
APPEND_PUNCT = "\"'.。,，!！?？:：”)]}、"


def merge_punctuations(
    alignment: list[WordTiming],
    prepended: str = PREPEND_PUNCT,
    appended: str = APPEND_PUNCT,
) -> list[WordTiming]:
    """Fold punctuation-only 'words' into their neighbours
    (timing.py:258-289 merge_punctuations): opening marks attach to the
    following word, closing marks to the preceding one. Returns the
    alignment with emptied entries dropped."""
    # prepended: scan right-to-left
    i, j = len(alignment) - 2, len(alignment) - 1
    while i >= 0:
        prev, foll = alignment[i], alignment[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            foll.word = prev.word + foll.word
            foll.tokens = prev.tokens + foll.tokens
            foll.start = prev.start
            prev.word, prev.tokens = "", []
        else:
            j = i
        i -= 1
    # appended: scan left-to-right
    i, j = 0, 1
    while j < len(alignment):
        prev, foll = alignment[i], alignment[j]
        if not prev.word.endswith(" ") and foll.word in appended:
            prev.word = prev.word + foll.word
            prev.tokens = prev.tokens + foll.tokens
            prev.end = foll.end
            foll.word, foll.tokens = "", []
        else:
            i = j
        j += 1
    return [w for w in alignment if w.word]


def _split_to_word_tokens(tokens: list[int], tokenizer):
    """Group text tokens into words: split on leading spaces, and treat CJK
    characters as words of their own (split_tokens_on_spaces /
    split_tokens_on_unicode)."""
    words, word_tokens = [], []
    cur_text, cur_toks = "", []

    def flush():
        nonlocal cur_text, cur_toks
        if cur_toks:
            words.append(cur_text)
            word_tokens.append(cur_toks)
        cur_text, cur_toks = "", []

    for t in tokens:
        piece = tokenizer.decode([t], skip_special=False)
        starts_word = piece.startswith(" ") or any("一" <= c <= "鿿" for c in piece)
        if starts_word and cur_toks:
            flush()
        cur_text += piece
        cur_toks.append(t)
    flush()
    return words, word_tokens


@torch.inference_mode()
def find_word_alignment(
    model,
    tokenizer,
    text_tokens: list[int],
    enc: torch.Tensor,
    num_frames: int,
    alignment_heads: list[tuple[int, int]] | None = None,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
    primer: tuple[int, ...] = (50258, 50260, 50259, 50359, 50363),
) -> list[WordTiming]:
    """Word timings for one utterance (timing.py:163-255 find_alignment).

    enc: (1, T_enc, d) encoder output on the model's device; num_frames:
    valid encoder frames. The teacher-forced decode runs on the model's
    device; the cross-attention maps come to the host in float32."""
    from agacs_tpu_torch.models.whisper import whisper_decode

    if not text_tokens:
        return []
    sp = tokenizer.special
    tokens = list(primer) + list(text_tokens) + [sp.eot]
    toks = torch.tensor([tokens], dtype=torch.long, device=enc.device)

    logits, aux = whisper_decode(model, toks, enc, collect_cross_maps=True)
    lp = torch.softmax(logits[0].float(), -1)
    n_primer = len(primer)
    idx = torch.arange(len(text_tokens), device=lp.device)
    text_probs = lp[n_primer - 1 + idx, torch.tensor(text_tokens, device=lp.device)]
    text_probs = text_probs.cpu().numpy().tolist()

    maps = aux["cross_maps"].float().cpu().numpy()  # (L, 1, h, T, T_enc)
    n_layers = maps.shape[0]
    if alignment_heads is None:
        alignment_heads = [(l, h) for l in range(n_layers // 2, n_layers)
                           for h in range(maps.shape[2])]
    w = np.stack([maps[l, 0, h] for l, h in alignment_heads])  # (H, T, T_enc)
    w = w[:, :, : max(num_frames, 1)]
    w = w * qk_scale
    w = np.exp(w - w.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    mean = w.mean(-2, keepdims=True)
    std = w.std(-2, keepdims=True) + 1e-8
    w = (w - mean) / std
    w = median_filter(w, medfilt_width)
    matrix = w.mean(0)[n_primer - 1 : -1]  # rows producing the text tokens + eot

    text_idx, time_idx = dtw(-matrix)

    words, word_tokens = _split_to_word_tokens(list(text_tokens) + [sp.eot], tokenizer)
    bounds = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0)).astype(int)
    jumps = np.pad(np.diff(text_idx), (1, 0), constant_values=1).astype(bool)
    jump_times = time_idx[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[np.minimum(bounds[:-1], len(jump_times) - 1)]
    end_times = jump_times[np.minimum(bounds[1:], len(jump_times) - 1)]
    probs = [float(np.mean(text_probs[i:j])) if j > i else 0.0
             for i, j in zip(bounds[:-1], bounds[1:])]
    alignment = [WordTiming(wd, tk, float(s), float(e), p)
                 for wd, tk, s, e, p in zip(words, word_tokens, start_times, end_times, probs)]
    return merge_punctuations(alignment)
