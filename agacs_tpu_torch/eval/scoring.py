"""sclite-compatible scoring (this package's copy of
`agacs_tpu/eval/scoring.py`): .trn files ("tokens\t(utt_id)" lines, hanzi
as single tokens and everything else as space-split words), MER, English
WER and Mandarin CER (`score_report`) and the per-bucket MER of
code-switched / English / Mandarin reference sentences (`score_by_bucket`).

Alignment is the weighted Levenshtein of sclite (substitution 4,
insertion and deletion 3) in the native C++ aligner `native/align.cpp`
(JAX's, copied), built with g++ on first use (`utils/native.py`; a failed
build raises). `_align_py` is its plain version, which the tests hold it
against.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from agacs_tpu_torch.utils.native import NativeLibrary


def _declare(lib: ctypes.CDLL) -> None:
    lib.align_counts.restype = ctypes.c_int32
    lib.align_counts.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]


ALIGN = NativeLibrary("align", _declare)


def _align_native(ref: list[int], hyp: list[int]) -> tuple[int, int, int, int]:
    r = np.ascontiguousarray(ref, np.int32)
    h = np.ascontiguousarray(hyp, np.int32)
    out = np.zeros(4, np.int32)
    ptr = ctypes.POINTER(ctypes.c_int32)
    ALIGN().align_counts(r.ctypes.data_as(ptr), len(r), h.ctypes.data_as(ptr), len(h),
                         out.ctypes.data_as(ptr))
    return tuple(int(x) for x in out)


def _align_py(ref: list[int], hyp: list[int]) -> tuple[int, int, int, int]:
    w_sub, w_ins, w_del = 4, 3, 3
    nr, nh = len(ref), len(hyp)
    cost = np.zeros((nr + 1, nh + 1), np.int32)
    back = np.zeros((nr + 1, nh + 1), np.int8)
    cost[0, :] = np.arange(nh + 1) * w_ins
    back[0, :] = 3
    cost[:, 0] = np.arange(nr + 1) * w_del
    back[1:, 0] = 2
    for i in range(1, nr + 1):
        for j in range(1, nh + 1):
            match = ref[i - 1] == hyp[j - 1]
            best = cost[i - 1, j - 1] + (0 if match else w_sub)
            op = 0 if match else 1
            if cost[i - 1, j] + w_del < best:
                best, op = cost[i - 1, j] + w_del, 2
            if cost[i, j - 1] + w_ins < best:
                best, op = cost[i, j - 1] + w_ins, 3
            cost[i, j], back[i, j] = best, op
    cor = sub = dele = ins = 0
    i, j = nr, nh
    while i > 0 or j > 0:
        op = back[i, j]
        if op == 0:
            cor, i, j = cor + 1, i - 1, j - 1
        elif op == 1:
            sub, i, j = sub + 1, i - 1, j - 1
        elif op == 2:
            dele, i = dele + 1, i - 1
        else:
            ins, j = ins + 1, j - 1
    return cor, sub, dele, ins


def align_counts(ref_tokens: list[str], hyp_tokens: list[str]) -> tuple[int, int, int, int]:
    """(correct, substitutions, deletions, insertions)."""
    vocab: dict[str, int] = {}
    ref = [vocab.setdefault(t, len(vocab)) for t in ref_tokens]
    hyp = [vocab.setdefault(t, len(vocab)) for t in hyp_tokens]
    return _align_native(ref, hyp)


@dataclasses.dataclass
class ErrorStats:
    correct: int = 0
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0
    n_ref: int = 0
    n_utts: int = 0

    def add(self, ref_tokens: list[str], hyp_tokens: list[str]) -> None:
        c, s, d, i = align_counts(ref_tokens, hyp_tokens)
        self.correct += c
        self.substitutions += s
        self.deletions += d
        self.insertions += i
        self.n_ref += len(ref_tokens)
        self.n_utts += 1

    @property
    def error_rate(self) -> float:
        return (self.substitutions + self.deletions + self.insertions) / max(self.n_ref, 1)

    @property
    def corr_rate(self) -> float:
        return self.correct / max(self.n_ref, 1)

    def as_dict(self) -> dict:
        return {
            "utts": self.n_utts,
            "ref_tokens": self.n_ref,
            "corr": round(100 * self.corr_rate, 2),
            "sub": self.substitutions,
            "del": self.deletions,
            "ins": self.insertions,
            "err": round(100 * self.error_rate, 2),
        }


def _is_english_char(c: str) -> bool:
    return "a" <= c.lower() <= "z"


def is_mandarin_char(c: str) -> bool:
    return (
        not _is_english_char(c)
        and not c.isdigit()
        and c not in (" ", "<", ">", "'")
    )


def mixed_tokens(text: str) -> list[str]:
    """Hanzi as single-char tokens, everything else as space-split words —
    the token stream the recipes' trn files carry (MER basis)."""
    out: list[str] = []
    word = ""
    for c in text:
        if c == " ":
            if word:
                out.append(word)
                word = ""
        elif is_mandarin_char(c):
            if word:
                out.append(word)
                word = ""
            out.append(c)
        else:
            word += c
    if word:
        out.append(word)
    return out


def write_trn(path: str, utts: dict[str, str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for utt_id, text in utts.items():
            f.write(f"{' '.join(mixed_tokens(text))}\t({utt_id})\n")


def read_trn(path: str) -> dict[str, str]:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if "\t" not in line:
                continue
            sent, idx = line.rstrip("\n").split("\t")
            out[idx.strip("()")] = sent
    return out


def word_tokens(text: str) -> list[str]:
    return [w for w in text.split(" ") if w]


def char_tokens(text: str) -> list[str]:
    return [c for c in text if c != " "]


def split_language(text: str) -> tuple[str, str]:
    """(english_part, mandarin_part): english = the words holding no
    mandarin char; mandarin = the mandarin chars only."""
    eng = " ".join(
        w for w in text.split(" ") if w and not any(is_mandarin_char(c) for c in w)
    )
    man = "".join(c for c in text if is_mandarin_char(c))
    return eng, man


def classify_sentence(text: str) -> str:
    """'cs' / 'en' / 'man' bucket of a sentence by its content."""
    has_man = any(is_mandarin_char(c) for c in text if c.strip())
    has_eng = any(_is_english_char(c) for c in text)
    if has_man and has_eng:
        return "cs"
    return "man" if has_man else "en"


def score_by_bucket(refs: dict[str, str], hyps: dict[str, str]) -> dict:
    """Per-bucket mixed-error tables, utterances bucketed by the REFERENCE
    sentence's languages."""
    buckets = {"cs": ErrorStats(), "en": ErrorStats(), "man": ErrorStats()}
    for utt_id, ref_text in refs.items():
        buckets[classify_sentence(ref_text)].add(
            mixed_tokens(ref_text), mixed_tokens(hyps.get(utt_id, "")))
    return {k: v.as_dict() for k, v in buckets.items()}


def score_report(refs: dict[str, str], hyps: dict[str, str]) -> dict:
    """MER + English WER + Mandarin CER."""
    mixed, eng, man = ErrorStats(), ErrorStats(), ErrorStats()
    for utt_id, ref_text in refs.items():
        hyp_text = hyps.get(utt_id, "")
        mixed.add(mixed_tokens(ref_text), mixed_tokens(hyp_text))
        ref_eng, ref_man = split_language(ref_text)
        hyp_eng, hyp_man = split_language(hyp_text)
        eng.add(word_tokens(ref_eng), word_tokens(hyp_eng))
        man.add(char_tokens(ref_man), char_tokens(hyp_man))
    return {"mer": mixed.as_dict(), "english_wer": eng.as_dict(),
            "mandarin_cer": man.as_dict()}
