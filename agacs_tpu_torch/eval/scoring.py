"""sclite .trn files (this package's copy of the .trn helpers of
`agacs_tpu/eval/scoring.py`): "tokens\t(utt_id)" lines, hanzi as single
tokens and everything else as space-split words, the format
`agacs_tpu.bin.score` reads."""

from __future__ import annotations

import os


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
