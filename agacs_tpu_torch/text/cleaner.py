"""Text cleaners (this package's copy of `agacs_tpu/text/cleaner.py`) —
behavior-compatible with the reference's `whisper_basic`
cleaner (`espnet2/text/cleaner.py:45` → whisper `BasicTextNormalizer`)."""

from __future__ import annotations

import re
import unicodedata


def remove_symbols(s: str) -> str:
    """Replace markers/symbols/punctuation with spaces (NFKC-normalized)."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


# non-ASCII letters that NFKD does not decompose — mapped by hand, matching
# whisper `normalizers/basic.py:7-24` so remove_diacritics output is
# bit-identical for œ/ß/ø-class characters.
ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    return "".join(
        c
        if c in keep
        else (
            ADDITIONAL_DIACRITICS[c]
            if c in ADDITIONAL_DIACRITICS
            else ""
            if unicodedata.category(c) == "Mn"
            else " " if unicodedata.category(c)[0] in "MSP" else c
        )
        for c in unicodedata.normalize("NFKD", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            (lambda s: remove_symbols_and_diacritics(s))
            if remove_diacritics
            else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove bracketed words
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove parenthesized words
        s = self.clean(s).lower()
        if self.split_letters:
            import regex

            s = " ".join(regex.findall(r"\X", s, regex.U))
        s = re.sub(r"\s+", " ", s)
        return s.strip()


class TextCleaner:
    """Name-dispatched cleaner chain (`espnet2/text/cleaner.py`)."""

    def __init__(self, cleaner_types=None):
        if cleaner_types is None:
            cleaner_types = []
        if isinstance(cleaner_types, str):
            cleaner_types = [cleaner_types]
        self.cleaner_types = list(cleaner_types)
        self._basic = BasicTextNormalizer()

    def __call__(self, text: str) -> str:
        for t in self.cleaner_types:
            if t == "whisper_basic":
                text = self._basic(text)
            elif t in ("none", None):
                pass
            else:
                raise ValueError(f"unsupported cleaner: {t}")
        return text
