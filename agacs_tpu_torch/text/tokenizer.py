"""Whisper multilingual BPE tokenizer + ESPnet-style token-id converter
(this package's copy of `agacs_tpu/text/tokenizer.py`, so the port imports
nothing of the JAX package).

The rank file is data, not code, and is not copied: the tokenizer opens
`agacs_tpu/text/assets/multilingual.tiktoken` in the checkout by path
(no import), unless AGACS_TIKTOKEN names another file.

Re-implements the text layer of the reference:

  * byte-level BPE over the Whisper `multilingual.tiktoken` rank file
    (data asset; path configurable, defaults to the reference's bundled
    copy) — equivalent to HF `WhisperTokenizer` tokenization used at
    `espnet2/text/whisper_tokenizer.py:33` / `whisper_token_id_converter.py:41`;
  * the converter that prepends the dual-language prompt
    `[50260, 50259, 50359, 50363]` (zh, en, transcribe, notimestamps) and
    appends `<|endoftext|>` on encode, and strips specials on decode
    (`whisper_token_id_converter.py:57-70`);
  * HF-style byte-repr token strings (GPT-2 byte encoder) so the
    language-attribution logic (`espnet_model.py:234-235` `is_english`:
    strip "Ġ", all-ASCII-letters test) behaves identically.

Special-token id map (multilingual, n_vocab=51865):
  50257 <|endoftext|>, 50258 <|startoftranscript|>, 50259..50357 languages,
  50358 <|translate|>, 50359 <|transcribe|>, 50360 <|startoflm|>,
  50361 <|startofprev|>, 50362 <|nospeech|>, 50363 <|notimestamps|>,
  50364..51863 timestamps <|0.00|>..<|29.98|>.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import os
import string

# The BPE rank table is the JAX package's data file, read by path (the
# same base64 rank dump openai/tiktoken distributes); AGACS_TIKTOKEN overrides.
DEFAULT_TIKTOKEN_PATHS = (
    os.environ.get("AGACS_TIKTOKEN", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "agacs_tpu", "text", "assets",
        "multilingual.tiktoken"),
)

# Whisper language order; index i -> token id 50259 + i.
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su",
)

_GPT2_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    eot: int = 50257  # <|endoftext|>
    sot: int = 50258  # <|startoftranscript|>
    lang_base: int = 50259
    translate: int = 50358
    transcribe: int = 50359
    sot_lm: int = 50360
    sot_prev: int = 50361
    no_speech: int = 50362
    no_timestamps: int = 50363
    timestamp_begin: int = 50364
    n_vocab: int = 51865

    def lang_id(self, lang: str) -> int:
        return self.lang_base + LANGUAGES.index(lang)


@functools.lru_cache(maxsize=1)
def _byte_encoder() -> dict[int, str]:
    """GPT-2 byte -> unicode-char mapping (the 'Ġ' convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@functools.lru_cache(maxsize=1)
def _byte_decoder() -> dict[str, int]:
    return {c: b for b, c in _byte_encoder().items()}


def _find_tiktoken_file(path: str | None) -> str:
    candidates = (path,) if path else DEFAULT_TIKTOKEN_PATHS
    for p in candidates:
        if p and os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no tiktoken vocab found; tried {candidates}. Set AGACS_TIKTOKEN."
    )


class WhisperTokenizer:
    """Byte-level BPE with Whisper multilingual specials.

    Uses the `tiktoken` engine when importable (fast Rust BPE); the rank
    table itself is loaded from the standard tiktoken text format.
    """

    def __init__(self, vocab_path: str | None = None, language: str = "zh"):
        self.special = SpecialTokens()
        self.language = language
        path = _find_tiktoken_file(vocab_path)
        ranks: dict[bytes, int] = {}
        with open(path) as f:
            for line in f:
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
        self._ranks = ranks
        n_base = len(ranks)  # 50257

        specials = {"<|endoftext|>": self.special.eot,
                    "<|startoftranscript|>": self.special.sot}
        for i, lang in enumerate(LANGUAGES):
            specials[f"<|{lang}|>"] = self.special.lang_base + i
        specials.update({
            "<|translate|>": self.special.translate,
            "<|transcribe|>": self.special.transcribe,
            "<|startoflm|>": self.special.sot_lm,
            "<|startofprev|>": self.special.sot_prev,
            "<|nospeech|>": self.special.no_speech,
            "<|notimestamps|>": self.special.no_timestamps,
        })
        for i in range(self.special.n_vocab - self.special.timestamp_begin):
            specials[f"<|{i * 0.02:.2f}|>"] = self.special.timestamp_begin + i
        self._specials = specials
        self._specials_inv = {v: k for k, v in specials.items()}

        import tiktoken

        self._enc = tiktoken.Encoding(
            name="whisper_multilingual",
            explicit_n_vocab=n_base + len(specials),
            pat_str=_GPT2_PAT,
            mergeable_ranks=ranks,
            special_tokens=specials,
        )

    # --- core BPE ---

    def encode(self, text: str) -> list[int]:
        return self._enc.encode(text, disallowed_special=())

    def decode(self, ids, skip_special: bool = True) -> str:
        ids = [int(i) for i in ids]
        if skip_special:
            ids = [i for i in ids if i < self.special.eot]
        return self._enc.decode(ids)

    # --- HF-style token-string views (byte-level repr) ---

    def id_to_token(self, tid: int) -> str:
        if tid in self._specials_inv:
            return self._specials_inv[tid]
        raw = self._enc.decode_single_token_bytes(tid)
        be = _byte_encoder()
        return "".join(be[b] for b in raw)

    def token_to_id(self, token: str) -> int:
        if token in self._specials:
            return self._specials[token]
        bd = _byte_decoder()
        raw = bytes(bd[c] for c in token)
        return self._ranks[raw]

    def text2tokens(self, line: str) -> list[str]:
        """HF `_tokenize` equivalent (whisper_tokenizer.py:40-43)."""
        return [self.id_to_token(i) for i in self.encode(line)]

    def tokens2text(self, tokens) -> str:
        bd = _byte_decoder()
        raw = bytes(bd[c] for tok in tokens if tok not in self._specials for c in tok)
        return raw.decode("utf-8", errors="replace")

    # --- language attribution (espnet_model.py:234-235) ---

    @staticmethod
    def token_is_english(token: str) -> bool:
        """True iff the token (with byte-level space 'Ġ' removed) consists
        solely of ASCII letters. Exactly the reference `is_english`; note
        punctuation therefore counts as NON-English, as in the reference."""
        stripped = token.replace("Ġ", "")
        return all(c in string.ascii_letters for c in stripped)


class WhisperTokenIdConverter:
    """tokens <-> ids with the dual-language CS prompt.

    Encode prepends `[<|zh|>, <|en|>, <|transcribe|>, <|notimestamps|>]`
    (ids [50260, 50259, 50359, 50363]) and appends `<|endoftext|>`
    (whisper_token_id_converter.py:57-64). `<|startoftranscript|>` is added
    later by the loss/decode layers as the sos (add_sos_eos), yielding the
    full prompt [50258, 50260, 50259, 50359, 50363].
    """

    def __init__(self, tokenizer: WhisperTokenizer | None = None,
                 prefix_langs: tuple[str, ...] = ("zh", "en")):
        self.tokenizer = tokenizer or WhisperTokenizer()
        sp = self.tokenizer.special
        self.prefix_ids = [sp.lang_id(lang) for lang in prefix_langs] + [
            sp.transcribe, sp.no_timestamps,
        ]
        self.eot = sp.eot

    def get_num_vocabulary_size(self) -> int:
        return self.tokenizer.special.n_vocab

    def tokens2ids(self, tokens) -> list[int]:
        return (
            self.prefix_ids
            + [self.tokenizer.token_to_id(t) for t in tokens]
            + [self.eot]
        )

    def ids2tokens(self, ids) -> list[str]:
        return [
            self.tokenizer.id_to_token(int(i))
            for i in ids
            if int(i) < self.eot
        ]
