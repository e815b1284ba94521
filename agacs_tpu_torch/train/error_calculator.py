"""Training-time CER/WER (this package's copy of
`agacs_tpu/train/error_calculator.py`) from teacher-forced argmax predictions — the
reference ErrorCalculator (`espnet/nets/e2e_asr_common.py:100-254`), used
each eval epoch by `espnet_model.py:955-959` so "best model by error
rate" criteria work during training (NOT the final sclite score).

Semantics replicated literally:
  * predictions truncated at each reference's valid length
    (convert_to_char, e2e_asr_common.py:203-216);
  * token strings joined, the space symbol mapped to " ", blank removed;
  * CER = Σ editdistance(chars) / Σ ref chars (spaces stripped);
  * WER = Σ editdistance(words) / Σ ref words.

The space symbol defaults to the whisper byte-level marker "Ġ" — the
reference's "<space>" does not exist in the whisper vocab (its
ErrorCalculator then never forms word boundaries; this instantiation
keeps WER meaningful for the whisper token set).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def edit_distance(a, b) -> int:
    """Plain Levenshtein (unit costs) over sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class ErrorCalculator:
    def __init__(
        self,
        id_to_token: Callable[[int], str],
        space: str = "Ġ",
        blank: str = "<blank>",
        ignore_id: int = -1,
    ):
        self.id_to_token = id_to_token
        self.space = space
        self.blank = blank
        self.ignore_id = ignore_id

    def _convert(self, ys_hat: np.ndarray, ys_pad: np.ndarray):
        seqs_hat, seqs_true = [], []
        for y_hat, y_true in zip(np.asarray(ys_hat), np.asarray(ys_pad)):
            pad = np.where(y_true == self.ignore_id)[0]
            ymax = pad[0] if len(pad) > 0 else len(y_true)
            hat = "".join(self.id_to_token(int(i)) for i in y_hat[:ymax])
            true = "".join(
                self.id_to_token(int(i)) for i in y_true if int(i) != self.ignore_id
            )
            hat = hat.replace(self.space, " ").replace(self.blank, "")
            true = true.replace(self.space, " ")
            seqs_hat.append(hat)
            seqs_true.append(true)
        return seqs_hat, seqs_true

    def __call__(
        self, ys_hat: np.ndarray, ys_pad: np.ndarray
    ) -> tuple[float | None, float | None]:
        """(B, T) argmax predictions + (B, T) ignore-padded refs -> (cer, wer)."""
        seqs_hat, seqs_true = self._convert(ys_hat, ys_pad)
        return self._score(seqs_hat, seqs_true)

    def ragged(
        self, hyps_ids: list[list[int]], refs_ids: list[list[int]]
    ) -> tuple[float | None, float | None]:
        """CER/WER over ragged hypothesis/reference id lists — the
        ErrorCalculatorTransducer form (espnet2/asr/transducer/
        error_calculator.py): full decoded hypotheses, no teacher-forced
        truncation."""
        seqs_hat, seqs_true = [], []
        for hyp, ref in zip(hyps_ids, refs_ids):
            hat = "".join(self.id_to_token(int(i)) for i in hyp)
            true = "".join(
                self.id_to_token(int(i)) for i in ref if int(i) != self.ignore_id
            )
            seqs_hat.append(hat.replace(self.space, " ").replace(self.blank, ""))
            seqs_true.append(true.replace(self.space, " "))
        return self._score(seqs_hat, seqs_true)

    def _score(self, seqs_hat, seqs_true):
        char_ed = char_len = word_ed = word_len = 0
        for hat, true in zip(seqs_hat, seqs_true):
            char_ed += edit_distance(hat.replace(" ", ""), true.replace(" ", ""))
            char_len += len(true.replace(" ", ""))
            word_ed += edit_distance(hat.split(), true.split())
            word_len += len(true.split())
        cer = char_ed / char_len if char_len else None
        wer = word_ed / word_len if word_len else None
        return cer, wer
