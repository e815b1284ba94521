"""ASR dataset over kaldi-style data dirs (counterpart of
`agacs_tpu/data/dataset.py`): per-utterance waveform, text cleaned and
tokenized through the Whisper converter (dual-language prompt + eot), and
the CS loss's per-token language labels, computed on the host once per
utterance. The utterances, their lengths and their audio come from
`data/io.DataDir` (every wav.scp form JAX reads, `segments`,
`utt2num_samples`, the min/max length filter); the RIR/noise augmentation
is not ported."""

from __future__ import annotations

import numpy as np

from agacs_tpu_torch.text import TextCleaner, WhisperTokenIdConverter, WhisperTokenizer
from agacs_tpu_torch.adapt.cs_loss import attention_target_labels
from agacs_tpu_torch.data.io import DataDir

SOT = 50258


class ASRDataset:
    def __init__(self, data_dir: str, tokenizer: WhisperTokenizer | None = None,
                 cleaner: str | None = "whisper_basic", min_samples: int = 0,
                 max_samples: int = 30 * 16000, with_cs_labels: bool = True):
        self.data = DataDir(data_dir, min_samples, max_samples)
        self.utt_ids = self.data.utt_ids
        self.tokenizer = tokenizer or WhisperTokenizer()
        self.converter = WhisperTokenIdConverter(self.tokenizer)
        self.cleaner = TextCleaner(cleaner) if cleaner else None
        self.with_cs_labels = with_cs_labels
        self._tok_len: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.utt_ids)

    def num_samples(self, utt_id: str) -> int:
        return self.data.num_samples(utt_id)

    def tokenize(self, text: str) -> list[int]:
        if self.cleaner is not None:
            text = self.cleaner(text)
        return self.converter.tokens2ids(self.tokenizer.text2tokens(text))

    def num_tokens(self, utt_id: str) -> int:
        if utt_id not in self._tok_len:
            self._tok_len[utt_id] = len(self.tokenize(self.data.text[utt_id]))
        return self._tok_len[utt_id]

    def __getitem__(self, utt_id: str) -> dict:
        ids = np.asarray(self.tokenize(self.data.text[utt_id]), np.int32)
        item = {"utt_id": utt_id, "speech": self.data.speech(utt_id), "text": ids}
        if self.with_cs_labels:
            ys_in = np.concatenate([[SOT], ids])[None, :]
            item["cs_labels"] = attention_target_labels(ys_in, self.tokenizer)[0]
        return item
