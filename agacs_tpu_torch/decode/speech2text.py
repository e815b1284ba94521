"""Speech2Text — audio -> hypotheses (counterpart of
`agacs_tpu/decode/speech2text.py`), with the same built-in RTF accounting.

Scorer composition as JAX's (asr_inference.py:139-174,258-290): the whisper
decoder plus the optional CTC head (`ctc_weight`), a transformer LM's
shallow fusion (`lm`, `lm_weight`), the n-gram (`ngram_lm`,
`ngram_weight`) and the length bonus. beam_size <= 1 with every fusion
weight 0 runs greedy decoding (the recipes' `decode_asr_whisper.yaml`);
anything else runs `decode/beam.py`, at beam_size 1 too (JAX :144-150).
The CTC frame log-probs are the head's product in the compute dtype, then
a float32 log-softmax (JAX :96-104), over the encoder's output lengths.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from agacs_tpu_torch.text import WhisperTokenizer
from agacs_tpu_torch.decode.beam import beam_decode
from agacs_tpu_torch.decode.greedy import WHISPER_CS_PRIMER, greedy_decode
from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode
from agacs_tpu_torch.models.lm import TransformerLM
from agacs_tpu_torch.models.ngram import NgramLM
from agacs_tpu_torch.models.whisper import Whisper


@dataclasses.dataclass
class DecodeResult:
    text: str
    tokens: list[int]
    score: float


class Speech2Text:
    """audio (16 kHz float) -> hypotheses on the model's device.

    beam_size=1 with no fusion weight uses the greedy path (score 0);
    otherwise the beam search, whose hypotheses carry their score.
    max_steps=None derives maxlen from the encoder frame count (maxlenratio
    == 0 semantics); a positive maxlenratio multiplies it. Both are capped
    by the decoder context. `loop` is the beam loop's form ("scan" or
    "while"). ctc_weight > 0 needs the model's CTC head, lm_weight > 0 an
    `lm` (float32, on the model's device) and ngram_weight > 0 an
    `ngram_lm`; a weight without its scorer raises (for the LM and the
    n-gram JAX would decode without them)."""

    def __init__(
        self,
        model: Whisper,
        cfg: ASRModelConfig,
        tokenizer: WhisperTokenizer | None = None,
        beam_size: int = 1,
        max_steps: int | None = 200,
        maxlenratio: float = 0.0,
        length_bonus: float = 0.0,
        ctc_weight: float = 0.0,
        lm: TransformerLM | None = None,
        lm_weight: float = 0.0,
        ngram_lm: NgramLM | None = None,
        ngram_weight: float = 0.0,
        pre_beam: int = 0,
        use_end_detect: bool = True,
        primer: tuple[int, ...] = WHISPER_CS_PRIMER,
        loop: str = "scan",
    ):
        if ctc_weight > 0.0 and getattr(model, "ctc", None) is None:
            raise ValueError("ctc_weight > 0 but the model has no CTC head "
                             "(train with ctc_weight != 0 to create one)")
        if lm_weight > 0.0 and lm is None:
            raise ValueError("lm_weight > 0 but no lm was given")
        if ngram_weight > 0.0 and ngram_lm is None:
            raise ValueError("ngram_weight > 0 but no ngram_lm was given")
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer or WhisperTokenizer()
        self.beam_size = beam_size
        self.max_steps = max_steps
        self.maxlenratio = maxlenratio
        self.length_bonus = length_bonus
        self.ctc_weight = ctc_weight
        self.lm = lm
        self.lm_weight = lm_weight
        self.ngram_lm = ngram_lm
        self.ngram_weight = ngram_weight
        self.pre_beam = pre_beam
        self.use_end_detect = use_end_detect
        self.primer = tuple(primer)
        self.loop = loop
        self.device = next(model.parameters()).device
        self._audio_seconds = 0.0
        self._decode_seconds = 0.0

    @property
    def rtf(self) -> float:
        """decode-time / audio-time (lower is better)."""
        return self._decode_seconds / max(self._audio_seconds, 1e-9)

    @property
    def inverse_rtf(self) -> float:
        return self._audio_seconds / max(self._decode_seconds, 1e-9)

    def _maxlen(self, t_enc: int) -> int:
        cap = self.cfg.whisper.n_text_ctx - len(self.primer) - 1
        if self.max_steps is not None:
            return min(self.max_steps, cap)
        if self.maxlenratio > 0:
            return min(max(1, int(self.maxlenratio * t_enc)), cap)
        return min(t_enc, cap)

    def ctc_log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        """(B, T, d) encoder output -> (B, T, V) float32 CTC log-probs: the
        head's product and bias in the encoder's dtype, then log_softmax in
        float32."""
        head = self.model.ctc
        logits = torch.nn.functional.linear(enc, head.weight.to(enc.dtype),
                                            head.bias.to(enc.dtype))
        return torch.log_softmax(logits.float(), -1)

    @torch.inference_mode()
    def __call__(
        self,
        audio: np.ndarray,
        fs: int = 16000,
        lengths: np.ndarray | None = None,
    ) -> list[DecodeResult]:
        """audio: (T,) or (B, T) float waveform at 16 kHz; `lengths` gives
        each padded row's true sample count (CTC frame lengths + RTF)."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        b, s = audio.shape
        lengths = np.full((b,), s, np.int64) if lengths is None \
            else np.asarray(lengths, np.int64)

        t0 = time.perf_counter()
        speech = torch.from_numpy(audio).to(self.device)
        enc, enc_lens = encode(self.model, self.cfg, speech,
                               torch.from_numpy(lengths).to(self.device))
        max_steps = self._maxlen(int(enc.shape[1]))
        simple = (self.beam_size <= 1 and self.ctc_weight == 0.0 and self.lm_weight == 0.0
                  and self.ngram_weight == 0.0)
        if simple:
            tokens, lens = greedy_decode(self.model, enc, primer=self.primer,
                                         max_steps=max_steps)
            scores = torch.zeros(b)
        else:
            ctc_logp = self.ctc_log_probs(enc) if self.ctc_weight > 0.0 else None
            tokens, lens, scores = beam_decode(
                self.model, enc, beam_size=self.beam_size, primer=self.primer,
                max_steps=max_steps, length_bonus=self.length_bonus,
                ctc_weight=self.ctc_weight, ctc_logp=ctc_logp,
                ctc_frame_lens=enc_lens if ctc_logp is not None else None,
                lm=self.lm, lm_weight=self.lm_weight, ngram_lm=self.ngram_lm,
                ngram_weight=self.ngram_weight, pre_beam=self.pre_beam,
                use_end_detect=self.use_end_detect, loop=self.loop)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        scores = scores.cpu().numpy()
        self._decode_seconds += time.perf_counter() - t0
        self._audio_seconds += float(lengths.sum()) / fs

        out = []
        for i in range(b):
            ids = tokens[i, : lens[i]].tolist()
            hyp_ids = [t for t in ids if t < self.tokenizer.special.eot]
            out.append(DecodeResult(text=self.tokenizer.decode(hyp_ids),
                                    tokens=ids, score=float(scores[i])))
        return out
