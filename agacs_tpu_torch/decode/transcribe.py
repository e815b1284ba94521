"""Stock-whisper long-form transcription (counterpart of
`agacs_tpu/decode/transcribe.py`): 30-second windows with timestamp-token
seek, language detection, the timestamp decoding rules, the temperature
fallback ladder, prompt conditioning and word timestamps.

The decode loop is a Python loop over `whisper_decode_step` (K3 on the
card) with the logit filters as tensor ops on the device; the host reads
one flag a step, whether every row has ended. Everything else (seek,
segments, prompts) is host logic, as in JAX.

Timestamp rules (whisper `decoding.py` ApplyTimestampRules), in
`apply_timestamp_rules`:
  1. <|notimestamps|> and the other special tokens are never sampled;
  2. the first sampled token is a timestamp, at most max_initial_ts
     (1.0 s) in;
  3. after a lone timestamp the next token is a timestamp or EOT; after a
     timestamp pair it is not a timestamp;
  4. timestamps never decrease (a lone timestamp may be repeated, to close
     a pair);
  5. when the total timestamp probability beats the best text token, a
     timestamp is sampled.
`timestamp_rule_violations` checks 1-4 on a token sequence alone;
`replay_timestamp_rules` replays a window's decode and checks all five.

Parity with JAX holds at temperature 0 only: a sampled rung draws from a
`torch.Generator` seeded from `seed`, where JAX draws with `jax.random`.
Two of JAX's choices are kept, because they change what the model sees
and the port follows JAX token for token: the <|startofprev|> context is
cut down to the largest of PROMPT_BUCKETS that fits (stock takes the last
n_ctx // 2 - 1 tokens), and it accumulates each window's text tokens only
(stock also keeps the timestamp tokens).
`beam_size > 1` decodes each window with `decode/beam.py` and
<|notimestamps|> (stock's without_timestamps beam mode): window-level
segment times, no temperature ladder, seek advances a full window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agacs_tpu_torch.models.whisper import (
    Whisper,
    init_self_kv_cache,
    precompute_cross_kv,
    whisper_decode_step,
    whisper_encode,
)
from agacs_tpu_torch.ops.logmel import log_mel_spectrogram
from agacs_tpu_torch.text.tokenizer import LANGUAGES, SpecialTokens

SAMPLE_RATE = 16000
CHUNK_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = 3000
TIME_PRECISION = 0.02  # seconds per timestamp token
MAX_INITIAL_TS = 50  # rule 2's cap, in timestamp steps (1.0 s)


@dataclasses.dataclass
class Segment:
    start: float
    end: float
    text: str
    tokens: list[int]
    words: list = dataclasses.field(default_factory=list)


def _sot_logits(model: Whisper, enc: torch.Tensor) -> torch.Tensor:
    """Decoder logits (B, V) float32 after the lone <|startoftranscript|>."""
    sp = SpecialTokens()
    b = enc.shape[0]
    cross_kv = precompute_cross_kv(model, enc)
    self_kv = init_self_kv_cache(model.cfg, b, 4, device=enc.device)
    sot = torch.full((b,), sp.sot, dtype=torch.long, device=enc.device)
    logits, _ = whisper_decode_step(model, sot, 0, self_kv, cross_kv)
    return logits.float()


@torch.inference_mode()
def detect_language(model: Whisper, enc: torch.Tensor) -> tuple[list[str], np.ndarray]:
    """(language codes, (B, n_lang) probabilities) from the sot step's
    logits (whisper `decoding.py` detect_language)."""
    sp = SpecialTokens()
    logits = _sot_logits(model, enc)
    lang = logits[:, sp.lang_base : sp.lang_base + len(LANGUAGES)]
    probs = torch.softmax(lang, -1).cpu().numpy()
    return [LANGUAGES[i] for i in probs.argmax(-1)], probs


@torch.inference_mode()
def no_speech_probs(model: Whisper, enc: torch.Tensor) -> np.ndarray:
    """P(<|nospeech|>) at the sot step (transcribe.py no_speech_threshold)."""
    sp = SpecialTokens()
    return torch.softmax(_sot_logits(model, enc), -1)[:, sp.no_speech].cpu().numpy()


def apply_timestamp_rules(
    logits: torch.Tensor,
    last: torch.Tensor,
    prev: torch.Tensor,
    n_sampled: int,
    max_ts: torch.Tensor,
    has_ts: torch.Tensor,
    max_initial_ts: int = MAX_INITIAL_TS,
) -> torch.Tensor:
    """The five rules on one step's (B, V) logits -> float32 logits with
    every forbidden token at -inf. last / prev (B,): the two latest tokens;
    n_sampled: tokens sampled so far (after the primer); max_ts (B,): the
    largest timestamp sampled; has_ts (B,): whether any was."""
    sp = SpecialTokens()
    v, dev = logits.shape[-1], logits.device
    ts0 = sp.timestamp_begin
    ids = torch.arange(v, device=dev)
    is_ts = ids >= ts0
    neg = float("-inf")
    # rule 1: specials in [eot, timestamp_begin) except eot itself
    lg = logits.float().masked_fill(((ids >= sp.eot) & (ids < ts0) & (ids != sp.eot))[None],
                                    neg)
    last_was_ts = (last >= ts0) & (n_sampled >= 1)
    penult_was_ts = (prev >= ts0) | (n_sampled < 2)
    # rule 3: lone timestamp -> timestamp or eot; a pair -> no timestamp
    lg = lg.masked_fill((last_was_ts & penult_was_ts)[:, None] & is_ts[None], neg)
    lg = lg.masked_fill((last_was_ts & ~penult_was_ts)[:, None] & (ids < sp.eot)[None], neg)
    # rule 4: monotonic timestamps (a lone one may repeat), once one was sampled
    floor = torch.where(last_was_ts & ~penult_was_ts, max_ts, max_ts + 1)
    floor = torch.where(has_ts, floor, ts0)
    lg = lg.masked_fill(is_ts[None] & (ids[None] < floor[:, None]), neg)
    # rule 2: the first sample is a timestamp within max_initial_ts
    if n_sampled == 0:
        lg = lg.masked_fill(((~is_ts) | (ids > ts0 + max_initial_ts))[None], neg)
    # rule 5: if sum p(timestamp) > max p(text), a timestamp
    lp = torch.log_softmax(lg, -1)
    ts_lp = torch.logsumexp(lp.masked_fill(~is_ts[None], neg), -1)
    text_lp = lp.masked_fill(is_ts[None], neg).amax(-1)
    return lg.masked_fill((ts_lp > text_lp)[:, None] & ~is_ts[None], neg)


@torch.inference_mode()
def greedy_decode_timestamps(
    model: Whisper,
    enc: torch.Tensor,
    primer: torch.Tensor,
    max_steps: int = 224,
    max_initial_ts: int = MAX_INITIAL_TS,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy (temperature 0) or sampled decode under the timestamp rules.
    primer: (B, n_primer) int64, ending [sot, lang, task]. Returns (tokens
    (B, n_primer + max_steps), lengths (B,) = the first sampled eot's index
    (the full width when there is none), sum_logprob (B,) over the sampled
    tokens). Sampling draws from `generator` (on enc's device)."""
    sp = SpecialTokens()
    b, dev = enc.shape[0], enc.device
    n_primer = primer.shape[1]
    total = n_primer + max_steps
    max_ctx = min(model.cfg.n_text_ctx, total)
    ts0 = sp.timestamp_begin

    cross_kv = precompute_cross_kv(model, enc)
    self_kv = init_self_kv_cache(model.cfg, b, max_ctx, device=dev)
    tokens = torch.full((b, total), sp.eot, dtype=torch.long, device=dev)
    tokens[:, :n_primer] = primer.to(dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    max_ts = torch.full((b,), ts0, dtype=torch.long, device=dev)
    has_ts = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)

    for pos in range(min(total - 1, max_ctx - 1)):
        cur = tokens[:, pos]
        logits, _ = whisper_decode_step(model, cur, pos, self_kv, cross_kv)
        if pos + 1 < n_primer:
            continue  # the next token is forced; the step filled the cache
        lg = apply_timestamp_rules(logits, cur, tokens[:, max(pos - 1, 0)],
                                   pos + 1 - n_primer, max_ts, has_ts, max_initial_ts)
        lp = torch.log_softmax(lg, -1)
        if temperature > 0.0:
            nxt = torch.multinomial(torch.softmax(lg / temperature, -1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = lp.argmax(-1)
        nxt = torch.where(done, sp.eot, nxt)
        sum_lp += torch.where(done, 0.0, lp.gather(1, nxt[:, None])[:, 0])
        tokens[:, pos + 1] = nxt
        max_ts = torch.where(nxt >= ts0, torch.maximum(max_ts, nxt), max_ts)
        has_ts = has_ts | ((nxt >= ts0) & ~done)
        done = done | (nxt == sp.eot)
        if bool(done.all()):
            break
    is_eot = (tokens == sp.eot) & (torch.arange(total, device=dev)[None] >= n_primer)
    lengths = torch.where(is_eot.any(1), is_eot.int().argmax(1),
                          torch.full((b,), total, device=dev))
    return tokens, lengths, sum_lp


def timestamp_rule_violations(sampled: list[int]) -> list[str]:
    """Rules 1-4 on one window's sampled tokens (an ending eot included
    or not): each broken rule as a message. Rule 5 depends on the logits:
    `replay_timestamp_rules` checks it."""
    sp = SpecialTokens()
    ts0 = sp.timestamp_begin
    seq = list(sampled)
    bad = []
    for j, t in enumerate(seq):
        if sp.eot < t < ts0:
            bad.append(f"rule 1: special token {t} at {j}")
    if seq and not ts0 <= seq[0] <= ts0 + MAX_INITIAL_TS:
        bad.append(f"rule 2: first token {seq[0]} is not a timestamp within "
                   f"{MAX_INITIAL_TS} steps")
    top = None
    for j, t in enumerate(seq):
        if t == sp.eot:
            break
        last = seq[j - 1] if j >= 1 else None
        penult = seq[j - 2] if j >= 2 else None
        last_ts = last is not None and last >= ts0
        penult_ts = j < 2 or penult >= ts0
        if last_ts and penult_ts and t >= ts0:
            bad.append(f"rule 3: timestamp {t} at {j} after a timestamp pair")
        if last_ts and not penult_ts and t < sp.eot:
            bad.append(f"rule 3: text {t} at {j} after a lone timestamp")
        if t >= ts0 and top is not None:
            lone = last_ts and not penult_ts
            if t < top or (t == top and not lone):
                bad.append(f"rule 4: timestamp {t} at {j} after {top}")
        if t >= ts0:
            top = t if top is None else max(top, t)
    return bad


@torch.inference_mode()
def replay_timestamp_rules(model: Whisper, enc: torch.Tensor, primer: list[int],
                           sampled: list[int], temperature: float = 0.0,
                           max_steps: int = 224) -> list[str]:
    """Feed primer + sampled through the cached decode step again (one
    utterance, enc (1, T, d); the caches sized as `greedy_decode_timestamps`
    sizes them for `max_steps`, so the steps repeat its arithmetic) and
    check each sampled token under the five rules: allowed by
    `apply_timestamp_rules`, and at temperature 0 its argmax. Returns the
    violations as messages."""
    sp = SpecialTokens()
    dev = enc.device
    seq = list(primer) + list(sampled)
    n_primer = len(primer)
    cross_kv = precompute_cross_kv(model, enc)
    max_ctx = min(model.cfg.n_text_ctx, n_primer + max_steps)
    self_kv = init_self_kv_cache(model.cfg, 1, max_ctx, device=dev)
    tokens = torch.tensor([seq], dtype=torch.long, device=dev)
    max_ts = torch.full((1,), sp.timestamp_begin, dtype=torch.long, device=dev)
    has_ts = torch.zeros(1, dtype=torch.bool, device=dev)
    bad = []
    for pos in range(min(len(seq), max_ctx) - 1):
        logits, _ = whisper_decode_step(model, tokens[:, pos], pos, self_kv, cross_kv)
        if pos + 1 < n_primer:
            continue
        lg = apply_timestamp_rules(logits, tokens[:, pos], tokens[:, max(pos - 1, 0)],
                                   pos + 1 - n_primer, max_ts, has_ts)
        nxt = seq[pos + 1]
        if not bool(torch.isfinite(lg[0, nxt])):
            bad.append(f"token {nxt} at {pos + 1 - n_primer} is forbidden by the rules")
        elif temperature == 0.0 and int(torch.log_softmax(lg, -1).argmax()) != nxt:
            bad.append(f"token {nxt} at {pos + 1 - n_primer} is not the argmax")
        if nxt >= sp.timestamp_begin:
            max_ts = torch.maximum(max_ts, tokens[:, pos + 1])
            has_ts[:] = True
        if nxt == sp.eot:
            break
    return bad


# the <|startofprev|> window is cut DOWN to the largest bucket that fits
# (JAX keeps few compiled decode loops this way; the port keeps the rule
# because it changes what the model sees)
PROMPT_BUCKETS = (0, 8, 16, 32, 64, 128, 223)


def _bucket_prompt(prompt_toks: list) -> list:
    n = len(prompt_toks)
    b = max(bk for bk in PROMPT_BUCKETS if bk <= n)
    return prompt_toks[len(prompt_toks) - b:] if b else []


def compression_ratio(text: str) -> float:
    """gzip compression ratio, the repetition-loop detector (whisper
    utils.py compression_ratio)."""
    import zlib

    data = text.encode("utf-8")
    return len(data) / max(len(zlib.compress(data)), 1)


@torch.inference_mode()
def transcribe(
    model: Whisper,
    audio: np.ndarray,
    tokenizer=None,
    language: str | None = None,
    task: str = "transcribe",
    temperature: tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: float | None = 2.4,
    no_speech_threshold: float = 0.6,
    logprob_threshold: float | None = -1.0,
    max_steps: int = 224,
    word_timestamps: bool = False,
    condition_on_previous_text: bool = True,
    initial_prompt: str | None = None,
    beam_size: int = 1,
    seed: int = 0,
) -> dict:
    """Long-form transcription of 16 kHz audio of any length (whisper
    `transcribe.py`) on the model's device: 30 s windows, timestamp-token
    seek, first-window language detection, no-speech skipping, and the
    temperature fallback ladder (a hotter rung when the gzip compression
    ratio flags a repetition loop or the average log-prob is too low).
    With word_timestamps, each segment carries cross-attention DTW word
    timings (`decode/timing.py`).

    Prompt conditioning (transcribe.py:45-46, decoding.py:591-599):
    initial_prompt is tokenized as " " + strip() into the <|startofprev|>
    window of the first decode; with condition_on_previous_text each
    window's primer is [<|startofprev|>] + the latest decoded text tokens
    (bucketed, see PROMPT_BUCKETS) + [sot, lang, task], reset after a
    window decoded above temperature 0.5.

    Returns {"text", "segments": [Segment], "language", "windows"}; each
    of "windows" is {"seek": s, "primer": ids, "sampled": the decoded ids
    (an ending eot included), "temperature": the rung taken, "beam": bool}
    (the port's addition, for checks such as `timestamp_rule_violations`).
    Sampled rungs draw from a torch.Generator seeded with `seed`: only
    temperature 0 reproduces JAX."""
    from agacs_tpu_torch.text import WhisperTokenizer

    sp = SpecialTokens()
    tokenizer = tokenizer or WhisperTokenizer()
    audio = np.asarray(audio, np.float32).reshape(-1)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)

    segments: list[Segment] = []
    texts: list[str] = []
    windows: list[dict] = []
    seek = 0  # samples
    detected = language
    total_dur = len(audio) / SAMPLE_RATE

    # stock prompt-context state (transcribe.py:194-201)
    all_tokens: list[int] = []
    prompt_reset_since = 0
    if initial_prompt is not None:
        all_tokens.extend(tokenizer.encode(" " + initial_prompt.strip()))

    def add_segment(start: float, end: float, txt: str, toks_: list):
        # window timestamps live on the padded 30 s grid; clamp to the audio
        end = min(end, total_dur)
        start = min(start, end)
        segments.append(Segment(start, end, txt, toks_))
        texts.append(txt)

    while seek < len(audio):
        window = audio[seek : seek + CHUNK_SAMPLES]
        window = np.pad(window, (0, CHUNK_SAMPLES - len(window)))
        mel, _ = log_mel_spectrogram(torch.from_numpy(window[None]).to(dev),
                                     torch.tensor([CHUNK_SAMPLES], device=dev))
        enc = whisper_encode(model, mel)

        if detected is None:
            detected = detect_language(model, enc)[0][0]
        lang_token = sp.lang_id(detected)
        task_token = sp.transcribe if task == "transcribe" else sp.translate

        nsp = float(no_speech_probs(model, enc)[0])
        # <|startofprev|> context window (decoding.py:591-599): the
        # bucketed tail of the accumulated text tokens
        prompt_toks = _bucket_prompt(all_tokens[prompt_reset_since:])
        sot_seq = [sp.sot, lang_token, task_token]
        primer_list = [sp.sot_prev] + prompt_toks + sot_seq if prompt_toks else sot_seq
        n_primer = len(primer_list)
        primer = torch.tensor([primer_list], dtype=torch.long, device=dev)

        if beam_size > 1:
            from agacs_tpu_torch.decode.beam import beam_decode

            tokens, lengths, scores = beam_decode(
                model, enc, beam_size=beam_size,
                primer=tuple(primer_list) + (sp.no_timestamps,), max_steps=max_steps)
            row = tokens[0].cpu().tolist()
            toks = row[n_primer + 1 : int(lengths[0])]
            avg_lp = float(scores[0]) / max(len(toks) + 1, 1)
            chosen_temp = 0.0
            windows.append({"seek": seek / SAMPLE_RATE, "primer": primer_list + [sp.no_timestamps],
                            "sampled": toks, "temperature": 0.0, "beam": True})
        else:
            # decode_with_fallback: escalate the temperature until the
            # result passes the compression-ratio and avg-logprob gates
            toks, avg_lp = [], 0.0
            chosen_temp = 0.0
            for ti, temp in enumerate(temperature):
                tokens, lengths, sum_lp = greedy_decode_timestamps(
                    model, enc, primer, max_steps=max_steps, temperature=float(temp),
                    generator=gen)
                row = tokens[0].cpu().tolist()
                n = int(lengths[0])
                toks = row[n_primer:n]
                chosen_temp = float(temp)
                avg_lp = float(sum_lp[0]) / max(len(toks) + 1, 1)
                text_ids_all = [t for t in toks if t < sp.eot]
                needs_fallback = False
                if compression_ratio_threshold is not None and text_ids_all:
                    if (compression_ratio(tokenizer.decode(text_ids_all))
                            > compression_ratio_threshold):
                        needs_fallback = True
                if logprob_threshold is not None and avg_lp < logprob_threshold:
                    needs_fallback = True
                if not needs_fallback or ti == len(temperature) - 1:
                    break
            windows.append({"seek": seek / SAMPLE_RATE, "primer": primer_list,
                            "sampled": row[n_primer : n + 1], "temperature": chosen_temp,
                            "beam": False})

        seek_time = seek / SAMPLE_RATE
        if nsp > no_speech_threshold and (logprob_threshold is None
                                          or avg_lp < logprob_threshold):
            seek += CHUNK_SAMPLES  # silence: skip the window
            continue
        n_before = len(segments)

        # split into timestamped segments
        ts_idx = [i for i, t in enumerate(toks) if t >= sp.timestamp_begin]
        consecutive = [i for j, i in enumerate(ts_idx[1:], 1) if ts_idx[j - 1] == i - 1]
        if consecutive:
            # complete segments end at timestamp pairs
            last_slice = 0
            for end_i in consecutive:
                seg = toks[last_slice:end_i]
                ts = [t for t in seg if t >= sp.timestamp_begin]
                text_ids = [t for t in seg if t < sp.eot]
                if ts:
                    start = (ts[0] - sp.timestamp_begin) * TIME_PRECISION
                    end = (ts[-1] - sp.timestamp_begin) * TIME_PRECISION
                    add_segment(seek_time + start, seek_time + end,
                                tokenizer.decode(text_ids), seg)
                last_slice = end_i
            last_ts = toks[consecutive[-1]]
            advance = int((last_ts - sp.timestamp_begin) * TIME_PRECISION * SAMPLE_RATE)
            seek += max(advance, SAMPLE_RATE // 2)  # always make progress
        else:
            # no closing pair: take everything, advance a full window
            text_ids = [t for t in toks if t < sp.eot]
            ts = [t for t in toks if t >= sp.timestamp_begin]
            start = (ts[0] - sp.timestamp_begin) * TIME_PRECISION if ts else 0.0
            end = ((ts[-1] - sp.timestamp_begin) * TIME_PRECISION if len(ts) > 1
                   else min(30.0, len(audio) / SAMPLE_RATE - seek_time))
            if text_ids:
                add_segment(seek_time + start, seek_time + end,
                            tokenizer.decode(text_ids), toks)
            seek += CHUNK_SAMPLES

        # prompt-context accumulation (transcribe.py:356-362): the window's
        # decoded TEXT tokens extend the context; reset after a hot window
        for seg in segments[n_before:]:
            all_tokens.extend(t for t in seg.tokens if t < sp.eot)
        if not condition_on_previous_text or chosen_temp > 0.5:
            prompt_reset_since = len(all_tokens)

        if word_timestamps and len(segments) > n_before:
            from agacs_tpu_torch.decode.timing import find_word_alignment

            window_text = [t for t in toks if t < sp.eot]
            valid_frames = min(CHUNK_SAMPLES,
                               len(audio) - int(seek_time * SAMPLE_RATE)) // 160 // 2
            words = find_word_alignment(model, tokenizer, window_text, enc,
                                        num_frames=max(valid_frames, 1),
                                        primer=(sp.sot, lang_token, task_token))
            new_segs = segments[n_before:]
            for w in words:
                mid = seek_time + (w.start + w.end) / 2
                host = min(new_segs, key=lambda s: 0.0 if s.start <= mid <= s.end
                           else min(abs(mid - s.start), abs(mid - s.end)))
                host.words.append(dataclasses.replace(
                    w, start=seek_time + w.start, end=seek_time + w.end))

    return {"text": "".join(texts), "segments": segments, "language": detected,
            "windows": windows}
