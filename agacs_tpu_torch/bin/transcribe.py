"""Single-file transcription (the port's counterpart of
`tools/transcribe.py`): config + checkpoint + one audio file -> text on
stdout.

  python -m agacs_tpu_torch.bin.transcribe exp/x/config.yaml \\
      exp/x/valid.acc.ave.params.npz utterance.wav [--beam_size 1]
  python -m agacs_tpu_torch.bin.transcribe ... --long_form \\
      [--language zh] [--initial_prompt "..."] [--word_timestamps]

Without `--long_form` it decodes the file with `Speech2Text` and the
ESPnet dual-language primer (greedy, or beam search with --beam_size).
With it, stock whisper's long-form transcription (`decode/transcribe.py`):
30 s windows with timestamp-token seek, language detection, the
temperature ladder, prompt conditioning and, with --word_timestamps,
word timings; one line per segment (and per word). Runs on --device
(default cuda).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("params")
    ap.add_argument("wav")
    ap.add_argument("--beam_size", type=int, default=1)
    ap.add_argument("--max_steps", type=int, default=200)
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--long_form", action="store_true",
                    help="stock-whisper 30 s windowed transcription with timestamps and "
                         "language detection (decode/transcribe.py) instead of the "
                         "ESPnet prompt path")
    ap.add_argument("--language", default=None,
                    help="long-form: language code (default: detect)")
    ap.add_argument("--initial_prompt", default=None,
                    help="long-form: text for the <|startofprev|> window of the first "
                         "decode")
    ap.add_argument("--no_condition_on_previous_text", action="store_true",
                    help="long-form: do not feed decoded text back as the next window's "
                         "prompt context")
    ap.add_argument("--word_timestamps", action="store_true",
                    help="long-form: cross-attention DTW word timings per segment")
    ap.add_argument("--cross_kv_int8", action="store_true",
                    help="int8 precomputed cross-attention K/V")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)

    from agacs_tpu_torch.bin.decode import load_whisper_model
    from agacs_tpu_torch.data.io import read_wav
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.utils.config import load_yaml, task_from_dict

    raw = load_yaml(args.config)
    task = task_from_dict(raw, compute_dtype=getattr(torch, args.compute_dtype))
    if task.kind != "whisper":
        raise ValueError("bin.transcribe takes the whisper family; use bin.decode for "
                         f"the {task.kind} family")
    cfg = task.cfg
    if args.cross_kv_int8:
        cfg = dataclasses.replace(
            cfg, whisper=dataclasses.replace(cfg.whisper, cross_kv_int8=True))
    model = load_whisper_model(args.params, raw, cfg, args.device)
    audio, sr = read_wav(args.wav)
    if sr != 16000:
        raise ValueError(f"{args.wav}: {sr} Hz; transcription takes 16 kHz audio")
    if args.long_form:
        from agacs_tpu_torch.decode.transcribe import transcribe

        out = transcribe(model, audio, language=args.language,
                         initial_prompt=args.initial_prompt,
                         condition_on_previous_text=not args.no_condition_on_previous_text,
                         word_timestamps=args.word_timestamps, beam_size=args.beam_size)
        for seg in out["segments"]:
            print(f"[{seg.start:7.2f} -> {seg.end:7.2f}] {seg.text}")
            for w in seg.words:
                print(f"    [{w.start:7.2f} -> {w.end:7.2f}] {w.word} (p {w.probability:.3f})")
        print(f"# language: {out['language']}")
        sys.stdout.flush()
        return out
    s2t = Speech2Text(model, cfg, beam_size=args.beam_size, max_steps=args.max_steps)
    result = s2t(audio)[0]
    print(result.text)
    print(f"# 1/RTF: {s2t.inverse_rtf:.1f}x realtime (incl. the kernels' first calls)")
    return {"text": result.text, "tokens": result.tokens, "rtf": s2t.rtf}


if __name__ == "__main__":
    main()
