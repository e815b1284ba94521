"""Format stage (counterpart of `agacs_tpu/bin/format_data.py`) — asr.sh
stage 3 equivalent: re-encode a data dir's wav.scp into a dump dir as
extended kaldi ark (flac.ark / wav.ark) or per-utterance files, writing
wav.scp + utt2num_samples
(`egs2/TEMPLATE/asr1/pyscripts/audio/format_wav_scp.py`).

  python -m agacs_tpu_torch.bin.format_data --data_dir data/train \
      --outdir dump/raw/train [--audio_format flac.ark] [--fs 16000]
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil

from agacs_tpu_torch.data.flac import float_to_pcm16, write_flac
from agacs_tpu_torch.data.io import read_scp, read_wav, write_scp, write_wav
from agacs_tpu_torch.data.kaldi_ark import ArkWriter


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--audio_format", default="flac.ark",
                   choices=["flac.ark", "wav.ark", "wav", "flac"])
    p.add_argument("--fs", type=int, default=16000)
    return p


def _iter_utts(data_dir: str):
    """Yield (utt_id, float32 audio, sr). With a kaldi `segments` file the
    recordings are sliced per utterance (the reference passes segments to
    kaldiio.load_scp_sequential, format_wav_scp.py:120); the formatted
    output is always utterance-level."""
    wav = read_scp(os.path.join(data_dir, "wav.scp"))
    seg_path = os.path.join(data_dir, "segments")
    if not os.path.exists(seg_path):
        for utt, path in wav.items():
            audio, sr = read_wav(path)
            yield utt, audio, sr
        return
    by_rec: dict[str, list] = {}
    for utt, v in read_scp(seg_path).items():
        rec, s, e = v.split()
        by_rec.setdefault(rec, []).append((utt, float(s), float(e)))
    for rec, utts in by_rec.items():
        audio, sr = read_wav(wav[rec])
        for utt, s, e in sorted(utts, key=lambda x: x[1]):
            yield utt, audio[int(round(s * sr)) : int(round(e * sr))], sr


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    os.makedirs(args.outdir, exist_ok=True)

    scp_out: dict[str, str] = {}
    if args.audio_format.endswith("ark"):
        fmt = "flac" if "flac" in args.audio_format else "wav"
        with ArkWriter(args.outdir, name="wav", fmt=fmt) as w:
            for utt, audio, sr in _iter_utts(args.data_dir):
                if sr != args.fs:
                    raise ValueError(
                        f"{utt}: rate {sr} != --fs {args.fs} (resample first)"
                    )
                scp_out[utt] = w.write(utt, float_to_pcm16(audio), sr)
        # ArkWriter already wrote wav.scp + utt2num_samples
    else:
        adir = os.path.join(args.outdir, "data_wav")
        nums = {}
        for utt, audio, sr in _iter_utts(args.data_dir):
            out = os.path.join(adir, f"{utt}.{args.audio_format}")
            if args.audio_format == "flac":
                write_flac(out, audio, sr)
            else:
                write_wav(out, audio, sr)
            scp_out[utt] = out
            nums[utt] = str(len(audio))
        write_scp(os.path.join(args.outdir, "wav.scp"), scp_out)
        write_scp(os.path.join(args.outdir, "utt2num_samples"), nums)
    n_utts = len(scp_out)

    # carry the companion files through unchanged (asr.sh format stage);
    # the output is utterance-level, so segments stay behind
    for name in ("text", "utt2spk", "spk2utt"):
        src = os.path.join(args.data_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.outdir, name))
    logging.info("formatted %d utts -> %s (%s)", n_utts, args.outdir,
                 args.audio_format)
    return {"n_utts": n_utts, "outdir": args.outdir}


if __name__ == "__main__":
    main()
