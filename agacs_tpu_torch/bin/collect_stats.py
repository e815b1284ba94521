"""Collect-stats CLI (counterpart of `agacs_tpu/bin/collect_stats.py`; the
conformer recipe's stage 1, `recipes/seame/run_conformer.sh`): the shape
files of the batch sampler and the feature mean and standard deviation of
global MVN.

  python -m agacs_tpu_torch.bin.collect_stats --data_dir data/train \\
      --output_dir exp/stats [--frontend default|whisper] [--device cuda]

Writes `speech_shape` and `text_shape` (`utt samples` / `utt tokens` per
line) and `feats_stats.npz` (mean, std float32 over every valid frame of
every utterance, std floored at 1e-10, and the frame count), which
`normalize_conf.stats_file` of train_asr_conformer.yaml names. Features
are the DefaultFrontend's log-mel without normalisation (or Whisper's
log-mel), one utterance at a time, summed in float32 as in JAX.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from agacs_tpu_torch.data.dataset import ASRDataset
from agacs_tpu_torch.ops.frontend_default import DefaultFrontendConfig, default_frontend
from agacs_tpu_torch.ops.logmel import log_mel_spectrogram


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--frontend", default="default", choices=["default", "whisper"])
    p.add_argument("--device", default="cuda")
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    os.makedirs(args.output_dir, exist_ok=True)
    device = torch.device(args.device)
    ds = ASRDataset(args.data_dir, with_cs_labels=False)
    with open(os.path.join(args.output_dir, "speech_shape"), "w") as f_s, \
            open(os.path.join(args.output_dir, "text_shape"), "w") as f_t:
        for u in ds.utt_ids:
            f_s.write(f"{u} {ds.num_samples(u)}\n")
            f_t.write(f"{u} {len(ds.tokenize(ds.data.text[u]))}\n")

    n_frames, acc, sq = 0, None, None
    for u in ds.utt_ids:
        speech = ds[u]["speech"]
        audio = torch.from_numpy(np.asarray(speech, np.float32))[None].to(device)
        ilens = torch.tensor([len(speech)], device=device)
        if args.frontend == "default":
            feats, olens = default_frontend(audio, ilens, DefaultFrontendConfig(normalize=None))
        else:
            feats, olens = log_mel_spectrogram(audio, ilens)
        n = int(olens[0])
        x = feats[0, :n].cpu().numpy()
        acc = x.sum(0) if acc is None else acc + x.sum(0)
        sq = (x ** 2).sum(0) if sq is None else sq + (x ** 2).sum(0)
        n_frames += n
    mean = acc / n_frames
    std = np.sqrt(np.maximum(sq / n_frames - mean ** 2, 1e-20))
    np.savez(os.path.join(args.output_dir, "feats_stats.npz"), mean=mean.astype(np.float32),
             std=std.astype(np.float32), count=np.asarray(n_frames))
    logging.info("stats over %d utts / %d frames written", len(ds), n_frames)
    return {"n_frames": n_frames, "mean": mean, "std": std}


if __name__ == "__main__":
    main()
