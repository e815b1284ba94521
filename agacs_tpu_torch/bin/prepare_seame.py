"""SEAME corpus preparation CLI (counterpart of `agacs_tpu/bin/prepare_seame.py`)
— the `local/data.sh` stage-2 equivalent
(`egs2/seame/asr1/local/preprocess.py` main flow): raw SEAME checkout +
the official SEAME-dev-set repo -> data/{train,valid,devman,devsge} with
wav.scp (recording FLACs) + segments + text (+ per-split utt2spk,
spk2gender, and the train-side Mandarin char inventory / English BPE
text side outputs).

  python -m agacs_tpu_torch.bin.prepare_seame --data /corpora/SEAME \
      --repo /corpora/SEAME-dev-set --out data
"""

from __future__ import annotations

import argparse
import json
import logging

from agacs_tpu_torch.data.seame import prepare_seame_corpus


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="raw SEAME corpus root")
    p.add_argument("--repo", required=True, help="SEAME-dev-set checkout")
    p.add_argument("--out", required=True, help="output data dir root")
    p.add_argument("--num_val", type=int, default=None,
                   help="validation utterances (default: 5%% of train)")
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    stats = prepare_seame_corpus(
        args.data, args.repo, args.out, num_val=args.num_val
    )
    logging.info("prepared: %s", json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
