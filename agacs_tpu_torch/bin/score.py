"""Scoring CLI (counterpart of `agacs_tpu/bin/score.py`, the recipes'
scoring stage): .trn pair -> MER / English WER / Mandarin CER tables,
`result.json` and `result.txt`.

  python -m agacs_tpu_torch.bin.score --ref decode/ref.trn --hyp decode/hyp.trn \
      --output_dir decode/score [--per_bucket]
"""

from __future__ import annotations

import argparse
import json
import os

from agacs_tpu_torch.eval.scoring import read_trn, score_by_bucket, score_report


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ref", required=True)
    p.add_argument("--hyp", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--per_bucket", action="store_true",
                   help="also score the cs / en / man reference-sentence buckets")
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    refs, hyps = read_trn(args.ref), read_trn(args.hyp)
    report = score_report(refs, hyps)
    if args.per_bucket:
        report.update({f"bucket_{k}": v for k, v in score_by_bucket(refs, hyps).items()})
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "result.json"), "w") as f:
        json.dump(report, f, indent=1)
    lines = ["| metric | utts | ref | corr% | sub | del | ins | err% |",
             "|---|---|---|---|---|---|---|---|"]
    for name, st in report.items():
        lines.append(f"| {name} | {st['utts']} | {st['ref_tokens']} | {st['corr']} "
                     f"| {st['sub']} | {st['del']} | {st['ins']} | {st['err']} |")
    table = "\n".join(lines)
    with open(os.path.join(args.output_dir, "result.txt"), "w") as f:
        f.write(table + "\n")
    print(table)
    return report


if __name__ == "__main__":
    main()
