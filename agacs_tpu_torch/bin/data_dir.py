"""Data-dir hygiene CLI (counterpart of `agacs_tpu/bin/data_dir.py`) — the
Kaldi utils/ scripts as subcommands.

  python -m agacs_tpu_torch.bin.data_dir validate <dir> [--no-text]
  python -m agacs_tpu_torch.bin.data_dir fix <dir>
  python -m agacs_tpu_torch.bin.data_dir split <dir> <n> [--out ROOT]
  python -m agacs_tpu_torch.bin.data_dir subset <dir> <out> <n> [--mode first|last|random] [--seed N]
  python -m agacs_tpu_torch.bin.data_dir utt2spk-to-spk2utt <utt2spk> [-o out]
  python -m agacs_tpu_torch.bin.data_dir spk2utt-to-utt2spk <spk2utt> [-o out]
  python -m agacs_tpu_torch.bin.data_dir filter <keylist> <scp> [-o out]

Reference equivalents: validate_data_dir.sh / fix_data_dir.sh /
split_data.sh / subset_data_dir.sh / utt2spk_to_spk2utt.pl /
filter_scp.pl (Kaldi, cloned by the reference's `tools/Makefile:34-35`
and used throughout `egs2/TEMPLATE/asr1/asr.sh`).
"""

from __future__ import annotations

import argparse
import sys

from agacs_tpu_torch.data import datadir
from agacs_tpu_torch.data.io import read_scp, write_scp


def _emit(entries: dict[str, str], out: str | None) -> None:
    if out:
        write_scp(out, entries)
    else:
        for k, v in entries.items():
            sys.stdout.write(f"{k} {v}\n")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate")
    v.add_argument("dir")
    v.add_argument("--no-text", action="store_true")

    f = sub.add_parser("fix")
    f.add_argument("dir")

    s = sub.add_parser("split")
    s.add_argument("dir")
    s.add_argument("n", type=int)
    s.add_argument("--out", default=None)

    ss = sub.add_parser("subset")
    ss.add_argument("dir")
    ss.add_argument("out")
    ss.add_argument("n", type=int)
    ss.add_argument("--mode", default="first", choices=("first", "last", "random"))
    ss.add_argument("--seed", type=int, default=0)

    u = sub.add_parser("utt2spk-to-spk2utt")
    u.add_argument("file")
    u.add_argument("-o", "--out", default=None)

    su = sub.add_parser("spk2utt-to-utt2spk")
    su.add_argument("file")
    su.add_argument("-o", "--out", default=None)

    fl = sub.add_parser("filter")
    fl.add_argument("keylist", help="file with one key per line (first column)")
    fl.add_argument("scp")
    fl.add_argument("-o", "--out", default=None)

    args = p.parse_args(argv)

    if args.cmd == "validate":
        problems = datadir.validate_data_dir(args.dir, require_text=not args.no_text)
        for prob in problems:
            print(f"INVALID: {prob}", file=sys.stderr)
        if not problems:
            print(f"{args.dir}: ok")
        return 1 if problems else 0
    if args.cmd == "fix":
        kept = datadir.fix_data_dir(args.dir)
        print(f"{args.dir}: {kept} utterances kept")
        return 0
    if args.cmd == "split":
        for d in datadir.split_data_dir(args.dir, args.n, args.out):
            print(d)
        return 0
    if args.cmd == "subset":
        kept = datadir.subset_data_dir(
            args.dir, args.out, args.n, mode=args.mode, seed=args.seed
        )
        print(f"{args.out}: {kept} utterances")
        return 0
    if args.cmd == "utt2spk-to-spk2utt":
        _emit(datadir.utt2spk_to_spk2utt(read_scp(args.file)), args.out)
        return 0
    if args.cmd == "spk2utt-to-utt2spk":
        _emit(datadir.spk2utt_to_utt2spk(read_scp(args.file)), args.out)
        return 0
    if args.cmd == "filter":
        keys = [
            line.split()[0]
            for line in open(args.keylist, encoding="utf-8")
            if line.strip()
        ]
        _emit(datadir.filter_keys(read_scp(args.scp), keys), args.out)
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
