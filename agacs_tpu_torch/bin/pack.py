"""Pack / unpack a trained model for distribution (counterpart of
`agacs_tpu/bin/pack.py`) — the recipe's stage 14
(`egs2/TEMPLATE/asr1/asr.sh` "Pack model" via `espnet2/bin/pack.py`).

  python -m agacs_tpu_torch.bin.pack pack \
      --train_config exp/config.yaml \
      --model_file exp/valid.acc.ave.params.npz \
      [--option exp/train_history.json --option exp/images ...] \
      --outpath exp/packed.tgz

  python -m agacs_tpu_torch.bin.pack unpack --archive exp/packed.tgz --outdir dir/

The archive is a tar.gz with a `meta.yaml` manifest (like espnet2.bin.pack):
relative member paths for the train config and model file plus any extra
options (LM config/params, MVN stats, scoring tables, curves). `unpack`
restores the tree and prints the config/model paths — everything
`Speech2Text`/`bin/decode` needs to run the model
(`asr_inference.py:111-115` builds from exactly these two artifacts).

The members and the manifest are JAX's. The gzip stream is stored
(level 0): gzip saves little on float32 weights, and at JAX's level 9 it
took over 7 minutes for whisper-small's ~1 GB checkpoint on the card's
host. Both packages' `unpack` read it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import time

import yaml

META = "meta.yaml"


def _add(tar: tarfile.TarFile, path: str, arcroot: str) -> str:
    arcname = os.path.join(arcroot, os.path.basename(path.rstrip("/")))
    tar.add(path, arcname=arcname)
    return arcname


def pack(args) -> str:
    for p in [args.train_config, args.model_file, *args.option]:
        if not os.path.exists(p):
            raise SystemExit(f"pack: missing input {p}")
    meta = {
        # the checkpoint layout: the config and npz are JAX's, which both
        # packages' decode CLIs read
        "framework": "agacs_tpu",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "files": {},
        "options": [],
        "python": sys.version.split()[0],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.outpath)), exist_ok=True)
    with tarfile.open(args.outpath, "w:gz", compresslevel=0) as tar:
        meta["files"]["asr_train_config"] = _add(tar, args.train_config, "exp")
        meta["files"]["asr_model_file"] = _add(tar, args.model_file, "exp")
        for opt in args.option:
            meta["options"].append(_add(tar, opt, "exp"))
        meta_path = args.outpath + ".meta.yaml"
        with open(meta_path, "w") as f:
            yaml.safe_dump(meta, f)
        tar.add(meta_path, arcname=META)
        os.remove(meta_path)
    print(f"packed -> {args.outpath}")
    return args.outpath


def unpack(args) -> dict:
    os.makedirs(args.outdir, exist_ok=True)
    with tarfile.open(args.archive, "r:gz") as tar:
        names = tar.getnames()
        bad = [n for n in names if n.startswith("/") or ".." in n.split(os.sep)]
        if bad:
            raise SystemExit(f"unpack: unsafe member paths {bad}")
        tar.extractall(args.outdir, filter="data")
    with open(os.path.join(args.outdir, META)) as f:
        meta = yaml.safe_load(f)
    out = {
        k: os.path.join(args.outdir, v) for k, v in meta["files"].items()
    }
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("pack")
    pp.add_argument("--train_config", required=True)
    pp.add_argument("--model_file", required=True)
    pp.add_argument("--option", action="append", default=[])
    pp.add_argument("--outpath", required=True)
    up = sub.add_parser("unpack")
    up.add_argument("--archive", required=True)
    up.add_argument("--outdir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "pack":
        return pack(args)
    return unpack(args)


if __name__ == "__main__":
    main()
