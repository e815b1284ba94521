"""Average checkpoint files (counterpart of
`agacs_tpu/bin/average_checkpoints.py`) — the standalone
`average_nbest_models` / espnet1 `utils/average_checkpoints.py` utility
(state-dict mean over explicit snapshots, independent of a training run).

  python -m agacs_tpu_torch.bin.average_checkpoints \
      --inputs exp/a/3epoch.params.npz exp/a/5epoch.params.npz \
      --output exp/a/custom.ave.params.npz
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--inputs", nargs="+", required=True,
                   help=".params.npz snapshots to average")
    p.add_argument("--output", required=True)
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    acc: dict[str, np.ndarray] = {}
    dtypes: dict[str, np.dtype] = {}
    keys = None
    for path in args.inputs:
        data = np.load(path)
        if keys is None:
            keys = set(data.files)
        elif set(data.files) != keys:
            raise ValueError(
                f"{path}: key set differs from {args.inputs[0]} "
                f"(missing {sorted(keys - set(data.files))[:3]}...)"
            )
        for k in data.files:
            arr = data[k].astype(np.float64)
            acc[k] = acc.get(k, 0.0) + arr
            dtypes.setdefault(k, data[k].dtype)
    # integer leaves (int8 quantized trunk, counters) keep their dtype:
    # frozen across snapshots, the rounded mean is the value itself
    out = {
        k: (np.round(v / len(args.inputs)).astype(dtypes[k])
            if np.issubdtype(dtypes[k], np.integer)
            else (v / len(args.inputs)).astype(np.float32))
        for k, v in acc.items()
    }
    np.savez(args.output, **out)
    logging.info("averaged %d checkpoints (%d leaves) -> %s",
                 len(args.inputs), len(out), args.output)
    return {"n_inputs": len(args.inputs), "output": args.output}


if __name__ == "__main__":
    main()
