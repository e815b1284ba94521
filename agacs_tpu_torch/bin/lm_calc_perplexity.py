"""Corpus perplexity under a trained LM (counterpart of
`agacs_tpu/bin/lm_calc_perplexity.py`, espnet2's `lm_calc_perplexity`): a
text file -> the token-level perplexity, each batch's mean NLL weighted by
its token count.

  python -m agacs_tpu_torch.bin.lm_calc_perplexity --lm_exp exp/lm \\
      --text data/valid/text [--batch_tokens 8192] [--output ppl.json] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from agacs_tpu_torch.bin.decode import _load_lm_config
from agacs_tpu_torch.bin.lm_train import text_batches
from agacs_tpu_torch.models.checkpoint import lm_params_from_numpy
from agacs_tpu_torch.models.lm import TransformerLM, lm_loss
from agacs_tpu_torch.text.tokenizer import WhisperTokenIdConverter, WhisperTokenizer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--lm_exp", required=True, help="LM experiment dir (config.yaml + ave params)")
    p.add_argument("--text", required=True)
    p.add_argument("--params", default=None, help="checkpoint (default: valid.loss.ave)")
    p.add_argument("--batch_tokens", type=int, default=8192)
    p.add_argument("--output", default=None, help="optional JSON report")
    p.add_argument("--device", default="cuda")
    return p


@torch.no_grad()
def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = _load_lm_config(args.lm_exp)
    path = args.params or os.path.join(args.lm_exp, "valid.loss.ave.params.npz")
    with np.load(path) as tree:
        sd = lm_params_from_numpy({k: tree[k] for k in tree.files}, cfg)
    lm = TransformerLM.from_state_dict(cfg, sd, device=args.device)
    tok = WhisperTokenizer()
    batches = text_batches(args.text, WhisperTokenIdConverter(tok), tok, args.batch_tokens)
    total_nll = total_tokens = 0.0
    for arr in batches:
        stats = lm_loss(lm, cfg, {"text": torch.from_numpy(arr).to(args.device)},
                        train=False)[1]
        n = int(np.sum(arr != -1))
        total_nll += float(stats["loss"]) * n
        total_tokens += n
    nll = total_nll / max(total_tokens, 1)
    report = {"nll_per_token": nll, "perplexity": float(np.exp(nll)),
              "n_tokens": int(total_tokens), "n_batches": len(batches)}
    logging.info("perplexity: %s", json.dumps(report))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
