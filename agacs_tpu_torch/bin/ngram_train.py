"""N-gram LM training CLI (counterpart of `agacs_tpu/bin/ngram_train.py`):
counts tokenized text into the hashed stupid-backoff tables that
`models/ngram.py` scores at decode time, written in JAX's npz layout.

  python -m agacs_tpu_torch.bin.ngram_train --train_text data/train/text \\
      --output exp/ngram/ngram.npz [--order 3] [--alpha 0.4]
"""

from __future__ import annotations

import argparse
import logging
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train_text", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--alpha", type=float, default=0.4)
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from agacs_tpu_torch.data.io import read_scp
    from agacs_tpu_torch.models.ngram import save_ngram, train_ngram
    from agacs_tpu_torch.text import WhisperTokenIdConverter, WhisperTokenizer

    tok = WhisperTokenizer()
    conv = WhisperTokenIdConverter(tok)
    texts = list(read_scp(args.train_text).values())
    seqs = [conv.tokens2ids(tok.text2tokens(t)) for t in texts if t.strip()]
    lm = train_ngram(seqs, vocab_size=tok.special.n_vocab, order=args.order,
                     alpha=args.alpha, sos=tok.special.sot)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    save_ngram(args.output, lm)
    logging.info("ngram order=%d over %d sequences -> %s", args.order, len(seqs), args.output)
    return {"n_seqs": len(seqs), "output": args.output}


if __name__ == "__main__":
    main()
