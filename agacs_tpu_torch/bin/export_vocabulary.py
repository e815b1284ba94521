"""Token-list export (counterpart of `agacs_tpu/bin/export_vocabulary.py`)
— `espnet2/bin/whisper_export_vocabulary.py:37-57`
(recipe stage 5, asr.sh:791): dump all 51,865 whisper-multilingual token
strings, one per line, in id order.

  python -m agacs_tpu_torch.bin.export_vocabulary --output token_list.txt
"""

from __future__ import annotations

import argparse

from agacs_tpu_torch.text import WhisperTokenizer


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    tok = WhisperTokenizer()
    n = tok.special.n_vocab
    with open(args.output, "w", encoding="utf-8") as f:
        for tid in range(n):
            f.write(tok.id_to_token(tid) + "\n")
    print(f"wrote {n} tokens to {args.output}")
    return n


if __name__ == "__main__":
    main()
