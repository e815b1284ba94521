"""Head-selection CLI (counterpart of `agacs_tpu/bin/count_heads.py`, stage
3 of `recipes/seame/run.sh`): run the model teacher-forced over a data
dir, count language-attending decoder heads, and write the counts JSON
and the selected-head mask beside it (`<output>.mask.json`).

  python -m agacs_tpu_torch.bin.count_heads --config conf.yaml \\
      --data_dir data/train [--params ckpt.params.npz] \\
      --output counts.json [--head_percentage 100] [--criterion mass] \\
      [--compute_dtype bfloat16] [--device cuda]

`--params` is a `.params.npz` in the JAX package's layout. Without it
the weights are random from torch seed 0 (the JAX CLI draws its own from
PRNGKey(0), so those counts differ).
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

from agacs_tpu_torch.adapt.head_selection import (
    count_language_heads,
    count_language_heads_topk,
    save_counts,
    select_heads,
)
from agacs_tpu_torch.data.collate import collate_batch, to_device
from agacs_tpu_torch.data.dataset import ASRDataset
from agacs_tpu_torch.data.sampler import num_elements_batches
from agacs_tpu_torch.models.asr_model import encode
from agacs_tpu_torch.models.checkpoint import load_model
from agacs_tpu_torch.models.whisper import whisper_decode
from agacs_tpu_torch.train.losses import add_sos_eos
from agacs_tpu_torch.utils.config import load_yaml, model_config_from_dict


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--head_percentage", type=float, default=100.0)
    p.add_argument("--batch_bins", type=int, default=2_000_000)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument(
        "--criterion", choices=["mass", "topk_old"], default="mass",
        help="'mass' = the live new_check_attention_language criterion; "
        "'topk_old' = the reference's dead old top-k formulation "
        "(espnet_model.py:312-363), needs full (T, T) maps",
    )
    p.add_argument("--device", default="cuda")
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = model_config_from_dict(
        load_yaml(args.config), compute_dtype=getattr(torch, args.compute_dtype))
    model = load_model(cfg.whisper, args.params, args.device)
    topk_old = args.criterion == "topk_old"

    ds = ASRDataset(args.data_dir, with_cs_labels=False)
    batches = num_elements_batches({u: ds.num_samples(u) for u in ds.utt_ids},
                                   args.batch_bins)
    total = None
    for i, utts in enumerate(batches):
        batch = to_device(collate_batch([ds[u] for u in utts]), args.device)
        with torch.inference_mode():
            enc_out, _ = encode(model, cfg, batch["speech"], batch["speech_lengths"])
            ys_in, _ = add_sos_eos(batch["text"], cfg.sos, cfg.eos, cfg.ignore_id)
            _, aux = whisper_decode(model, ys_in, enc_out, src_layer=0,
                                    collect_lang_cols=not topk_old,
                                    collect_full_maps=topk_old, need_probs=not topk_old)
            c = (count_language_heads_topk(aux["maps"]) if topk_old
                 else count_language_heads(aux["p_cols"]))
        total = c if total is None else total + c
        if (i + 1) % 20 == 0:
            logging.info("counted %d/%d batches", i + 1, len(batches))

    counts = total.cpu().numpy()
    save_counts(args.output, counts)
    mask = select_heads(counts, args.head_percentage)
    with open(args.output.replace(".json", "") + ".mask.json", "w") as f:
        json.dump({"head_mask": mask.astype(int).tolist()}, f)
    logging.info("saved %s (+mask): %d/%d heads selected", args.output,
                 int(mask.sum()), mask.size)
    return {"counts": counts, "mask": mask}


if __name__ == "__main__":
    main()
