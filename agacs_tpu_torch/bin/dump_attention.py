"""Attention-map dump CLI (counterpart of `agacs_tpu/bin/dump_attention.py`):
teacher-force each utterance's reference text (or, with --from_hyp, its
greedy hypothesis) and write the per-layer, per-head decoder
self-attention score maps, `<utt>.npz` (maps (L, h, T, T) pre-softmax,
-inf where causally masked; a PE decoder's post-softmax mix, as the
reference's PE block returns it; token_ids) and `<utt>.json` (tokens,
shape).

  python -m agacs_tpu_torch.bin.dump_attention --config exp/x/config.yaml \\
      --params exp/x/valid.acc.ave.params.npz --data_dir data/dev \\
      --output_dir exp/x/att_maps [--utts u1 u2] [--from_hyp] [--plot] \\
      [--device cuda]

--plot also renders one PNG grid per utterance; only then is matplotlib
imported.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from agacs_tpu_torch.data.dataset import ASRDataset
from agacs_tpu_torch.decode.greedy import greedy_decode
from agacs_tpu_torch.models.asr_model import encode
from agacs_tpu_torch.models.checkpoint import load_model
from agacs_tpu_torch.models.whisper import whisper_decode
from agacs_tpu_torch.train.losses import add_sos_eos
from agacs_tpu_torch.utils.config import load_yaml, model_config_from_dict


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--utts", nargs="*", default=None)
    p.add_argument("--from_hyp", action="store_true",
                   help="dump maps for the greedy hypothesis instead of the reference text")
    p.add_argument("--plot", action="store_true",
                   help="also render per-layer PNG heatmap grids")
    p.add_argument("--compute_dtype", default="float32", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    return p


def _plot_maps(maps: np.ndarray, token_strs: list[str], out_png: str) -> None:
    """(L, h, T, T) score maps -> one PNG grid of post-softmax heatmaps."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    l_n, h_n = maps.shape[:2]
    probs = np.where(np.isfinite(maps), maps, -1e30)
    probs = np.exp(probs - probs.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    fig, axes = plt.subplots(l_n, h_n, figsize=(2.2 * h_n, 2.2 * l_n))
    axes = np.atleast_2d(axes)
    for li in range(l_n):
        for hi in range(h_n):
            ax = axes[li, hi]
            ax.imshow(probs[li, hi], cmap="viridis", aspect="auto")
            ax.set_xticks([]), ax.set_yticks([])
            if hi == 0:
                ax.set_ylabel(f"L{li}", fontsize=8)
            if li == 0:
                ax.set_title(f"H{hi}", fontsize=8)
    fig.suptitle(" ".join(token_strs)[:120], fontsize=9)
    fig.tight_layout()
    fig.savefig(out_png, dpi=90)
    plt.close(fig)


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = model_config_from_dict(
        load_yaml(args.config), compute_dtype=getattr(torch, args.compute_dtype))
    model = load_model(cfg.whisper, args.params, args.device)
    ds = ASRDataset(args.data_dir, with_cs_labels=False)
    os.makedirs(args.output_dir, exist_ok=True)

    dumped = {}
    for utt in args.utts or ds.utt_ids:
        item = ds[utt]
        speech = torch.from_numpy(item["speech"])[None, :].to(args.device)
        with torch.inference_mode():
            enc_out, _ = encode(model, cfg, speech,
                                torch.tensor([speech.shape[1]], device=args.device))
            if args.from_hyp:
                toks, lens = greedy_decode(model, enc_out, max_steps=100)
                ys_in = toks[:, : int(lens[0])]
            else:
                text = torch.from_numpy(item["text"]).long()[None, :].to(args.device)
                ys_in, _ = add_sos_eos(text, cfg.sos, cfg.eos, cfg.ignore_id)
            _, aux = whisper_decode(model, ys_in, enc_out, src_layer=0,
                                    collect_full_maps=True)
        maps = aux["maps"][:, 0].cpu().numpy()  # (L, h, T, T)
        token_ids = ys_in[0].tolist()
        token_strs = [ds.tokenizer.id_to_token(t) for t in token_ids]
        np.savez_compressed(os.path.join(args.output_dir, f"{utt}.npz"), maps=maps,
                            token_ids=np.asarray(token_ids))
        with open(os.path.join(args.output_dir, f"{utt}.json"), "w") as f:
            json.dump({"tokens": token_strs, "shape": list(maps.shape)}, f,
                      ensure_ascii=False)
        if args.plot:
            _plot_maps(maps, token_strs, os.path.join(args.output_dir, f"{utt}.png"))
        dumped[utt] = maps.shape
        logging.info("%s: maps %s", utt, maps.shape)
    return dumped


if __name__ == "__main__":
    main()
