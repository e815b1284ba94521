"""Decoding CLI (counterpart of the whisper path of
`agacs_tpu/bin/decode.py`): data dir -> hyp.trn + ref.trn + rtf.json,
greedy or beam search.

  python -m agacs_tpu_torch.bin.decode --config exp/x/config.yaml \
      --params exp/x/valid.acc.ave.params.npz \
      --data_dir data/dev --output_dir exp/x/decode_dev \
      [--decode_config conf/decode_asr_whisper.yaml] [--beam_size 5] \
      [--length_bonus 0.0] [--decode_loop scan] [--max_steps 200] \
      [--batch_size 8] [--compute_dtype bfloat16] [--device cuda]
  python -m agacs_tpu.bin.score --ref exp/x/decode_dev/ref.trn \
      --hyp exp/x/decode_dev/hyp.trn --output_dir exp/x/decode_dev/score

`--params` is the `.params.npz` the JAX trainer writes. A checkpoint of
the int8 frozen trunk (`freeze_quant: int8`, its `w_q`/`w_s` leaves)
builds the quantised model and decodes on kernels K8 and K2; the config's
`freeze_quant: int8` + `freeze_param` (what JAX's CLI keys on) and the npz
must agree. The .trn files
have the format `agacs_tpu.bin.score` reads. The decode YAML's keys
apply as in JAX (`penalty` is the length bonus). `--cross_kv_int8` stores
the precomputed cross-attention K/V int8 (kernels K3-int8 / K3s-int8). A
PE checkpoint (`pe_whisper` in the config) builds the PE model. CTC / LM
fusion (a CTC head, or the YAML's ctc_weight / lm_weight) are not ported
yet and raise; the JAX CLI's LM and n-gram flags do not exist here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import numpy as np
import torch

from agacs_tpu_torch.eval.scoring import write_trn
from agacs_tpu_torch.data.io import DataDir
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.models.whisper import Whisper
from agacs_tpu_torch.utils.config import load_yaml, model_config_from_dict


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--decode_config", default=None,
                   help="decode-option YAML (decode_asr_whisper.yaml schema); "
                        "CLI flags override it")
    p.add_argument("--params", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=200,
                   help="generated-token cap; 0 = derive from maxlenratio "
                        "(0.0 -> encoder frame count)")
    p.add_argument("--maxlenratio", type=float, default=0.0)
    p.add_argument("--decode_loop", default="scan", choices=["scan", "while"],
                   help="beam loop form: scan (to the step cap, no host read per "
                        "step) or while (exits once every utterance has stopped)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--length_bonus", type=float, default=0.0)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--cross_kv_int8", action="store_true",
                   help="store the precomputed cross-attention K/V int8 with "
                        "per-channel scales (halves the bytes the decode "
                        "step's cross-attention reads)")
    p.add_argument("--device", default="cuda")
    return p


def _apply_decode_config(args, path: str, raw_argv: list[str]) -> dict:
    """Decode-option YAML values become argparse defaults (explicit CLI
    flags win); `penalty` is the length bonus, as in JAX (:95); a config
    bearing maxlenratio derives maxlen from frames unless --max_steps was
    given. Returns the scorer weights it sets."""
    dc = load_yaml(path)
    given = {a.split("=")[0].lstrip("-").replace("-", "_")
             for a in raw_argv if a.startswith("--")}
    for key, value in dc.items():
        dest = {"penalty": "length_bonus"}.get(key, key)
        if hasattr(args, dest) and dest not in given:
            cur = getattr(args, dest)
            setattr(args, dest, type(cur)(value) if cur is not None else value)
    if "maxlenratio" in dc and "max_steps" not in given:
        args.max_steps = 0
    return {k: float(dc.get(k, 0.0)) for k in ("ctc_weight", "lm_weight")}


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    weights = {}
    if args.decode_config:
        weights = _apply_decode_config(
            args, args.decode_config, argv if argv is not None else sys.argv[1:])
    raw = load_yaml(args.config)
    cfg = model_config_from_dict(raw, compute_dtype=getattr(torch, args.compute_dtype))
    if args.cross_kv_int8:
        cfg = dataclasses.replace(
            cfg, whisper=dataclasses.replace(cfg.whisper, cross_kv_int8=True))
    tree = np.load(args.params)
    int8_conf = raw.get("freeze_quant") == "int8" and bool(raw.get("freeze_param"))
    if int8_conf != any(k.endswith("/w_q") for k in tree.files):
        raise ValueError(f"{args.params}: the config says freeze_quant int8 is "
                         f"{'on' if int8_conf else 'off'}, the checkpoint's trunk "
                         f"{'is not' if int8_conf else 'is'} int8")
    if any(k.startswith("ctc/") for k in tree.files):
        raise NotImplementedError(
            "checkpoint has a CTC head: joint CTC/attention decoding is not "
            "ported yet")
    model = Whisper.from_state_dict(
        cfg.whisper, params_from_numpy(tree, cfg.whisper), device=args.device)
    s2t = Speech2Text(
        model, cfg, beam_size=args.beam_size,
        max_steps=args.max_steps if args.max_steps > 0 else None,
        maxlenratio=args.maxlenratio, length_bonus=args.length_bonus,
        loop=args.decode_loop, **weights,
    )

    ds = DataDir(args.data_dir)
    hyps, refs = {}, {}
    utts = sorted(ds.utt_ids, key=ds.num_samples)
    for i in range(0, len(utts), args.batch_size):
        chunk = utts[i : i + args.batch_size]
        speech = [ds.speech(u) for u in chunk]
        s_max = -(-max(len(x) for x in speech) // 16000) * 16000  # 1 s buckets
        audio = np.zeros((len(chunk), s_max), np.float32)
        lens = np.zeros((len(chunk),), np.int64)
        for k, x in enumerate(speech):
            audio[k, : len(x)] = x
            lens[k] = len(x)
        for u, r in zip(chunk, s2t(audio, lengths=lens)):
            hyps[u] = r.text
            refs[u] = ds.text[u]
        logging.info("decoded %d/%d (running 1/RTF=%.1fx)",
                     min(i + args.batch_size, len(utts)), len(utts), s2t.inverse_rtf)
    rtf_report = {
        "rtf": s2t.rtf, "inverse_rtf": s2t.inverse_rtf,
        "audio_seconds": s2t._audio_seconds,
        "decode_seconds": s2t._decode_seconds, "n_utts": len(utts),
        "device": str(model.decoder.logits_weight.device),
    }
    os.makedirs(args.output_dir, exist_ok=True)
    write_trn(os.path.join(args.output_dir, "hyp.trn"), hyps)
    write_trn(os.path.join(args.output_dir, "ref.trn"), refs)
    with open(os.path.join(args.output_dir, "rtf.json"), "w") as f:
        json.dump(rtf_report, f, indent=1)
    logging.info("RTF=%.4f (decode %.1fs / audio %.1fs)", rtf_report["rtf"],
                 rtf_report["decode_seconds"], rtf_report["audio_seconds"])
    return {"hyps": hyps, "refs": refs, "rtf": rtf_report}


if __name__ == "__main__":
    main()
