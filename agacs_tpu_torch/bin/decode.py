"""Decoding CLI (counterpart of `agacs_tpu/bin/decode.py`): data dir ->
hyp.trn + ref.trn + rtf.json.

  python -m agacs_tpu_torch.bin.decode --config exp/x/config.yaml \\
      --params exp/x/valid.acc.ave.params.npz \\
      --data_dir data/dev --output_dir exp/x/decode_dev \\
      [--decode_config conf/decode_asr.yaml] [--beam_size 10] \\
      [--ctc_weight 0.4] [--lm_exp exp/lm] [--lm_weight 0.2] \\
      [--ngram_file exp/ngram/ngram.npz] [--ngram_weight 0.3] \\
      [--length_bonus 0.0] [--decode_loop scan] [--max_steps 200] \\
      [--batch_size 8] [--compute_dtype bfloat16] [--device cuda]
  python -m agacs_tpu_torch.bin.score --ref exp/x/decode_dev/ref.trn \\
      --hyp exp/x/decode_dev/hyp.trn --output_dir exp/x/decode_dev/score

`--params` is the `.params.npz` the JAX trainer writes. The config's
`encoder:` key picks the family, as in JAX.

Whisper family: greedy or beam search with the dual-language primer. A
checkpoint of the int8 frozen trunk (`freeze_quant: int8`, its `w_q`/`w_s`
leaves) builds the quantised model and decodes on kernels K8 and K2; the
config's `freeze_quant: int8` + `freeze_param` and the npz must agree.
`--cross_kv_int8` stores the precomputed cross-attention K/V int8 (kernels
K3-int8 / K3s-int8). A PE checkpoint (`pe_whisper`) builds the PE model.
Fusion, as in JAX (:332-346): a checkpoint with a CTC head (`ctc/` leaves)
decodes with CTC prefix scoring at `--ctc_weight` (default 0.3;
`decode_asr_whisper.yaml` sets 0.0), one without it at 0; `--lm_exp`
fuses the transformer LM at `--lm_weight` (K3-f32 on its caches);
`--ngram_file` (from `bin.ngram_train`) the n-gram at `--ngram_weight`.
Any fusion weight above 0 takes the beam search, at `--beam_size 1` too.

Conformer family (`recipes/seame/run_conformer.sh` stage 4, with
`decode_asr.yaml`: beam 10, ctc_weight 0.4, lm_weight 0.2): the
conformer encoder (kernel K5 in every block at bf16 within its envelope),
CTC log-probs from the head's product in the encoder's dtype and a
float32 log-softmax, and the joint CTC/attention beam search with the
transformer LM of `--lm_exp` (its `config.yaml` lm_conf and
`valid.loss.ave.params.npz`, built in float32) fused at `--lm_weight`
(`decode/joint_beam.py`: K3 on the decoder's caches, K3-f32 on the LM's).
`--max_steps 0` means the number of encoder frames. The conformer and
transducer families ignore `--ngram_file`, as in JAX.

Transducer family (`decoder: transducer`): the conformer encoder, then
with `--beam_size 1` the batched greedy search (`greedy_search_scan`, no
host read inside it); above, `--transducer_search` picks the beam:
`default` (the reference's default_beam_search per utterance, with
`--lm_exp` shallow fusion), `tsd` / `alsd` (batched time-synchronous and
alignment-length-synchronous beams, `decode/transducer_tsd.py`; ALSD's
label cap `--transducer_u_max`) or `nsc` / `maes` (per utterance,
`decode/transducer_nsc.py`). `--lm_exp` is ignored, with a warning, by
greedy decoding and by every search but `default`, as in JAX.

The decode YAML's keys apply as in JAX (`penalty` is the length bonus,
explicit flags win, a YAML with maxlenratio sets --max_steps 0). The .trn
files have the format `agacs_tpu.bin.score` and `agacs_tpu_torch.bin.score`
read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from agacs_tpu_torch.data.io import DataDir
from agacs_tpu_torch.decode.speech2text import Speech2Text
from agacs_tpu_torch.eval.scoring import write_trn
from agacs_tpu_torch.models.checkpoint import params_from_numpy
from agacs_tpu_torch.models.whisper import Whisper
from agacs_tpu_torch.utils.config import load_yaml, task_from_dict


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--decode_config", default=None,
                   help="decode-option YAML (decode_asr_whisper.yaml / decode_asr.yaml: "
                        "beam_size, ctc_weight, lm_weight, penalty, maxlenratio); CLI "
                        "flags override it")
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
    p.add_argument("--ctc_weight", type=float, default=0.3,
                   help="CTC weight in the joint beam (conformer family; whisper "
                        "checkpoints with a CTC head)")
    p.add_argument("--lm_exp", default=None,
                   help="LM experiment dir for shallow fusion")
    p.add_argument("--lm_weight", type=float, default=0.3)
    p.add_argument("--ngram_file", default=None,
                   help="n-gram npz from bin.ngram_train (whisper family)")
    p.add_argument("--ngram_weight", type=float, default=0.3)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--cross_kv_int8", action="store_true",
                   help="store the precomputed cross-attention K/V int8 with "
                        "per-channel scales (halves the bytes the decode "
                        "step's cross-attention reads; whisper family)")
    p.add_argument("--transducer_search", default="default",
                   choices=("default", "tsd", "alsd", "nsc", "maes"),
                   help="transducer beam (beam_size > 1): default (per utterance, with "
                        "--lm_exp fusion), tsd / alsd (batched time-sync / "
                        "align-length-sync), nsc / maes (per utterance)")
    p.add_argument("--transducer_u_max", type=int, default=50,
                   help="ALSD label-length cap (BeamSearchTransducer u_max)")
    p.add_argument("--device", default="cuda")
    return p


def _apply_decode_config(args, path: str, raw_argv: list[str]) -> None:
    """Decode-option YAML values become argparse defaults (explicit CLI
    flags win); `penalty` is the length bonus, as in JAX (:95); a config
    bearing maxlenratio derives maxlen from frames unless --max_steps was
    given."""
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


def _load_lm_config(lm_exp: str):
    """The LM config from the LM experiment's config.yaml (`lm_conf`), in
    float32 as JAX's CLI builds it."""
    from agacs_tpu_torch.models.lm import TransformerLMConfig

    path = os.path.join(lm_exp, "config.yaml")
    if not os.path.exists(path):
        logging.warning("%s missing; assuming default LM architecture", path)
        return TransformerLMConfig(compute_dtype=torch.float32)
    conf = load_yaml(path).get("lm_conf", {}) or {}
    return TransformerLMConfig(compute_dtype=torch.float32, **conf)


def _load_lm(args):
    """The LM of --lm_exp on --device, or None (no --lm_exp, or lm_weight 0)."""
    if not (args.lm_exp and args.lm_weight > 0.0):
        return None
    from agacs_tpu_torch.models.checkpoint import lm_params_from_numpy
    from agacs_tpu_torch.models.lm import TransformerLM

    cfg = _load_lm_config(args.lm_exp)
    with np.load(os.path.join(args.lm_exp, "valid.loss.ave.params.npz")) as tree:
        sd = lm_params_from_numpy({k: tree[k] for k in tree.files}, cfg)
    return TransformerLM.from_state_dict(cfg, sd, device=args.device)


def _chunks(args, ds: DataDir):
    """Length-sorted chunks of --batch_size, padded to 1 s buckets:
    (utterance ids, (B, S) float32 audio, (B,) lengths)."""
    utts = sorted(ds.utt_ids, key=ds.num_samples)
    for i in range(0, len(utts), args.batch_size):
        chunk = utts[i : i + args.batch_size]
        speech = [ds.speech(u) for u in chunk]
        s_max = -(-max(len(x) for x in speech) // 16000) * 16000
        audio = np.zeros((len(chunk), s_max), np.float32)
        lens = np.zeros((len(chunk),), np.int64)
        for k, x in enumerate(speech):
            audio[k, : len(x)] = x
            lens[k] = len(x)
        yield chunk, audio, lens


def load_whisper_model(params: str, raw: dict, cfg, device) -> Whisper:
    """The whisper-family model of a `.params.npz` on `device` (a CTC head
    when the npz has `ctc/` leaves; the int8 trunk when it has `w_q`
    leaves, which the config's `freeze_quant: int8` + `freeze_param` must
    agree with)."""
    with np.load(params) as tree:
        int8_conf = raw.get("freeze_quant") == "int8" and bool(raw.get("freeze_param"))
        if int8_conf != any(k.endswith("/w_q") for k in tree.files):
            raise ValueError(f"{params}: the config says freeze_quant int8 is "
                             f"{'on' if int8_conf else 'off'}, the checkpoint's trunk "
                             f"{'is not' if int8_conf else 'is'} int8")
        sd = params_from_numpy(tree, cfg.whisper)
    return Whisper.from_state_dict(cfg.whisper, sd, device=device)


def _decode_whisper(args, raw: dict, cfg, ds: DataDir):
    if args.cross_kv_int8:
        cfg = dataclasses.replace(
            cfg, whisper=dataclasses.replace(cfg.whisper, cross_kv_int8=True))
    model = load_whisper_model(args.params, raw, cfg, args.device)
    lm = _load_lm(args)
    ngram_lm = None
    if args.ngram_file:
        from agacs_tpu_torch.models.ngram import load_ngram

        ngram_lm = load_ngram(args.ngram_file, device=args.device)
    s2t = Speech2Text(
        model, cfg, beam_size=args.beam_size,
        max_steps=args.max_steps if args.max_steps > 0 else None,
        maxlenratio=args.maxlenratio, length_bonus=args.length_bonus,
        ctc_weight=args.ctc_weight if getattr(model, "ctc", None) is not None else 0.0,
        lm=lm, lm_weight=args.lm_weight if lm is not None else 0.0,
        ngram_lm=ngram_lm, ngram_weight=args.ngram_weight if ngram_lm is not None else 0.0,
        loop=args.decode_loop,
    )
    hyps, refs = {}, {}
    for chunk, audio, lens in _chunks(args, ds):
        for u, r in zip(chunk, s2t(audio, lengths=lens)):
            hyps[u] = r.text
            refs[u] = ds.text[u]
        logging.info("decoded %d/%d (running 1/RTF=%.1fx)", len(hyps), len(ds.utt_ids),
                     s2t.inverse_rtf)
    return hyps, refs, {
        "rtf": s2t.rtf, "inverse_rtf": s2t.inverse_rtf,
        "audio_seconds": s2t._audio_seconds,
        "decode_seconds": s2t._decode_seconds, "n_utts": len(hyps),
        "device": str(model.decoder.token_embedding.weight.device),
    }


def _chunked_decode(args, ds: DataDir, decode_chunk):
    """JAX `_chunked_decode`: per chunk, `decode_chunk(audio, lens)` (device
    tensors) -> token id lists; the RTF over all chunks and over the chunks
    after the first (the first pays the kernel builds)."""
    from agacs_tpu_torch.text import WhisperTokenizer

    tokenizer = WhisperTokenizer()
    hyps, refs, secs = {}, {}, []
    for chunk, audio, lens in _chunks(args, ds):
        t0 = time.perf_counter()
        rows = decode_chunk(torch.from_numpy(audio).to(args.device),
                            torch.from_numpy(lens).to(args.device))
        secs.append((time.perf_counter() - t0, float(lens.sum()) / 16000.0))
        for u, ids in zip(chunk, rows):
            hyps[u] = tokenizer.decode(ids)
            refs[u] = ds.text[u]
        logging.info("decoded %d/%d", len(hyps), len(ds.utt_ids))
    decode_s, audio_s = sum(d for d, _ in secs), sum(a for _, a in secs)
    rtf = decode_s / max(audio_s, 1e-9)
    report = {"rtf": rtf, "inverse_rtf": 1.0 / max(rtf, 1e-9), "audio_seconds": audio_s,
              "decode_seconds": decode_s, "n_utts": len(hyps),
              "device": str(torch.device(args.device))}
    if len(secs) > 1:
        warm = sum(d for d, _ in secs[1:]) / max(sum(a for _, a in secs[1:]), 1e-9)
        report.update(rtf_warm=warm, inverse_rtf_warm=1.0 / max(warm, 1e-9))
    return hyps, refs, report


def _decode_conformer(args, cfg, ds: DataDir):
    """JAX `_decode_conformer`: per chunk, encode, CTC log-probs, joint beam
    with the LM."""
    from agacs_tpu_torch.decode.joint_beam import decode_conformer_batch
    from agacs_tpu_torch.models.checkpoint import conformer_params_from_numpy
    from agacs_tpu_torch.models.conformer_asr import ConformerASR

    with np.load(args.params) as tree:
        sd = conformer_params_from_numpy({k: tree[k] for k in tree.files}, cfg)
    model = ConformerASR.from_state_dict(cfg, sd, device=args.device)
    lm = _load_lm(args)

    def decode_chunk(audio, lens):
        return decode_conformer_batch(
            model, lm, audio, lens, beam_size=args.beam_size, ctc_weight=args.ctc_weight,
            lm_weight=args.lm_weight, max_steps=args.max_steps,
            length_bonus=args.length_bonus, loop=args.decode_loop)[0]

    return _chunked_decode(args, ds, decode_chunk)


def _decode_transducer(args, cfg, ds: DataDir):
    """JAX `_decode_transducer` (:223-312): batched greedy (beam_size 1),
    the batched TSD / ALSD beams, or a per-utterance beam (default, with the
    LM of --lm_exp; NSC; mAES), each hypothesis its best's tokens without
    blanks."""
    from agacs_tpu_torch.decode import transducer_nsc, transducer_tsd
    from agacs_tpu_torch.models import transducer_asr
    from agacs_tpu_torch.models.checkpoint import transducer_params_from_numpy
    from agacs_tpu_torch.models.transducer import default_beam_search, greedy_search_scan

    search = args.transducer_search
    lm = None
    if args.lm_exp and args.beam_size <= 1:
        logging.warning("--lm_exp has no effect with greedy decoding (beam_size<=1); LM "
                        "fusion requires --beam_size > 1 with --transducer_search default")
    elif search != "default" and args.beam_size > 1 and args.lm_exp:
        logging.warning("--lm_exp is not supported by the %s search; LM fusion is available "
                        "with --transducer_search default", search)
    else:
        lm = _load_lm(args)
    with np.load(args.params) as tree:
        sd = transducer_params_from_numpy({k: tree[k] for k in tree.files}, cfg)
    model = transducer_asr.TransducerASR.from_state_dict(cfg, sd, device=args.device)
    tmodel, blank = model.transducer, cfg.decoder.blank_id

    def strip(row, n):
        return [t for t in row[:n].tolist() if t != blank]

    @torch.inference_mode()
    def decode_chunk(audio, lens):
        enc, enc_lens = transducer_asr.encode(model, audio, lens)
        if args.beam_size <= 1:
            tokens, n_emit = (t.cpu().numpy() for t in greedy_search_scan(tmodel, enc, enc_lens))
            return [strip(row, n) for row, n in zip(tokens, n_emit)]
        if search in ("tsd", "alsd"):
            if search == "tsd":
                out = transducer_tsd.tsd_beam_search(tmodel, enc, enc_lens, beam=args.beam_size)
            else:
                out = transducer_tsd.alsd_beam_search(tmodel, enc, enc_lens,
                                                      beam=args.beam_size,
                                                      u_max=args.transducer_u_max)
            tokens, n = (t.cpu().numpy() for t in out[:2])
            return [strip(row[0], k[0]) for row, k in zip(tokens, n)]
        rows = []
        for k in range(enc.shape[0]):
            e = enc[k, :int(enc_lens[k])]
            if search == "nsc":
                nbest = transducer_nsc.nsc_beam_search(tmodel, e, beam_size=args.beam_size)
            elif search == "maes":
                nbest = transducer_nsc.maes_beam_search(tmodel, e, beam_size=args.beam_size)
            else:
                nbest = default_beam_search(
                    tmodel, e, beam_size=args.beam_size, lm=lm,
                    lm_weight=args.lm_weight if lm is not None else 0.0,
                    lm_sos=lm.cfg.sos if lm is not None else 50258)
            rows.append(nbest[0][1])
        return rows

    return _chunked_decode(args, ds, decode_chunk)


def main(argv: list[str] | None = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.decode_config:
        _apply_decode_config(args, args.decode_config,
                             argv if argv is not None else sys.argv[1:])
    raw = load_yaml(args.config)
    task = task_from_dict(raw, compute_dtype=getattr(torch, args.compute_dtype))
    ds = DataDir(args.data_dir)
    if task.kind == "conformer":
        hyps, refs, rtf_report = _decode_conformer(args, task.cfg, ds)
    elif task.kind == "transducer":
        hyps, refs, rtf_report = _decode_transducer(args, task.cfg, ds)
    else:
        hyps, refs, rtf_report = _decode_whisper(args, raw, task.cfg, ds)
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
