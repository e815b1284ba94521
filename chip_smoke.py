#!/usr/bin/env python3
"""Drive the PyTorch port's greedy serving path once on one CUDA card.

    python3 chip_smoke.py

Run from (or point at) a checkout of the repository on a machine with a
CUDA card and the CUDA toolkit (nvcc). It imports nothing of JAX. Phases,
one line each; any failure ends the script with a non-zero exit:

  1. device and build: the card, and the nvcc build of both kernels;
  2. K1 (csrc/packed_flash_fwd.cu) against its plain PyTorch version at the
     encoder shapes (8, 750, 768) and (2, 1500, 768), 12 heads;
  3. K3 (csrc/decode_attn.cu) against its plain version at the greedy
     decode shapes: self (8, 112, 768) at pos 0/4/57/103, cross
     (8, 752, 768) at pos 749;
  4. the slice: whisper-small with adapters in both stacks (the stage-2
     recipe's flags), bf16, random weights from torch seed 0, Speech2Text
     on 8 x 15 s of seeded noise, 100 greedy steps; ms per batch,
     x realtime, and the launch counts of both kernels in that run;
  5. the card (bf16) against the port on the CPU (float32) on the same
     weights, one utterance: encoder output and first-step logits;
  6. torch.profiler over one more warm request of phase 4: device busy
     time, device events per decode step, the device's idle share of
     phase 4's ms per batch, and the kernels that take the most time.

The last three lines are the card's `name, power.limit` (nvidia-smi), a
JSON line with each kernel's launches, error and times, and the
`{"ok": true, "device": ...}` line.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H, D = 12, 768
PRIMER = [50258, 50260, 50259, 50359, 50363]
# Kernel vs its plain version evaluated in float32 on the same bf16 inputs:
# max |err| <= KERNEL_RTOL * max |plain|. The kernels round p to bf16
# (2^-9 relative) and round the output to bf16 (half an ulp, at most 2^-8
# of the value); together ~3e-3 of the largest output. The inputs make the
# softmax sharp (scores with a std of ~2.7) and shifted (mean ~-8), so a
# dropped key tile, a missing online-softmax rescale or an unmasked key
# tail moves the output by a large part of its range, not by an ulp.
KERNEL_RTOL = 1e-2
# card (bf16 weights and activations) vs CPU (float32): bf16 rounding
# (~4e-3 relative per op) accumulated through 12 residual layers.
ENC_REL_L2 = 5e-2
LOGITS_REL_L2 = 5e-2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, arg_sets, iters):
    """Mean device ms per call over `iters` calls, cycling through
    `arg_sets` (distinct buffers larger than the 50 MB L2 together, so each
    call reads from HBM as in the model). A sleep kernel first holds the
    stream while the host enqueues every call, so the events time the
    device running them back to back, not the host's launch rate."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def sharp_qkv(g, dev, q_shape, kv_shape, q_scale=1.0):
    """bf16 q, k, v on `dev` whose softmax is sharp and shifted: q and k
    have a std of 1.5 and means of -1 and +1 per channel, so the scaled
    scores q.k/8 have a std of ~2.7 around ~-8; v is standard normal."""
    def rnd(shape, mean, scale):
        x = torch.randn(*shape, generator=g) * scale + mean
        return x.to(dev, torch.bfloat16)
    q = (rnd(q_shape, -1.0, 1.5).float() * q_scale).to(torch.bfloat16)
    return q, rnd(kv_shape, 1.0, 1.5), rnd(kv_shape, 0.0, 1.0)


def hold(name, out, plain_f32, shape) -> float:
    """max |out - plain| (raising past KERNEL_RTOL * max |plain|)."""
    torch.cuda.synchronize()
    err = (out.float() - plain_f32.float()).abs().max().item()
    bound = KERNEL_RTOL * plain_f32.float().abs().max().item()
    check(tuple(out.shape) == tuple(plain_f32.shape) and err <= bound,
          f"{name} {shape}: max_abs_err {err} <= {bound}")
    return err


def check_k1(dev, g, timed=True) -> dict:
    """Phase 2: K1 against its plain version; returns its err and times."""
    from agacs_tpu_torch.ops import flash_train

    res = {"err": 0.0}
    for b, t in ((8, 750), (2, 1500)):
        sets = [(*sharp_qkv(g, dev, (b, t, D), (b, t, D)), H) for _ in range(4)]
        q, k, v, _ = sets[0]
        err = hold("K1", flash_train.packed_flash_mha(q, k, v, H),
                   flash_train.packed_flash_mha_ref(q.float(), k.float(),
                                                    v.float(), H), (b, t, D))
        res["err"] = max(res["err"], err)
        if not timed:
            continue
        ms = cuda_ms(flash_train.packed_flash_mha, sets, 20)
        plain_ms = cuda_ms(flash_train.packed_flash_mha_ref, sets, 20)
        if t == 750:
            res.update(ms=ms, plain_ms=plain_ms)
        print(f"phase 2 K1 packed_flash_fwd ({b}, {t}, {D}) H={H}: max_abs_err "
              f"{err:.3e} (bound {KERNEL_RTOL} x max|plain f32|) kernel "
              f"{ms:.4f} ms plain bf16 {plain_ms:.4f} ms", flush=True)
    return res


def check_k3(dev, g, timed=True) -> dict:
    """Phase 3: K3 against its plain version. Keys past pos are poisoned in
    the kernel's input (score 0, far above the others, and value 1e4), so
    a kernel that reads one fails."""
    from agacs_tpu_torch.ops import decode_attn

    res = {"err": 0.0}
    for tp, pos in ((112, 0), (112, 4), (112, 57), (112, 103), (752, 749)):
        sets = [(*sharp_qkv(g, dev, (8, D), (8, tp, D), q_scale=0.125), pos, H)
                for _ in range(8)]
        q, k, v, _, _ = sets[0]
        k_bad, v_bad = k.clone(), v.clone()
        k_bad[:, pos + 1:] = 0.0
        v_bad[:, pos + 1:] = 1e4
        err = hold(f"K3 pos={pos}",
                   decode_attn.decode_cache_attention(q, k_bad, v_bad, pos, H),
                   decode_attn.decode_cache_attention_ref(
                       q.float(), k.float(), v.float(), pos, H), (8, tp, D))
        res["err"] = max(res["err"], err)
        if not timed:
            continue
        ms = cuda_ms(decode_attn.decode_cache_attention, sets, 50)
        plain_ms = cuda_ms(decode_attn.decode_cache_attention_ref, sets, 50)
        if tp == 752:
            res.update(ms=ms, plain_ms=plain_ms)
        print(f"phase 3 K3 decode_attn (8, {tp}, {D}) pos={pos}: max_abs_err "
              f"{err:.3e} (bound {KERNEL_RTOL} x max|plain f32|) kernel "
              f"{ms:.4f} ms plain bf16 {plain_ms:.4f} ms", flush=True)
    return res


def profile_request(s2t, audio, ms_batch: float, n_steps: int) -> None:
    """Phase 6: one warm request under torch.profiler (CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s2t(audio)
        torch.cuda.synchronize()
    per_name: dict[str, float] = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] += e.time_range.elapsed_us() / 1e3
    n_events = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(n_events > 0, "the profiler recorded device events")
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"phase 6 profile: device busy {busy:.1f} ms in {n_events} device "
          f"events ({n_events / n_steps:.0f} per decode step); idle "
          f"{1 - busy / ms_batch:.1%} of phase 4's {ms_batch:.1f} ms/batch; top: "
          + "; ".join(f"{n[:48]} {t:.2f} ms" for n, t in top), flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "agacs_tpu_torch")):
        sys.exit("chip_smoke: agacs_tpu_torch/ is not beside this script; "
                 "run it from a checkout of the repository")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode
    from agacs_tpu_torch.ops import cuda_lib, decode_attn, flash_train

    dev = torch.device("cuda:0")

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    for name in ("packed_flash_fwd", "decode_attn"):
        cuda_lib.build(name)
    build_s = time.perf_counter() - t0
    ptxas = "; ".join(
        f"{name}: {line.split(':', 1)[1].strip()}"
        for name, log in cuda_lib.BUILD_LOG.items()
        for line in log.splitlines() if "Used" in line and "registers" in line)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
          f"{build_s:.2f} s | ptxas {ptxas or 'cached build'}", flush=True)

    # 2-3. each kernel against its plain version
    g = torch.Generator(device="cpu").manual_seed(0)
    k1 = check_k1(dev, g)
    k3 = check_k3(dev, g)

    # 4. the slice: Speech2Text, whisper-small + adapters, bf16, 8 x 15 s
    cfg = tw.make_config("small", adapter=True, adapter_encoder=True,
                         adapter_decoder=True, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    sd = tw.init_whisper_params(torch.Generator(device="cpu").manual_seed(0), cfg)
    model = tw.Whisper.from_state_dict(cfg, sd, device=dev)
    load_s = time.perf_counter() - t0
    asr_cfg = ASRModelConfig(whisper=cfg)
    s2t = Speech2Text(model, asr_cfg, max_steps=100)
    audio = (np.random.RandomState(0).randn(8, 15 * 16000) * 0.1).astype(np.float32)
    s2t(audio)  # warm-up: cuBLAS/cuDNN handles, kernel libraries
    torch.cuda.synchronize()
    flash_train.LAUNCHES = decode_attn.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = s2t(audio)
    times = [time.perf_counter() - t0]
    launches = {"K1": flash_train.LAUNCHES, "K3": decode_attn.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        s2t(audio)
        times.append(time.perf_counter() - t0)
    n_steps = min(len(PRIMER) + 100, cfg.n_text_ctx) - 1  # greedy_decode's count
    check(len(results) == 8, "8 hypotheses")
    for r in results:
        check(r.tokens[:5] == PRIMER and 5 < len(r.tokens) <= 105
              and isinstance(r.text, str), f"hypothesis {r.tokens[:8]}...")
    check(launches["K1"] == cfg.n_audio_layer,
          f"K1 launches {launches['K1']} == {cfg.n_audio_layer} per encode")
    check(launches["K3"] == 2 * cfg.n_text_layer * n_steps,
          f"K3 launches {launches['K3']} == 24 per step x {n_steps} steps")
    ms_batch = statistics.median(times) * 1e3
    speech = torch.from_numpy(audio).to(dev)
    lens = torch.full((8,), audio.shape[1], device=dev)
    enc_times = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode(model, asr_cfg, speech, lens)
            torch.cuda.synchronize()
            enc_times.append(time.perf_counter() - t0)
    enc_ms = statistics.median(enc_times) * 1e3
    dec_ms = ms_batch - enc_ms
    print(f"phase 4 slice: whisper-small+adapters bf16, 8 x 15 s, {n_steps} "
          f"decode steps: {ms_batch:.1f} ms/batch (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {120.0 / (ms_batch / 1e3):.1f}"
          f" x realtime; encode {enc_ms:.2f} ms (median of 3), so decode ~"
          f"{dec_ms:.1f} ms = {dec_ms / n_steps:.2f} ms/step; peak "
          f"{peak_gb:.2f} GB; launches K1 {launches['K1']} (12/encode) K3 "
          f"{launches['K3']} (24/step); weights built+loaded in {load_s:.1f} s",
          flush=True)

    # 5. card (bf16) vs the port on the CPU (float32), same weights
    one = torch.from_numpy(audio[:1])
    one_len = torch.tensor([audio.shape[1]])
    cpu_cfg = tw.make_config("small", adapter=True, adapter_encoder=True,
                             adapter_decoder=True, compute_dtype=torch.float32)
    cpu_model = tw.Whisper.from_state_dict(cpu_cfg, sd, device="cpu")
    first = torch.tensor([PRIMER[0]])
    with torch.inference_mode():
        outs = []
        for m, c, d in ((model, asr_cfg, dev),
                        (cpu_model, ASRModelConfig(whisper=cpu_cfg), "cpu")):
            enc, _ = encode(m, c, one.to(d), one_len.to(d))
            kv = tw.init_self_kv_cache(m.cfg, 1, 16, device=d)
            logits, _ = tw.whisper_decode_step(
                m, first.to(d), 0, kv, tw.precompute_cross_kv(m, enc))
            outs.append((enc.float().cpu(), logits.cpu()))
    (enc_g, log_g), (enc_c, log_c) = outs
    check(enc_g.shape == (1, 750, D) and bool(torch.isfinite(enc_g).all())
          and bool(torch.isfinite(log_g).all()), "finite outputs of the right shape")
    e_enc, e_log = rel_l2(enc_g, enc_c), rel_l2(log_g, log_c)
    check(e_enc < ENC_REL_L2, f"encoder rel L2 {e_enc} < {ENC_REL_L2}")
    check(e_log < LOGITS_REL_L2, f"first-step logits rel L2 {e_log} < {LOGITS_REL_L2}")
    print(f"phase 5 card bf16 vs cpu f32: encoder rel L2 {e_enc:.3e} (bound "
          f"{ENC_REL_L2}), first-step logits rel L2 {e_log:.3e} (bound "
          f"{LOGITS_REL_L2}); argmax card {int(log_g.argmax())} cpu "
          f"{int(log_c.argmax())}", flush=True)

    # 6. where the device time of one request goes
    profile_request(s2t, audio, ms_batch, n_steps)

    check(not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules),
          "no JAX module was imported")
    kernels = [
        {"name": "packed_flash_fwd (K1, encoder self-attention)", "route": "cuda",
         "source": "agacs_tpu_torch/csrc/packed_flash_fwd.cu",
         "replaces": "agacs_tpu/ops/flash_train.py:155",
         "launches": launches["K1"], "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "decode_attn_fwd (K3, decode-step cache attention)",
         "route": "cuda", "source": "agacs_tpu_torch/csrc/decode_attn.cu",
         "replaces": "agacs_tpu/ops/decode_attn.py:140",
         "launches": launches["K3"], "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
