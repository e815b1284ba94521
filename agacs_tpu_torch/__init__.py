"""agacs_tpu_torch — the PyTorch + CUDA port of agacs_tpu for NVIDIA Hopper.

The JAX package `agacs_tpu` stays the reference; this package mirrors its
module layout and names so each counterpart is found at the same path:

  ops/       log-mel frontend, plain attention, and the two hand-written
             Hopper kernels (K1 `flash_train.packed_flash_mha`, K3
             `decode_attn.decode_cache_attention`) with their plain versions
  csrc/      CUDA C++ sources of those kernels (sm_90a), built on first use
  models/    Whisper encoder / KV-cached decoder as nn.Modules, the serving
             part of the ASR model config, the JAX-params converter
  decode/    greedy decoding and the Speech2Text API
  data/      wav.scp / text readers (no JAX)
  utils/     recipe-YAML -> config resolution
  bin/       the greedy decode CLI

Only the greedy serving path is ported so far (ROADMAP.md lists the rest).
No module here imports `jax`.
"""
