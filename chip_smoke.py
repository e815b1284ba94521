#!/usr/bin/env python3
"""Drive the PyTorch port's greedy serving path, its beam-search serving
path (with CTC, LM and n-gram fusion), long-form transcription with word
timestamps, its stage-2 training path and both again on the int8 frozen trunk,
serving with int8 cross-KV, the TMECS PE recipes' serving and training,
the SEAME conformer recipe's serving (joint CTC/attention beam search
with transformer-LM fusion) and training (run_conformer.sh stages 1-5),
the W8A16 thin-row path (AGACS_W8A16 and serving-quantised checkpoints),
the ladder side network's serving and training, the SEAME recipe's
run.sh stages 0-6 through the port's CLIs, the train CLI's options
(resume, batch types, augmentation, prefetch, estimate_c, lid_ce) and its
multi-GPU training through torchrun (NCCL at one rank with ZeRO-1 and the
sharded checkpoint, 2 gloo ranks on the one card), whisper-large at
full width (K4 above K 1024, its training and greedy serving), and the
conformer at XLarge widths (heads of 128: its training and beam serving),
once on one CUDA card.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --mutants    # the kernel checks against mutants
    python3 chip_smoke.py --mutants K6 K3@48   # only the mutants so named
    python3 chip_smoke.py --splits     # K3's instances timed at each split S
    python3 chip_smoke.py --k4-turns DIR   # K4 at the whisper CTC head's
                                       # shape, DIR's tree and this one in turns
    python3 chip_smoke.py --k8q-turns DIR  # K8q at its three timed shapes,
                                       # DIR's tree and this one in turns
    python3 chip_smoke.py --k3k5-turns DIR  # K3's forms and K5 at d_head 64
                                       # and 128, DIR's tree and this one
                                       # in turns
    python3 chip_smoke.py --k3-routes  # decode_attn built, then phases 3L,
                                       # 3s past 16 queries, 3w and 53-55
    python3 chip_smoke.py --k4-ablate  # K4's split kernels with parts of
                                       # their exchange taken out, timed
    python3 chip_smoke.py --warm-turns  # serving after a full warm-up
                                       # request and a WARM_STEPS one, in
                                       # turns
    python3 chip_smoke.py --dist-worker OUT [--after FILE] ARGS  # one
                                       # torchrun rank of phase 48: the
                                       # train CLI on ARGS (once FILE
                                       # exists), its counts written to OUT

Run from (or point at) a checkout of the repository on a machine with a
CUDA card and the CUDA toolkit (nvcc). It imports nothing of JAX. Phases,
one line each, in the order they run; any failure ends the script with a
non-zero exit:

  1. device and build: the card, the nvcc builds of the eight kernel
     sources and the g++ builds of the three host libraries (native/:
     FLAC, DTW, the sclite aligner), started together, and K1's, K5's
     (every instance), K2's, K4's, K8's and K3's registers and spills;
  2. K1f (csrc/packed_flash_fwd.cu) against its plain PyTorch version at
     the encoder shapes (8, 750, 768) and (2, 1500, 768), 12 heads;
  2b. at the training shapes (16, 750, 768) and (2, 1500, 768): K1f as
     training launches it, o and its lse rows, and K1b
     (csrc/packed_flash_bwd.cu): dq, dk, dv, each against its plain
     version;
  3. K3 (csrc/decode_attn.cu, each (head, row) split over a cluster of S
     blocks, `decode_attn.time_splits`) against its plain version at the
     greedy decode shapes: self (8, 112, 768) at pos 0/4/57/103, cross
     (8, 752, 768) at pos 749, the conformer decoder's (80, 112, 256), and
     the split's edges (K3_CASES: empty blocks, either side of a chunk
     edge, S at its largest); then the plain rows at d_head 32, 36, 44, 128
     and 256 (K3W_CASES, the XLarge decoder's (80, 112, 1024) timed); every
     K3 phase calls each kernel twice and
     requires bit-identical outputs, and times SDPA beside K3, K3@48,
     K3-int8 and K3s both masked over the whole cache and on the key slice
     k[:, :pos+1] unmasked (the flash backend), library_ms the faster;
  3a. K3a (decode_attn.cu, the ancestry rows) against its plain version
     at the beam self-attention shapes (40, 112, 768), beam 5, pos
     4/57/103, and the full decoder context (10, 448, 768) at pos 447,
     with an ancestry map drawn like a beam run and poisoned cache
     entries (past pos, and every entry the map does not select);
  3s. K3s (decode_attn.cu, the shared cross-KV, on mma.sync in tiles of 16
     queries) against its plain version at (8 groups x 5, 752, 768), pos
     749, and the split's edges, S = 1 and 16 queries a group; then (after
     3d) at beams 17, 20 and 32 over (8, 1504, 768), bf16 and int8 (two
     balanced query tiles a group; beam 20 timed), and at d_head 128, 192
     and 256 (64-channel sub-rows) at beams 5 and 20 (int8 at 128, beam 5
     timed), K3s at beam 5 over (8, 18016, 768) in blocks of 6006 keys,
     and K3a at phase 53's (160, 448, 768), beam 20;
  3L. K3's long route (decode_attn.cu `decode_attn_long_kernel`: a
     block's keys in passes with JAX's online-softmax carry, the
     counterpart of `_call_chunked`) against
     `decode_cache_attention_chunked_ref` (K3L_CASES): phase 54's calls,
     the conformer decoder's bf16 rows at (10, 65616, 256), 4 heads, pos
     8185 / 8191 / 8192 / 8200 and the LM's float32 rows at (10, 65616,
     512), 8 heads, pos 8200, in passes of PASS_KEYS (both timed); as
     extra shapes in tables and passes of 1024 the same rows over 8256
     positions (timed, and beside them the short route at the same
     shape), K3a at (40, 4608, 768), beam 5, K3-PE at (8, 8256, 768); bf16
     rows at (10, 65536, 256), pos 65535, in tables and passes of 4096
     (timed, the short route beside it); K3a-PE in passes of 64, K3-int8 at S = 1 and K3s's groups one query
     a block; the timed ones beside SDPA on the key slice and the bytes
     bound; keys past pos poisoned, bit-identical twice, one launch a
     call;
  3w. the whisper-only forms (K3a, K3-PE, K3a-PE, K3-int8, K3a-int8) at
     d_head 32, 48, 128 and 256 on the runtime-width forms entry
     (`decode_attn_forms_fwd`; d_head 128 timed), then on the long route
     the plain rows at d_head 320 and 512 (heads in 256-wide pieces, bf16
     and float32), an odd width (33), K3a at 36, float32 K3a-PE and K3s at
     d_head 96 (int8) and in float32 (one query a block); the long route
     timed in one pass beside each form at d_head 128; the short route at
     the edge of its table (K3W_SHORT: K3a at d_head 128 on (10, 448,
     768), K3a over 4096 keys, K3-PE and K3-f32 over 8192 in one block);
  3p. K3-PE and K3a-PE (decode_attn.cu, the gated dual-QK scores) against
     their plain version at (8, 112, 768) and (40, 112, 768), beam 5, and
     (10, 448, 768) at pos 447: distinct per-head gates with 0 and 1,
     poisoned k, k_cs and v; SDPA on [q|q_cs], [k|k_cs] timed beside them;
  3q. K3-int8 (8, 768, 768) at pos 749 and 0, K3s-int8 (8 x 5, 768, 768)
     and K3a-int8 (40, 128, 768), and the split's edges (K3I8_CASES),
     against the kernel-folding plain version,
     and within 5e-2 x max of the attention over the unquantised caches;
     SDPA on the dequantised caches timed beside them;
  2i. K8q (rowquant) and K8g (int8_gemm, forward and dgrad;
     csrc/int8_gemm.cu) against their plain versions at (12000, 768) ->
     768, 1536 and 2304, (528, 768) -> 768 (the wide kernel, the forward
     on the kept w_q^T), (8, 768) -> 3072, (8, 3072) -> 768, (8, 768) ->
     768, (40, 768) -> 768 and (64, 768) -> 768 (`thin_matmul`, K8q
     folded into the thin K8g): no element may differ from the plain
     version, two calls after an L2 eviction bit-identical, one device
     launch a call, the wide
     kernel's rows past M untouched; timed beside them: torch._int_mm +
     the dequant (M > 16), and at the thin shapes cuBLAS on the
     dequantised bf16 weight; then K8q alone at K8Q_SHAPES ((12000, 768 /
     1280 / 5120), (12000, 5120) with the dgrad's column scale, a ragged, an
     unaligned and a past-the-registers shape, float32 with the column
     scale): identical to plain, bit-identical twice, one launch a call,
     the first four timed against the bound;
  2j. K2f and K2b (csrc/int8_mlp.cu) against their plain versions at
     (12000, 768, 3072), (6000, 768, 3072) (int8 serving's encode),
     (528, 768, 3072), 1000 rows (a partial tile), whisper-base's
     (6000, 512, 2048) and whisper-tiny's (1000, 384, 1536): after the L2
     is evicted two calls bit-identical, one device launch a call, no
     element different from the plain version;
     cuBLAS `torch._int_mm` on the same int8 products (K2f's two, K2b's
     three) timed beside;
  2r. K5 (csrc/relpos_flash.cu) against its plain version at the conformer
     encoder's (8, 468, 256), 4 heads, and at T 64, 67, 128, 129, 257 and
     640, keys and values poisoned past each row's length, and at d_head
     32, 128 and the padded 48 and 96 (K5_WIDTHS) at (8, 468), T 67 and
     257, and on the wide route (K5_WIDE: d_head 160, 256 at 4 heads and
     at 1, 384, 512, 1024) at T 67 and 257, (8, 468, 1024) with 4 heads
     and (16, 468, 256) with 1; bit-identical twice, one launch a call;
     SDPA with the shifted position scores as its materialised (B, h, T,
     T) bias timed beside, and the whole PyTorch route (that bias built,
     then SDPA), at d 256 with 4 and 8 heads, d 1024 with 8 and the two
     timed wide shapes;
  2s. K5's backward (relpos_flash.cu) against its plain version at the
     training shape (16, 468, 256), 4 heads, the same T, K5_WIDTHS and
     K5_WIDE, keys and values poisoned: dqu, dqv, dk, dv, dpe, and a
     second run bit-identical in dqu, dqv, dk, dv; SDPA's backward with
     the bias requiring a gradient timed beside;
  2v. K4 (csrc/vocab_lse.cu: forward, dx, dw) against its plain version at
     the CTC head's (7488, 256) x (256, 51865) and the ragged (700, 256) x
     (256, 5000), (300, 128) x (128, 1001), (300, 384) x (384, 1001),
     (700, 512) x (512, 5000), (200, 640) x (640, 1001), (700, 768) x
     (768, 5000), (300, 896) x (896, 2000), (300, 1024) x (1024, 1001) and
     (60, 128) x (128, 500) (one V tile a rank) (the forward: whole W tiles
     at K <= 256, 64 x 64 chunks above; dx and dw: the wgmma kernels at K
     <= 256, the split kernels on clusters of K / 128 above: every cluster
     size from 3 to 8), with b, lse and g NaN past their ends and lse, dx
     and dw bit-identical on a second run; then the whisper CTC head's
     (12000, 768) x (768, 51865), each pass against its plain version;
     cuBLAS with the logits materialised timed beside, at the training
     shape and the whisper CTC head's;
  3f. K3-f32 (decode_attn.cu, float32 caches) against its plain version at
     the LM's beam shape (80, 112, 512), 8 heads, pos 103, within 1e-4, and
     its rows at phase 3's other widths;
  2w. K6 (csrc/w8a16.cu, the W8A16 thin-row matmul) against its plain
     version at (768 -> 768), (768 -> 3072), (3072 -> 768) and the padded
     logits head (768 -> 52224), rows 1, 5, 8 and 32 (the head also 40):
     1e-2 x max |plain|,
     and elementwise K6_ELEM, two calls bit-identical, one device launch a
     call, the tiling (BN, S) the rule chose; cuBLAS on the pre-dequantised
     bf16 weight and K8's `thin_matmul` timed beside it, with its bytes
     bound;
  3d. K3 at d_head 48 (decode_attn.cu, the side ladder's width) against its
     plain version at (8, 112, 192), 4 heads, pos 0/57/103 and (40, 112,
     192) pos 103, keys past pos poisoned, and the cross shape (8, 752,
     192) at pos 749 (S 8) and 0, 93, 94; SDPA timed beside it;
  4. the greedy slice: whisper-small with adapters in both stacks (the
     stage-2 recipe's flags), bf16, random weights from torch seed 0,
     Speech2Text on 8 x 15 s of seeded noise, 100 greedy steps; ms per
     batch, x realtime, and the launch counts of both kernels in that run;
  5. the card (bf16) against the port on the CPU (float32) on the same
     weights, one utterance: encoder output and first-step logits;
  6. torch.profiler over one more warm request of phase 4: device busy
     time, device events per decode step, the device's idle share of
     phase 4's ms per batch, K3's device time, and the kernels that take
     the most time;
  10. the beam slice (bench.py's beam5_8x15s row): Speech2Text(beam_size=5,
     max_steps=100, loop="scan") on phase 4's model and audio; ms per
     batch, x realtime, peak memory, exact K1f/K3/K3a/K3s launch counts;
  11. torch.profiler over one more beam request: device busy time, idle
     share, K3a's and K3s's device time, the top kernels;
  12. beam end to end: each returned hypothesis rescored teacher-forced
     (the card in bf16 with the plain attention, and utterance 0 on the
     CPU in float32) against the score the search reported, beside a
     control search with every decode attention in its plain version;
     and the same search with the caches gathered physically (K3 plain
     rows instead of K3a) gives the same hypotheses;
  7. the training path (the stage-2 recipe's step, the shape of bench.py's
     bf16 row): whisper-small + adapters, bf16 frozen trunk, float32
     adapters, preset `adapter`, cs_weight 0.01, SpecAug on, AdamW with
     WarmupLR 500, clip 1.0, on 16 x 15 s of seeded noise with 32-id texts;
     one warm-up step, then 5 timed optimizer steps: ms per step,
     audio-seconds per second, peak memory, exact K1f/K1b launch counts,
     finite losses, the frozen trunk bit-identical, every adapter changed;
  8. torch.profiler over one more train step: device busy time, idle
     share, the top kernels and K1b's share;
  9. one micro-step on one utterance, the card (bf16) against the port on
     the CPU (float32), same weights, SpecAug off: loss, loss_cs, the
     global gradient norm, and the cosines of the encoder's and the
     decoder's adapter gradients; beside it a bf16 control, the same step
     on the card with the encoder's attention in its plain version;
  13. phase 7's step with the frozen trunk quantised to int8 after the bf16
     cast (`freeze_quant: int8`): ms per step, audio-s/s and peak memory
     beside phase 7's (and the bytes of the int8 weights kept transposed
     for K8g and K2), exact K2f/K2b/K8 launch counts per micro-step
     (`int8_train_launches`), the int8 buffers bit-identical, adapters changed;
  14. torch.profiler over one more int8 step: busy, idle share, the K2 and
     K8 shares, the top kernels;
  15. one int8 micro-step on one utterance, card (bf16, kernels) against
     the CPU (float32, plain versions) on the same int8 weights, beside a
     card control with the int8 plain versions;
  16. greedy Speech2Text (8 x 15 s, 100 steps) on the int8 trunk: ms per
     batch, x realtime, exact launch counts (the decode steps' 8-row
     products one `thin_matmul` launch each, K8q only before the wide
     products), first-step logits card bf16 against CPU float32, and one
     more request under torch.profiler (K8g's, its thin kernel's and K8q's
     device ms, one device event a K8g or K8q call);
  17. the CLIs on the card: `bin.train --override freeze_quant=int8` (the
     stage-2 recipe, whisper-small, one epoch) on a generated data dir
     under build/, then `bin.decode` on its n-best average: an int8
     checkpoint, hypotheses for every utterance, K2f and K8g launched by
     both;
  18. (run right after 12, on phase 4's model) `cross_kv_int8`: greedy
     (exact K3 1248, K3-int8 1248) and beam 5 (K3a 1248, K3s-int8 1248),
     the int8 buffers bit-identical to the plain quantisation, first-step
     logits against the bf16 cross-KV, token agreement, and ms/batch
     alternating with the bf16 cross-KV;
  19. a PE decoder (the TMECS pedecoder layout), whisper-small, bf16:
     greedy (exact K3-PE 1248, K3 1248) and beam 5 (K3a-PE 1248, K3s
     1248), first-step logits card bf16 against CPU float32;
  20. phase 12's checks on its beam request (physical gather on K3-PE);
  21. the TMECS cs_loss_pe step (PE in both stacks, `whisper_pe`), 16 x
     15 s, bf16 with every frozen leaf stored bf16: ms per step, audio-s/s,
     peak memory, only query_cs / key_cs changed, the frozen gates
     bit-identical; 22. its profile; 23. one micro-step card bf16 against
     CPU float32 (loss, loss_cs, grad norm, the *_cs gradient cosines);
  24. `bin.train` on the TMECS pedecoder_csloss recipe for one epoch, then
     `bin.decode` on its average, greedy and with `--cross_kv_int8`;
  25. the conformer recipe's serving (run_conformer.sh stage 4 with
     decode_asr.yaml) at full width: conformer 12 x 256 bf16, decoder 6
     blocks, LM 16 x 512 float32, vocabulary 51865, random weights, beam 10,
     ctc 0.4, lm 0.2, 100 steps, on 8 x 15 s: ms per batch (one request), exact launches
     (K5 12 per encode, K3 600, K3-f32 1600), the CTC prefix scoring's share;
  26. the same request at 5 steps under torch.profiler: busy, idle share,
     the K5 / K3 / K3-f32 shares and the top kernels;
  27. card vs CPU float32 on the same weights: the encoder output and the
     first joint step's scores over the pre-beam candidates;
  28a. the recipe's stages 1-5 through the CLIs on generated wavs:
     `bin.collect_stats`, `bin.lm_train` (2 blocks, one epoch), `bin.train`
     with train_asr_conformer.yaml (2 + 2 blocks, one epoch: K5 and K4 both
     ways), `bin.decode` on its average with the stage-2 LM, `bin.score`;
  28. `bin.decode` with train_asr_conformer.yaml, a .params.npz, decode_asr.yaml
     and an LM exp dir (4 blocks), then `bin.score --per_bucket` (stage 5);
  29. the conformer recipe's training step at full width (12 blocks, decoder
     6, vocabulary 51865, ctc 0.3, Adam, WarmupLR, clip 5, SpecAug, dropout)
     on 16 x 15 s a step: ms per step, audio-s/s, peak memory, exact launches
     (K5 12 + 12 backward, K4 1 + dx 1 + dw 1 per step), the CTC lattice's
     share; 30. one more step under torch.profiler;
  31. one micro-step on one utterance, card bf16 against CPU float32 (loss,
     loss_ctc, grad norm, encoder / decoder / CTC-head gradient cosines),
     beside a bf16 control with K5's and K4's plain versions;
  32. (right after 16, on its int8 trunk) greedy under AGACS_W8A16=1: ms
     per batch, exact launches (K6 8 x 12 per step, K8g only in the
     encoder and the cross-KV), token agreement with phase 16 (reported:
     W8A16 and W8A8 differ), first-step logits card against CPU float32
     (K6's plain version there), and K6's profile share beside phase 16's
     K8g, its device events one a K6 call;
  33. `quantize_for_serving` of phase 4's weights: greedy and beam 5 with
     and without AGACS_W8A16, exact launches (the logits head's K6 once a
     step, every trunk product on K6 or K8 by the rule), greedy and beam 5
     without the variable under the profiler (K6's and the thin K8g's
     device ms, one device event a call), first-step logits card against
     CPU float32;
  34. the ladder side network (whisper-small + the default ladder: n_dim
     192, 4 heads, taps 0, 2, ..., 10), bf16: greedy and beam 5 with exact
     launches (K3 at d_head 48 12 a step, trunk K3 24, no K3a or K3s), a
     greedy request under torch.profiler (K3@48's and the trunk K3's
     device time),
     first-step logits card against CPU float32, beam scores against
     teacher-forced rescoring;
  35. the `sidenetwork` training step at 16 x 15 s: ms per step (median of
     3 after a warm-up), peak memory, idle share, K1f 12 and K1b 0 a step,
     the trunk bit-identical; one micro-step card bf16 against CPU float32
     (loss, grad norm, the side ladders' gradient cosines);
  36. the TMECS full fine-tune recipe (train_asr_whisper_small.yaml, no
     freeze preset) with ctc_weight 0.3: whisper-small at full depth and
     its CTC head (768 -> 51865; K4 at (12000, 768) x (768, 51865)) on 16
     x 15 s a step: ms per step (median of 3 after a warm-up), exact
     launches (K4 1 + dx 1 + dw 1 per step); 37. one more step under
     torch.profiler: busy, idle share, K4's device ms by pass;
  38. one micro-step on one utterance, card bf16 against CPU float32:
     loss_ctc and the CTC head's gradient cosine within phase 31's bounds,
     beside a bf16 control with K4's plain version;
  39. recipes/seame/run.sh stages 0-6 through the port's CLIs at
     whisper-small's full width, on a SEAME-layout corpus generated from a
     seed (`seame_corpus`: three 8 s FLAC recordings, phaseII transcripts,
     a dev-set repo) and a random-weight whisper-small `.pt` in OpenAI's
     layout (the port's init at seed 0, float16): `prepare_seame`,
     `format_data --audio_format flac.ark` per split, `perturb_data_dir`,
     `bin.train` stage 1 (adapter_encoder, `--init_param` the .pt) and
     stage 2 (csloss_2stage, from stage 1's average), `bin.decode` greedy
     and `bin.score` on devman and devsge, `bin.pack pack` and `unpack`:
     every leaf of the .pt loaded, the ark waveforms bit-identical to the
     plain Python FLAC decoder's, K1f and K1b launched in both trainings and
     K3 in decoding, a hypothesis for every dev utterance, finite losses,
     and the unpacked archive naming the config and model decode read;
  40. the train CLI's options at whisper-small's full width on the stage-2
     recipe, over the same generated corpus (flac.ark train and valid
     dirs): (a) on the int8 trunk, a 2-epoch run against a 1-epoch run
     resumed (`--resume`) to epoch 2: checkpoint.params.npz,
     checkpoint.opt.npz, the meta's step and generator, and the history
     (times apart) bit-identical, and the same K1f / K1b / K2f / K2b / K8
     launches in each; (b) one bf16 epoch with every option on
     (`--batch_type folded`, RIR and noise augmentation from seeded WAVs,
     `estimate_c`, `--num_att_plot 1`, the batch prefetch): finite losses,
     the TensorBoard event file reading back the history's scalars,
     `estimated_c_val` moved from 0.6; then one `lid_ce` epoch; (c) the
     bf16 step over the corpus's batches with the prefetch on and off, in
     turns: wall ms a step, device busy ms a step and the idle share;
  41-45. the transducer family (train_asr_transducer.yaml at full width:
     conformer 12 x 256, LSTM 1 x 320, joint 320, vocabulary 51865,
     ctc_weight 0.3; random weights from torch seed 0): (41) K4 at the
     joint's K 320, padded to 384 in the wrapper, against its plain
     versions at (4096, 320) x (320, 51865) with b and g NaN past their
     ends, timed on a 32,768-row slice beside the plain version and cuBLAS +
     logsumexp, and alone at the step's N = 16 x 468 x 41; (42) the step at
     16 x 15 s with 40 labels a row, exact launches (K5 12 + 12, K4 2 + 2 +
     2: the joint's and the CTC head's), the profiled step's device events by
     kernel, peak memory well under the 63.7 GB dense lattice's; (43) a
     micro-step card bf16 vs CPU f32 (loss_transducer, loss_ctc, the
     encoder's, LSTM's and joint's gradient cosines, phase 31's rule); (44)
     decoding 8 x 15 s: greedy, TSD and ALSD at beam 4 batched, default /
     NSC / mAES at beam 4 on one utterance's first 60 frames, with the CPU's
     tokens beside; (45) `bin.train` on the recipe for one epoch over the
     corpus's flac.ark dirs, then `bin.decode` greedy and with every
     `--transducer_search`;
  46. the whisper family's fused beam at full width: whisper-small bf16
     with a CTC head, Speech2Text at beam 5, 24 steps, ctc 0.3, a float32
     LM (2 x 512) at 0.3 and an n-gram trained by `bin.ngram_train` on a
     generated text at 0.3, on phase 4's 8 x 15 s: ms per batch, launches
     (K1f, K3a, K3s, K3-f32 above zero), two requests with the same tokens,
     the CTC prefix scoring's share, busy and idle share under the
     profiler, one step's n-gram scores over 40 x 51865 candidates equal to
     the CPU's element for element, and two CTC prefix steps' increments
     against CPU float32 on the same log-probs;
  47. `bin.transcribe --long_form --word_timestamps` on a generated 45 s
     wav (whisper-small bf16, a .params.npz under build/): at least two
     windows, every window's tokens under the timestamp rules (1-4 by
     token, all five on a replay through the cached step), segment and
     word times never decreasing, the DTW library built, K1f and K3
     launched; ms per window.
  48. (its launches start before phase 46 and run beside 46-47)
     multi-GPU training through torchrun (`python -m
     torch.distributed.run --standalone`) at whisper-small's full width,
     stage-2 recipe, bf16, on phase 40's kind of data, beside the plain
     CLI's 2 epochs on the same data in this process: (a) one rank over
     NCCL with --optim_state_shard --ckpt_backend orbax, 1 epoch then
     --resume to 2, its history against the plain run's (bound
     DIST_SAME_RTOL); (b) 2 ranks on the one card over gloo, data
     parallel, 1 epoch, loss and acc against (a)'s (DIST_BOUNDS); (c) the
     int8 trunk at one rank, 1 epoch; (d) rank 0's profiled step in (a)
     and (c): K1f/K1b (and K2f/K2b/K8) device events against its launches;
     (e) each rank's peak memory and step time.
  49. whisper-large (d 1280, 20 heads, 32 + 32 layers, vocabulary 51865) at
     full width on random weights made on the card from a torch seed:
     (a) K4 above K 1024 (the split dx and dw on a non-portable cluster of
     9 or 10) at the CTC head's (12000, 1280) x (1280, 51865), a ragged K
     1200 and K 1152 against the plain versions (phase 2v's bounds, NaN
     past the ends, bit-identical twice, one launch a call), the clusters
     the card holds, timed beside plain, cuBLAS with the logits and the
     bound; K1f / K1b, K3 and K8 (wide and `thin_matmul`) at its shapes;
     (b) the stage-2 step at 16 x 15 s, bf16 then int8 trunk (its MLPs
     unfused, as JAX's budget rules); (c) the TMECS CTC full fine-tune
     (K4 at K 1280, AdamW over 1.55B parameters); (d) greedy serving
     (decode_asr_whisper.yaml) at 8 x 15 s, 100 steps, bf16 then int8
     trunk; each with ms, peak memory and exact launch counts (busy and
     idle share for (b) and (c); (d)'s profiles are cut for the script's
     time); (e) the card in bf16 against the CPU in float32 at full width
     on 2 + 2 layers: encoder, first-step logits, and a CTC micro-step.
  50. the conformer at NeMo's XLarge widths (d 1024, 8 heads of 128, units
     4096; its 24 encoder blocks cut to 12, + 6) on the recipe's config:
     (a) the train step at 16 x 15 s (K5 12 + 12 launches a step at its
     128 instance, K4 at K 1024), ms, busy, idle share, peak memory; (b) a
     beam-10 request with
     the recipe's LM (K3's rows at d_head 128); (c) card bf16 against CPU
     f32 at 2 + 2 blocks with phases 27's and 31's bounds.
  51. the recipe's conformer (d 256, 12 + 6 blocks) with one encoder head
     of 256 (encoder_conf.attention_heads 1), so K5 runs its wide route:
     (a) the train step at 16 x 15 s (K5 12 + 12 launches a step), ms,
     busy, idle share, peak memory, finite losses and gradients; (b) a
     beam-10 request with the recipe's LM, 8 finite hypotheses, K5 12 an
     encode; (c) card bf16 against CPU f32 at 2 + 1 blocks with phases
     27's and 31's bounds.
  52. the conformer at Google USM-2B's widths (d 1536, 16 heads of 96,
     units 6144; its 32 encoder blocks cut to 24, the deepest whose step
     fits the card with ~10% free; 6 decoder blocks) on the recipe's
     config, so the CTC head runs K4 at K 1536 (KS-256 slices on clusters
     of 6) and K5 its 128 instance on padded heads of 96: (a)-(c) as phase
     51's, the step's peak memory held to 90% of the card.
  53. (after phase 12) whisper-small's beam-20 serving: Speech2Text at
     beam 20 with the decode YAML's maxlenratio 0 (a 448-position self
     cache, up to 442 steps) on phase 4's model and audio: one timed
     request after a warm-up, K3a and K3s 12 launches a step exactly, its
     device busy and idle shares, and the hypotheses rescored on the card
     and (utterance 0) on the CPU in float32 with phase 12's bounds;
  54. the long route on its path: the conformer recipe's decoder (6
     blocks, bf16) and LM (16 blocks, float32) one step at a time at pos
     8185-8200 over 10 rows whose caches hold 65616 positions (as
     `joint_beam_decode` sizes them for 65600 steps: blocks of 8202 and
     9374 keys, past the short route's table of 8192), rows 0-8184 drawn
     on the card: 6 + 16 long-route launches a step exactly; 2 + 2 blocks against the CPU in float32 on the same
     caches;
  55. a whisper decoder at whisper-small's width with 6 heads of 128, PE
     and int8 cross-KV, 5 steps at beam 5: K3a-PE on the forms entry and
     K3s-int8 on the tensor cores at d_head 128, 12 launches a step each,
     logits card bf16 against CPU float32 each step.

The last three lines are the card's `name, power.limit` (nvidia-smi), a
JSON line with each kernel's launches, error and times, and the
`{"ok": true, "device": ...}` line.

`--mutants` builds each MUTANTS entry (an edit of one csrc/ source) outside
the checkout and runs the checks it names, the unmutated source first (a
mutant that traps its kernel ends the process's CUDA use: the chosen
mutants after it run in a new process);
`--k8q-turns DIR` times K8q the same way at its three timed shapes, and
`--k3k5-turns DIR` K3's forms (K3s among them) and K5 at d_head 64 and 128
(K3K5_TURN_CASES, K3K5_TURN_K5);
`--splits` times K3's instances at every S from 1 to 8 (SPLIT_SWEEP), the
reading `decode_attn.time_splits` was tuned on; `--k4-turns DIR` times K4's
three passes at the whisper CTC head's shape (`k4_times`) in the checkout
at DIR (e.g. a `git archive` of an earlier commit) and in this one, one
process each, in turns (DIR, this, this, DIR); `--k4-ablate` times the
split kernels at that shape with parts of their exchange, or the whole
exchange, taken out, or with a part's bytes cut (K4_ABLATIONS);
`--warm-turns` times phase 4's model serving beam and greedy requests
after a warm-up request of 100 steps and of WARM_STEPS, one process each,
in turns (100, WARM_STEPS, WARM_STEPS, 100), with a second timed request
in each as a control.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import functools
import io
import json
import os
import re
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
# K1b's dq, dk, dv: each a sum over up to 1500 products of ds (rounded to
# bf16, 2^-9 relative) with k or q, and dv over p (bf16) times do. ds has
# mixed signs, so the sums are smaller than their terms and the rounding
# error is a larger share of max |plain| than in the forward: 2e-2.
K1B_RTOL = 2e-2
# K1f's lse rows, against the plain f32 log-sum-exp of the same bf16 q, k:
# both sum exact bf16 products in f32, so they differ by summation order
# and expf/logf rounding, ~1e-5 at |lse| ~ 10. An lse off by x scales
# every p the backward recomputes by e^-x; 1e-3 holds that to 0.1%, 20x
# inside K1B_RTOL (KERNEL_RTOL x max |lse| would allow ~0.1, a 10% scale).
LSE_ATOL = 1e-3
# K1's tail shapes in phases 2 and 2b, under the same bounds: one ragged
# 64-row tile (37), exactly one (64), one row past a 128-row tile (129),
# and the CLI phases' utterances (200); at B = 2. K1_DEEP runs once more
# with q and k means of -4 and +4 and a std of 0.5: every score of a row
# sits near -128 (std ~2.8), so exp(-lse) overflows float32 and a key past
# T that a kernel failed to mask (TMA fills it with zeros, so it scores 0)
# would carry an infinite or dominant weight.
K1_TAILS = ((2, 37), (2, 64), (2, 129), (2, 200))
K1_DEEP = (2, 129)
K1_DEEP_QK = {"shift": 4.0, "std": 0.5}
# card (bf16 weights and activations) vs CPU (float32): bf16 rounding
# (~4e-3 relative per op) accumulated through 12 residual layers.
ENC_REL_L2 = 5e-2
LOGITS_REL_L2 = 5e-2
# Train parity, card bf16 vs CPU float32, one utterance: relative errors
# of the loss, loss_cs and the global gradient norm, and the cosines of
# the encoder adapters' gradients (the only ones that pass through K1b)
# and the decoder adapters', each on its own. Both runs are seeded and
# deterministic. Each bound sits 2-8x outside the bf16 noise of the
# kernel run and of the bf16 control (the encoder's attention in its
# plain version under torch autograd), which read on the H100: loss 6.0e-5
# and 1.2e-6, loss_cs 5.2e-4 and 8.2e-5, grad norm 2.2e-3 and 1.2e-3,
# 1 - cos_enc 8.5e-5 and 8.8e-5, 1 - cos_dec 1.4e-4 both. K1b mutants
# without the D term or the last partial q tile's dk/dv, and a K1f lse in
# log2 units, read 1 - cos_enc 2.1e-2, 1.2e-3, 0.19 and grad norm 8.8e-3,
# 1.5e-2, 9.9e-2. With random weights the softmax is nearly flat and
# little gradient passes through dq and dk, so phase 2b, not this phase,
# is what holds them (PERF.md, Findings).
TRAIN_REL = {"loss": 5e-4, "loss_cs": 2e-3, "grad_norm": 5e-3}
TRAIN_COS = {"cos_enc": 0.9995, "cos_dec": 0.9995}
TRAIN_B, TRAIN_S, TRAIN_STEPS = 16, 15, 5
BEAM = 5
PROFILE_TRIES = 3  # profiles of a run whose device events must match its launches
# short sleep kernels that open every profile (not tallied): on some hosts
# the first device records of a profile went missing (a lone K6 call's, or
# the lead-in's own)
LEAD_IN_SPINS = 4
# Phase 12: a beam hypothesis's reported score against its teacher-forced
# rescoring (sum of the searched tokens' log-softmax values plus the length
# bonus), relative to |score|, max over the 8 utterances (card, bf16) and
# for utterance 0 (CPU, float32). On the H100 the kernel run read 2.0e-4
# and 2.6e-4 (card), 2.9e-4 and 3.4e-5 (CPU); the control search with
# plain decode attention 1.7e-4 (card). A K3a that reads each row's own
# cache instead of the ancestry row read 2.7e-2 (card) and 1.3e-2 (CPU):
# with random weights the self-attention is nearly flat, so a wrong row
# moves the scores by about 1%, not more (PERF.md, Findings).
RESCORE_REL = {"card": 2e-3, "cpu": 2e-3}
# The int8 kernels (K8q/K8g, K2f/K2b) against their plain versions
# evaluated in float32 on the same bf16 inputs and int8 weights: the int32
# sums are exact on both sides and the kernels repeat the plain versions'
# float32 operations in order, so what remains is the bf16 rounding of the
# output (2^-9 relative) and, in K2, a hidden value that an ulp of exp
# moves across a rounding boundary (one int8 step of one hidden value, a
# few 1e-4 of the largest output): KERNEL_RTOL of max |plain|.


def int8_train_launches(cfg) -> dict:
    """The int8 step's launches per micro-step (phases 13 and 49), derived
    from which inputs need a gradient; whisper-small: K2f 24, K2b 24, K8g
    84, K8g dgrad 80, K8q 164. Forward: the encoder's fused q/k/v and out
    per layer and the decoder's fused self q/k/v, self out, cross q, fused
    cross k/v and cross out per layer, as JAX's `mha` fuses them
    (`fused_linears`); the MLPs run K2f (12000 and 16 x 33 = 528 rows, both
    >= 256), or, where JAX's budget (`int8_mlp.supports`) excludes them
    (whisper-medium and -large), fc1 and fc2 as two int8 linears. Dgrad:
    nothing upstream of encoder layer 0's and decoder layer 0's
    self-attention trains, so those take none: encoder layers 1-11 x 2,
    decoder layer 0's cross q, k/v and out (3; the encoder output takes a
    gradient through its adapters), decoder layers 1-11 x 5; every MLP's
    input trains (K2b, or fc2's and fc1's dgrad). Each K8g call quantises
    its input first (K8q)."""
    from agacs_tpu_torch.ops import int8_mlp

    la, lt = cfg.n_audio_layer, cfg.n_text_layer
    fused = int8_mlp.supports(cfg.n_audio_state, 4 * cfg.n_audio_state)
    mlp = 0 if fused else 2
    fwd = (2 + mlp) * la + (5 + mlp) * lt
    dgrad = 2 * (la - 1) + 3 + 5 * (lt - 1) + mlp * (la + lt)
    k2 = (la + lt) if fused else 0
    return {"K2f": k2, "K2b": k2, "K8g": fwd, "K8g dgrad": dgrad, "K8q": fwd + dgrad}


# Phase 15 (int8 train parity, card bf16 kernels vs CPU f32 plain
# versions, same int8 weights) and phase 16 (int8 first-step logits, rel
# L2): bounds set from the H100 readings (PERF.md, Findings).
# First reading (H100, kernels): loss 2.5e-4, loss_cs 8.5e-4, grad norm
# 9.9e-4, 1 - cos_enc 1.9e-4, 1 - cos_dec 3.5e-4, the control with the
# plain versions identical (the kernels match them bit for bit); logits
# 2.6e-2 (int8 rounding of bf16 activations that differ from the CPU's
# float32 ones).
INT8_TRAIN_REL = {"loss": 2e-3, "loss_cs": 5e-3, "grad_norm": 5e-3}
INT8_TRAIN_COS = {"cos_enc": 0.999, "cos_dec": 0.999}
INT8_LOGITS_REL_L2 = 5e-2
# Published H100 SXM peaks (NVIDIA's datasheet, dense): the bound of a
# kernel is the larger of its bytes over HBM's rate and its operations over
# the peak rate of their type.
# The int8 decode kernels against the attention over the unquantised bf16
# caches they were quantised from (JAX tests/test_decode_attn.py:209-213).
INT8_VS_BF16 = 5e-2
# Phase 18: first-step logits with the int8 cross-KV against the bf16
# cross-KV on the card, rel L2: one int8 step (1/254 of a channel's range)
# on every cross K/V, through 12 layers.
INT8_CROSS_LOGITS_REL_L2 = 5e-2
# Phase 23 (PE train parity, card bf16 vs CPU f32): phase 9's bounds, the
# cosines over the query_cs / key_cs gradients of each stack.
PE_TRAIN_REL = dict(TRAIN_REL)
PE_TRAIN_COS = dict(TRAIN_COS)
# K6 against its plain version, element by element: both sum the same exact
# products of bf16 values in float32 (in another order) and round to bf16
# once, so an element moves by its output rounding (2^-9 of itself) plus
# the summation order (~1e-6 of the largest output): 2^-8 |plain| + 1e-4 x
# max |plain|. Folding w_s in after the sum rounds other weights (each
# bf16(w_q · w_s) is off by up to 2^-9 of itself) and moves elements whose
# sum cancels past that bound.
K6_SHAPES = ((768, 768), (768, 3072), (3072, 768), (768, 52224))
# Phase 2i's (rows, d_in, d_out): the int8 train step's wide products (the
# wide K8g): the encoder's out (12000, 768) -> 768 (the kernels line reads
# it), the cross k/v -> 1536 and the fused q/k/v -> 2304, the teacher-forced
# decoder's 528 rows; and a decode step's (`thin_matmul`): greedy's 8 rows
# and beam 5's 40, and the 64 rows of its widest instance (eight row
# tiles); the kernels line's thin entry at K8_THIN_ENTRY.
K8_SHAPES = ((12000, 768, 768), (12000, 768, 1536), (12000, 768, 2304), (528, 768, 768),
             (8, 768, 3072), (8, 3072, 768), (8, 768, 768), (40, 768, 768), (64, 768, 768))
K8_THIN_ENTRY = (8, 768, 768)
# Phase 2j's (rows, d, h): the int8 trunk's training encoder (16 x 15 s),
# its serving encode (8 x 15 s), the teacher-forced decoder's 16 x 33 rows,
# 1000 rows (not a multiple of the kernels' 64-row tile), whisper-base's
# encoder at 8 x 15 s (cluster of 8, 2 units a rank) and whisper-tiny's
# MLP (cluster of 4, 3 units a rank); the kernels line reads the first.
K2_SHAPES = ((12000, D, 4 * D), (6000, D, 4 * D), (528, D, 4 * D), (1000, D, 4 * D),
             (6000, 512, 2048), (1000, 384, 1536))
K6_ROWS = (1, 5, 8, 32)
K6_HEAD_BEAM = 40  # the logits head's rows at beam 5 (a serving-quantised model)
K6_ELEM = (2.0 ** -8, 1e-4)
# Phases 34-35: the default ladder (SideNetworkConfig()), seed 3; the side
# micro-step's bounds, card bf16 vs CPU f32, before a reading: the ladder
# reads bf16 trunk taps from all 12 layers, so phase 15's int8 bounds
# (loss 2e-3, grad norm 5e-3, cosines 0.999) rather than phase 9's.
SIDE_SEED = 3
SIDE_TRAIN_REL = {"loss": 2e-3, "grad_norm": 5e-3}
SIDE_TRAIN_COS = {"cos_enc": 0.999, "cos_dec": 0.999}
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


# What `cuda_ms` saw over the run: its timings, those retaken call by call
# (by caller), the calls whose hold ran out even then (host gaps may be in
# their time, by caller), and the largest host time to enqueue a call
# behind a hold that outlasted it (ms, and the caller). Printed at the end.
CUDA_MS = {"timings": 0, "retaken": [], "not_held": [], "enqueue_ms": 0.0, "enqueue_by": ""}
SLEEP_CYCLES_A_MS = 2_000_000  # the SM clock's ~2 GHz: longer where it runs slower
HOLD_TRIES = 4  # a call's hold doubles up to this many times (2 ms to 16 ms)


def held_run(fn, args, hold_ms):
    """`fn(*args)` enqueued behind a sleep kernel of `hold_ms` between two
    events: (start, end, host ms to enqueue, held). Held: the start event
    was still pending once the end event was enqueued, so the events time
    the device running the calls back to back, not the host's launches."""
    torch.cuda._sleep(int(SLEEP_CYCLES_A_MS * hold_ms))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn(*args)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    return start, end, enqueue_ms, not start.query()


def cuda_ms(fn, arg_sets, iters):
    """Mean device ms per call over `iters` calls, cycling through
    `arg_sets` (distinct buffers larger than the 50 MB L2 together, so each
    call reads from HBM as in the model). A sleep kernel holds the stream
    while the host enqueues every call (2 ms a call, 10 at least). Where
    the hold ran out first (a slow host, or a plain version of many small
    kernels whose launches fill the stream's queue and block the host
    until the sleep ends), the timing is retaken call by call, each call
    behind its own hold of 2 ms, doubled up to HOLD_TRIES times until it
    outlasts the call's enqueue (`CUDA_MS` counts both)."""
    caller = sys._getframe(1).f_code.co_name
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()

    def loop(*_):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    start, end, enqueue_ms, held = held_run(loop, (), 2.0 * max(iters, 5))
    torch.cuda.synchronize()
    CUDA_MS["timings"] += 1
    if held:
        note_enqueue(enqueue_ms / iters, caller)
        return start.elapsed_time(end) / iters
    CUDA_MS["retaken"].append(caller)
    pairs = []
    for i in range(iters):
        hold_ms = 2.0
        for _ in range(HOLD_TRIES):
            start, end, enqueue_ms, held = held_run(fn, arg_sets[i % len(arg_sets)], hold_ms)
            if held:
                note_enqueue(enqueue_ms, caller)
                break
            hold_ms *= 2
        else:
            CUDA_MS["not_held"].append(caller)
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def note_enqueue(ms: float, caller: str) -> None:
    if ms > CUDA_MS["enqueue_ms"]:
        CUDA_MS["enqueue_ms"], CUDA_MS["enqueue_by"] = ms, caller


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def sharp_qkv(g, dev, q_shape, kv_shape, q_scale=1.0, shift=1.0, std=1.5):
    """bf16 q, k, v on `dev` whose softmax is sharp and shifted: q and k
    have a std of 1.5 and means of -1 and +1 per channel, so the scaled
    scores q.k/8 have a std of ~2.7 around ~-8; v is standard normal.
    `shift`, `std`: other means (-shift, +shift) and std of q and k."""
    def rnd(shape, mean, scale):
        x = torch.randn(*shape, generator=g) * scale + mean
        return x.to(dev, torch.bfloat16)
    q = (rnd(q_shape, -shift, std).float() * q_scale).to(torch.bfloat16)
    return q, rnd(kv_shape, shift, std), rnd(kv_shape, 0.0, 1.0)


def hold(name, out, plain_f32, shape) -> float:
    """max |out - plain| (raising past KERNEL_RTOL * max |plain|)."""
    torch.cuda.synchronize()
    err = (out.float() - plain_f32.float()).abs().max().item()
    bound = KERNEL_RTOL * plain_f32.float().abs().max().item()
    check(tuple(out.shape) == tuple(plain_f32.shape) and err <= bound,
          f"{name} {shape}: max_abs_err {err} <= {bound}")
    return err


def roofline(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by for a kernel moving `nbytes` and doing `ops`
    operations of type `kind`."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}


def sdpa_heads(x, h):
    """(B, T, h*64) packed -> (B, h, T, 64) view for scaled_dot_product_attention."""
    return x.unflatten(-1, (h, -1)).transpose(1, 2)


def k1_cases(big) -> list:
    """K1's cases in phases 2 and 2b, (b, t, deep): the timed shapes `big`,
    K1_TAILS, and K1_DEEP with deep inputs."""
    return [(b, t, False) for b, t in (*big, *K1_TAILS)] + [(*K1_DEEP, True)]


def k1_qkv(g, dev, b: int, t: int, deep: bool, d: int = D):
    """sharp_qkv at (b, t, d); `deep`: the K1_DEEP inputs."""
    return sharp_qkv(g, dev, (b, t, d), (b, t, d), **(K1_DEEP_QK if deep else {}))


def check_k1(dev, g, timed=True) -> dict:
    """Phase 2: K1 against its plain version at the serving shapes (8, 750)
    and (2, 1500) (timed), the tail shapes and the deep case; returns its
    err and times."""
    from agacs_tpu_torch.ops import flash_train

    big = ((8, 750), (2, 1500))
    res = {"err": 0.0}
    for b, t, deep in k1_cases(big):
        clock = timed and (b, t) in big
        sets = [(*k1_qkv(g, dev, b, t, deep), H) for _ in range(4 if clock else 1)]
        q, k, v, _ = sets[0]
        err = hold("K1", flash_train.packed_flash_mha(q, k, v, H),
                   flash_train.packed_flash_mha_ref(q.float(), k.float(),
                                                    v.float(), H), (b, t, D))
        res["err"] = max(res["err"], err)
        if not timed:
            continue
        line = (f"phase 2 K1 packed_flash_fwd ({b}, {t}, {D}) H={H}{' deep' if deep else ''}: "
                f"max_abs_err {err:.3e} (bound {KERNEL_RTOL} x max|plain f32|)")
        if clock:
            ms = cuda_ms(flash_train.packed_flash_mha, sets, 20)
            plain_ms = cuda_ms(flash_train.packed_flash_mha_ref, sets, 20)
            if t == 750:
                res.update(ms=ms, plain_ms=plain_ms)
            line += f" kernel {ms:.4f} ms plain bf16 {plain_ms:.4f} ms"
        print(line, flush=True)
    return res


def lse_ref(q, k, n_head):
    """The plain float32 log-sum-exp of every row of K1's scaled scores
    d_head**-0.5 q.k^T: (B, H, T)."""
    from agacs_tpu_torch.ops.attention import split_heads

    s2 =(q.shape[-1] // n_head) ** -0.5
    s = (split_heads(q.float() * s2, n_head)
         @ split_heads(k.float(), n_head).transpose(-1, -2))
    return torch.logsumexp(s, -1)


def check_k1_train(dev, g, timed=True, d: int = D, h: int = H,
                   big=((16, 750), (2, 1500)), phase: str = "2b") -> tuple[dict, dict]:
    """Phase 2b: K1f as the training path launches it (with the lse rows)
    and K1b, at the training shapes (16, 750, 768) and (2, 1500, 768)
    (timed), the tail shapes and the deep case (phase 49: at whisper-large's
    width `d`, `h` heads, and its `big` shapes). K1f's o is held within
    KERNEL_RTOL of its plain version and its lse within LSE_ATOL of the
    plain f32 log-sum-exp; K1b's dq, dk and dv each within K1B_RTOL x its
    own max |plain|, the kernel and the plain version reading the same bf16
    q, k, v, do and K1f's o (and lse); plain versions evaluated in float32.
    A second K1b run on the same inputs must give bit-identical dq, dk, dv.
    Returns (K1f's, K1b's) errors and times at (16, 750, 768)."""
    from agacs_tpu_torch.ops import flash_train

    fwd, res = {"err": 0.0, "lse_err": 0.0}, {"err": 0.0}
    for b, t, deep in k1_cases(big):
        clock = timed and (b, t) in big
        shape = f"({b}, {t}, {d}) H={h}{' deep' if deep else ''}"
        qkv = [k1_qkv(g, dev, b, t, deep, d) for _ in range(4 if clock else 1)]
        q, k, v = qkv[0]
        o, lse = flash_train._fwd_kernel(q, k, v, h, with_lse=True)
        err = hold("K1f", o, flash_train.packed_flash_mha_ref(
            q.float(), k.float(), v.float(), h), (b, t, d))
        lse_err = (lse - lse_ref(q, k, h)).abs().max().item()
        check(tuple(lse.shape) == (b, h, t) and lse_err <= LSE_ATOL,
              f"K1f lse ({b}, {h}, {t}): max_abs_err {lse_err} <= {LSE_ATOL}")
        fwd["err"], fwd["lse_err"] = max(fwd["err"], err), max(fwd["lse_err"], lse_err)
        line = (f"phase {phase} K1f packed_flash_fwd with lse {shape}: o "
                f"max_abs_err {err:.3e} (bound {KERNEL_RTOL} x max|plain f32|), lse "
                f"max_abs_err {lse_err:.3e} (bound {LSE_ATOL})")
        if clock:
            ms = cuda_ms(lambda q, k, v: flash_train._fwd_kernel(q, k, v, h, True),
                         qkv, 20)
            plain_ms = cuda_ms(
                lambda q, k, v: (flash_train.packed_flash_mha_ref(q, k, v, h),
                                 lse_ref(q, k, h)), qkv, 10)
            if t == 750:
                sd_sets = [tuple(sdpa_heads(x, h) for x in s) for s in qkv]
                lib = cuda_ms(torch.nn.functional.scaled_dot_product_attention, sd_sets, 20)
                fwd.update(ms=ms, plain_ms=plain_ms, library_ms=lib,
                           **roofline(4 * b * t * d * 2 + b * h * t * 4, 4 * b * h * t * t * 64,
                                   "bf16"))
                line += f" sdpa {lib:.4f} ms"
            line += (f" kernel {ms:.4f} ms plain (bf16 o, f32 lse) "
                     f"{plain_ms:.4f} ms")
        if timed:
            print(line, flush=True)

        sets = []
        for q, k, v in qkv:
            o, lse = flash_train._fwd_kernel(q, k, v, h, with_lse=True)
            do = torch.randn(b, t, d, generator=g).to(dev, torch.bfloat16)
            sets.append((q, k, v, o, lse, do, h))
        q, k, v, o, lse, do, _ = sets[0]
        grads = flash_train.packed_flash_mha_bwd(q, k, v, o, lse, do, h)
        again = flash_train.packed_flash_mha_bwd(q, k, v, o, lse, do, h)
        plain = flash_train.packed_flash_mha_bwd_ref(
            q.float(), k.float(), v.float(), o.float(), do.float(), h)
        torch.cuda.synchronize()
        errs = []
        for name, out, ref in zip(("dq", "dk", "dv"), grads, plain):
            err = (out.float() - ref).abs().max().item()
            bound = K1B_RTOL * ref.abs().max().item()
            check(tuple(out.shape) == tuple(ref.shape) and err <= bound,
                  f"K1b {name} {shape}: max_abs_err {err} <= {bound}")
            errs.append(f"{name} {err:.3e} ({err / (bound / K1B_RTOL):.2e} of "
                        "max|plain|)")
            res["err"] = max(res["err"], err)
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"K1b {shape}: two runs on the same inputs give bit-identical dq, dk, dv")
        line = (f"phase {phase} K1b packed_flash_bwd {shape}: " + ", ".join(errs)
                + f" (bound {K1B_RTOL} x max|plain f32|), two runs bit-identical")
        if clock:
            ms = cuda_ms(flash_train.packed_flash_mha_bwd, sets, 10)
            plain_ms = cuda_ms(
                lambda q, k, v, o, lse, do, h:
                flash_train.packed_flash_mha_bwd_ref(q, k, v, o, do, h), sets, 3)
            if t == 750:
                lib_sets = []
                for q, k, v, _, _, do, _ in sets:
                    qs, ks, vs = (sdpa_heads(x, h).detach().requires_grad_() for x in (q, k, v))
                    o_s = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
                    lib_sets.append((o_s, (qs, ks, vs), sdpa_heads(do, h)))
                lib = cuda_ms(lambda o_s, ins, do_s: torch.autograd.grad(
                    o_s, ins, do_s, retain_graph=True), lib_sets, 10)
                del lib_sets
                # the least backward: S, dP, dV, dQ, dK, 2 T^2 d_head each
                res.update(ms=ms, plain_ms=plain_ms, library_ms=lib,
                           **roofline(8 * b * t * d * 2 + b * h * t * 4,
                                   10 * b * h * t * t * 64, "bf16"))
                line += f" sdpa backward {lib:.4f} ms"
            line += f" kernel {ms:.4f} ms plain bf16 {plain_ms:.4f} ms"
        if timed:
            print(line, flush=True)
    return fwd, res


def twice(name, fn, *args) -> torch.Tensor:
    """fn(*args) twice; the two outputs must be bit-identical (the split's
    sums have a fixed order). Returns the first."""
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{name}: two calls on the same inputs bit-identical")
    return a


def poison_past(k, v, pos: int):
    """Copies of k, v with every key past pos set to 0 (a score far above
    the others) and every value to 1e4."""
    k_bad, v_bad = k.clone(), v.clone()
    k_bad[:, pos + 1:] = 0.0
    v_bad[:, pos + 1:] = 1e4
    return k_bad, v_bad


# K3's shapes in phase 3, (rows, Tp, d, heads, pos, timed): whisper's greedy
# self- and cross-attention (8 rows, 12 heads), the conformer decoder's
# self-attention under beam 10 (80 rows, d 256, 4 heads; a 100-step request
# reaches pos 99), then the split's edges: the cross shape (S 6, chunks of
# 126 keys) at pos 0 (five empty blocks) and either side of the first chunk
# edge, and 2 rows (S 8, the most, chunks of 94) at pos 0, 93, 94 and 749.
K3_CASES = ((8, 112, D, H, 0, True), (8, 112, D, H, 4, True), (8, 112, D, H, 57, True),
            (8, 112, D, H, 103, True), (8, 752, D, H, 749, True),
            (80, 112, 256, 4, 99, True), (80, 112, 256, 4, 103, True),
            (8, 752, D, H, 0, False), (8, 752, D, H, 125, False), (8, 752, D, H, 126, False),
            (2, 752, D, H, 0, False), (2, 752, D, H, 93, False), (2, 752, D, H, 94, False),
            (2, 752, D, H, 749, False))


def check_k3(dev, g, timed=True, cases=K3_CASES, phase: str = "3") -> dict:
    """Phase 3: K3 against its plain version at `cases` (K3_CASES; phase 49
    passes whisper-large's and its label). Keys past pos are poisoned in
    the kernel's input (score 0, far above the others, and value 1e4), so a
    kernel that reads one fails; every call is made twice and must repeat
    bit for bit."""
    from agacs_tpu_torch.ops import decode_attn

    res = {"err": 0.0}
    for n, tp, d, h, pos, timed_case in cases:
        sets = [(*sharp_qkv(g, dev, (n, d), (n, tp, d), q_scale=0.125), pos, h)
                for _ in range(8 if timed and timed_case else 1)]
        q, k, v, _, _ = sets[0]
        s = decode_attn.time_splits(n, h, tp)
        err = hold(f"K3 ({n}, {tp}) pos={pos} S={s}",
                   twice("K3", decode_attn.decode_cache_attention, q,
                         *poison_past(k, v, pos), pos, h),
                   decode_attn.decode_cache_attention_ref(
                       q.float(), k.float(), v.float(), pos, h), (n, tp, d))
        res["err"] = max(res["err"], err)
        line = (f"phase {phase} K3 decode_attn ({n}, {tp}, {d}) H={h} pos={pos} S={s}: "
                f"max_abs_err {err:.3e} (bound {KERNEL_RTOL} x max|plain f32|), bit-identical "
                f"twice")
        if timed and timed_case:
            ms = cuda_ms(decode_attn.decode_cache_attention, sets, 50)
            plain_ms = cuda_ms(decode_attn.decode_cache_attention_ref, sets, 50)
            line += f" kernel {ms:.4f} ms plain bf16 {plain_ms:.4f} ms"
            if tp == 752 or n == 80:
                lib = sdpa_yardsticks(sets)
                # bytes: the keys and values 0..pos read, q read and o written
                bound = roofline(2 * n * (pos + 1) * d * 2 + 2 * n * d * 2,
                                 4 * n * h * (pos + 1) * 64, "bf16")
                line += (f" {lib['text']} bound {bound['bound_ms']:.4f} ms "
                         f"({bound['bound_by']})")
                if tp == 752:
                    res.update(ms=ms, plain_ms=plain_ms, library_ms=lib["library_ms"],
                               **bound)
        if timed:
            print(line, flush=True)
    return res


def sdpa_yardsticks(sets, beam: int = 1) -> dict:
    """K3's and K3s's library yardsticks on `sets` of (q, k, v, pos, h[,
    beam]): scaled_dot_product_attention over the whole cache with the keys
    past pos masked, and over the key slice k[:, :pos+1] without a mask
    (which the flash backend takes), each through `sdpa_ms`; library_ms is
    the faster, and `text` names both and their backends."""
    masked = sdpa_ms(lambda q, k, v, pos, h, *_: sdpa_one_query(q, k, v, pos, h, beam),
                     sets, 50)
    sliced = sdpa_ms(lambda q, k, v, pos, h, *_: sdpa_one_query(
        q, k[:, : pos + 1], v[:, : pos + 1], pos, h, beam, masked=False), sets, 50)
    times = [t for t, _ in (masked, sliced) if t is not None]
    fmt = lambda r: "none" if r[0] is None else f"{r[0]:.4f} ms ({r[1]})"  # noqa: E731
    return {"library_ms": min(times) if times else None,
            "text": f"sdpa masked {fmt(masked)}, key slice {fmt(sliced)}"}


def sdpa_one_query(q, k, v, pos: int, h: int, beam: int = 1, masked: bool = True):
    """scaled_dot_product_attention of `beam` queries per cache row (q
    (N*beam, d), k/v (N, Tp, d)) over keys 0..pos: the one PyTorch call
    that computes K3's (beam 1) and K3s's function. masked=False: no mask,
    for k and v already cut to keys 0..pos."""
    n = k.shape[0]
    mask = (torch.arange(k.shape[1], device=k.device) <= pos)[None, :] if masked else None
    return torch.nn.functional.scaled_dot_product_attention(
        q.view(n, beam, h, -1).transpose(1, 2), sdpa_heads(k, h), sdpa_heads(v, h),
        attn_mask=mask, scale=1.0)


def beam_ancestry(g, n: int, tp: int, j: int, pos: int) -> torch.Tensor:
    """(n, tp) int32 local rows as a beam run leaves them: position t < pos
    of row i points to another slot of its group 80% of the time, and
    position pos to the row itself (the step writes it before attending)."""
    own = torch.arange(n)[:, None] % j
    other = (own + torch.randint(1, j, (n, tp), generator=g)) % j
    anc = torch.where(torch.rand(n, tp, generator=g) < 0.2, own, other)
    anc[:, pos] = own[:, 0]
    return anc.to(torch.int32)


def poison_unread(k, v, anc, j: int, pos: int):
    """Copies of k, v in which keys past pos, and every (row, t) at t <= pos
    that no row of its own group reads through the map, hold k = 0 (a
    score far above the others) and v = 1e4: a kernel that reads outside
    its group, or its own row instead of the ancestry row, lands on
    poison at about a third of the keys."""
    bad = unread(anc, *k.shape[:2], j, pos, k.device)
    k_bad, v_bad = k.clone(), v.clone()
    k_bad[bad], v_bad[bad] = 0.0, 1e4
    return k_bad, v_bad


def check_k3a(dev, g, timed=True) -> dict:
    """Phase 3a: K3a against its plain version (the group's rows gathered
    through the map, then the plain-row math) on poisoned caches."""
    from agacs_tpu_torch.ops import decode_attn

    def kernel(q, k, v, pos, h, anc):
        return decode_attn.decode_cache_attention(q, k, v, pos, h, anc_local=anc,
                                                  beam=BEAM)

    def plain(q, k, v, pos, h, anc):
        return decode_attn.decode_cache_attention_anc_ref(q, k, v, pos, h, anc, BEAM)

    res = {"err": 0.0}
    for n, tp, pos in ((40, 112, 4), (40, 112, 57), (40, 112, 103), (10, 448, 447)):
        sets = [(*sharp_qkv(g, dev, (n, D), (n, tp, D), q_scale=0.125), pos, H,
                 beam_ancestry(g, n, tp, BEAM, pos).to(dev)) for _ in range(8)]
        q, k, v, _, _, anc = sets[0]
        k_bad, v_bad = poison_unread(k, v, anc, BEAM, pos)
        err = hold(f"K3a pos={pos}", twice("K3a", kernel, q, k_bad, v_bad, pos, H, anc),
                   plain(q.float(), k.float(), v.float(), pos, H, anc), (n, tp, D))
        res["err"] = max(res["err"], err)
        if not timed:
            continue
        ms = cuda_ms(kernel, sets, 50)
        plain_ms = cuda_ms(plain, sets, 50)
        if (tp, pos) == (112, 103):
            rows = (torch.arange(n, device=dev) // BEAM * BEAM)[:, None] + anc.long()
            cells = (rows * tp + torch.arange(tp, device=dev))[:, : pos + 1].unique().numel()
            res.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       **roofline(2 * cells * D * 2 + 2 * n * D * 2 + n * (pos + 1) * 4,
                               4 * n * H * (pos + 1) * 64, "bf16"))
        print(f"phase 3a K3a decode_attn_anc ({n}, {tp}, {D}) beam {BEAM} pos={pos}: "
              f"max_abs_err {err:.3e} (bound {KERNEL_RTOL} x max|plain f32|) kernel "
              f"{ms:.4f} ms plain bf16 {plain_ms:.4f} ms", flush=True)
    return res


def check_k3s(dev, g, timed=True) -> dict:
    """Phase 3s: K3s against its plain version at the beam cross-attention
    shape, 8 utterances x beam 5 distinct queries over (8, 752, 768), keys
    past pos poisoned, at pos 749 (timed), and the split's edges: pos 0 (S
    3: two empty blocks) and either side of the first chunk edge (251),
    one utterance (S 8, the most) at pos 749, S = 1 at pos 749 (one block a
    (head, group), a ring of many tiles), and 2 groups of 16 queries (one
    full query tile). Every call twice, bit for bit."""
    from agacs_tpu_torch.ops import decode_attn

    tp, res = 752, {"err": 0.0}
    for groups, j, pos, timed_case, splits in (
            (8, BEAM, 749, True, None), (8, BEAM, 0, False, None), (8, BEAM, 250, False, None),
            (8, BEAM, 251, False, None), (1, BEAM, 749, False, None), (8, BEAM, 749, False, 1),
            (2, decode_attn.QUERY_TILE, 749, False, None)):
        sets = [(*sharp_qkv(g, dev, (groups * j, D), (groups, tp, D), q_scale=0.125),
                 pos, H, j) for _ in range(8 if timed and timed_case else 1)]
        q, k, v, _, _, _ = sets[0]
        s = splits or decode_attn.time_splits(groups, H, tp, decode_attn.SHARED_SPLIT_BLOCKS)
        err = hold(f"K3s ({groups} x {j}) pos={pos} S={s}",
                   twice("K3s", lambda *a: decode_attn.decode_shared_cache_attention(
                       *a, splits=splits), q, *poison_past(k, v, pos), pos, H, j),
                   decode_attn.decode_shared_cache_attention_ref(
                       q.float(), k.float(), v.float(), pos, H, j), (groups, tp, D))
        res["err"] = max(res["err"], err)
        line = (f"phase 3s K3s decode_attn_shared ({groups} x {j}, {tp}, {D}) pos={pos} "
                f"S={s}: max_abs_err {err:.3e} (bound {KERNEL_RTOL} x max|plain f32|), "
                f"bit-identical twice")
        if timed and timed_case:
            lib = sdpa_yardsticks(sets, BEAM)
            res.update(ms=cuda_ms(decode_attn.decode_shared_cache_attention, sets, 50),
                       plain_ms=cuda_ms(decode_attn.decode_shared_cache_attention_ref, sets, 50),
                       library_ms=lib["library_ms"],
                       **roofline(2 * groups * (pos + 1) * D * 2 + 2 * groups * BEAM * D * 2,
                                  4 * groups * BEAM * H * (pos + 1) * 64, "bf16"))
            line += (f" kernel {res['ms']:.4f} ms plain bf16 {res['plain_ms']:.4f} ms "
                     f"{lib['text']} bound {res['bound_ms']:.4f} ms")
        if timed:
            print(line, flush=True)
    return res


def pe_gate(g, dev) -> torch.Tensor:
    """(H,) float32 post-sigmoid gates, distinct per head, with 0 and 1 among
    them: a kernel that ignores the gate, or reads gate[0] for every head,
    moves most heads' scores."""
    return torch.cat([torch.tensor([0.0, 1.0]), torch.rand(H - 2, generator=g)]).to(dev)


def sdpa_ms(fn, arg_sets, iters) -> tuple[float | None, str]:
    """library_ms of a scaled_dot_product_attention call and the backend
    that ran it: each backend alone, flash first; (None, "none") if none
    takes the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                return cuda_ms(fn, arg_sets, iters), backend.name
        except RuntimeError:
            continue
    return None, "none"


def pe_sdpa_inputs(q, q_cs, k, k_cs, v, gate, pos: int):
    """SDPA operands that give K3-PE's scores: per head q' = [(1-g) q | g q_cs]
    and k' = [k | k_cs] (head dim 128), v as it is (64), keys <= pos."""
    n, tp, _ = k.shape
    g = gate.view(1, H, 1, 1)
    qh = lambda x: x.view(n, 1, H, -1).transpose(1, 2).float()  # noqa: E731
    q2 = torch.cat([(1 - g) * qh(q), g * qh(q_cs)], -1).to(torch.bfloat16)
    k2 = torch.cat([sdpa_heads(k, H), sdpa_heads(k_cs, H)], -1).contiguous()
    mask = (torch.arange(tp, device=k.device) <= pos)[None, :]
    return q2, k2, sdpa_heads(v, H).contiguous(), mask


def unread(anc, n: int, tp: int, j: int, pos: int, dev) -> torch.Tensor:
    """(n, tp) True where no row of the entry's beam group reads it through
    the map at t <= pos (and at every t > pos): where poison goes."""
    if anc is None:
        mask = torch.zeros(n, tp, dtype=torch.bool, device=dev)
    else:
        rows = (torch.arange(n, device=dev) // j * j)[:, None] + anc.long()
        mask = torch.ones(n, tp, dtype=torch.bool, device=dev)
        mask[rows, torch.arange(tp, device=dev)[None, :]] = False
    mask[:, pos + 1:] = True
    return mask


def check_k3pe(dev, g, timed=True) -> dict:
    """Phase 3p: K3-PE (plain rows) and K3a-PE (the ancestry map) against
    their plain version at the PE greedy (8, 112, 768) and beam (40, 112,
    768) self-attention shapes and the full context (10, 448, 768) at pos
    447: sharp, shifted scores for both query/key pairs, distinct per-head
    gates with 0 and 1, and k, k_cs poisoned to 0 (a score far above the
    rest) and v to 1e9 past pos and at every entry the map does not
    select. Returns {"pe": ..., "anc_pe": ...} errors and times at pos 103."""
    from agacs_tpu_torch.ops import decode_attn as da

    res = {"pe": {"err": 0.0}, "anc_pe": {"err": 0.0}}
    cases = [(8, 112, 0, False), (8, 112, 57, False), (8, 112, 103, False),
             (40, 112, 4, True), (40, 112, 57, True), (40, 112, 103, True),
             (10, 448, 447, True)]
    for n, tp, pos, anc_on in cases:
        sets = []
        for _ in range(8):
            q, k, v = sharp_qkv(g, dev, (n, D), (n, tp, D), q_scale=0.125)
            q_cs, k_cs, _ = sharp_qkv(g, dev, (n, D), (n, tp, D), q_scale=0.125)
            anc = beam_ancestry(g, n, tp, BEAM, pos).to(dev) if anc_on else None
            sets.append((q, k, v, pos, H, anc, q_cs, k_cs, pe_gate(g, dev)))

        def kernel(q, k, v, pos, h, anc, q_cs, k_cs, gate, fn=da.decode_cache_attention):
            return fn(q, k, v, pos, h, anc_local=anc, beam=BEAM, q_cs=q_cs, k_cs=k_cs,
                      gate=gate)

        def plain(*args):
            return kernel(*args, fn=da.decode_cache_attention_plain)

        q, k, v, _, _, anc, q_cs, k_cs, gate = sets[0]
        bad = unread(anc, n, tp, BEAM, pos, dev)
        k_bad, kcs_bad, v_bad = k.clone(), k_cs.clone(), v.clone()
        k_bad[bad], kcs_bad[bad], v_bad[bad] = 0.0, 0.0, 1e9
        name = "K3a-PE" if anc_on else "K3-PE"
        err = hold(f"{name} pos={pos}",
                   twice(name, kernel, q, k_bad, v_bad, pos, H, anc, q_cs, kcs_bad, gate),
                   plain(q.float(), k.float(), v.float(), pos, H, anc, q_cs.float(),
                         k_cs.float(), gate), (n, tp, D))
        key = "anc_pe" if anc_on else "pe"
        res[key]["err"] = max(res[key]["err"], err)
        line = (f"phase 3p {name} decode_attn ({n}, {tp}, {D}) pos={pos}: max_abs_err "
                f"{err:.3e} (bound {KERNEL_RTOL} x max|plain f32|)")
        if timed and pos == 103:
            ms, plain_ms = cuda_ms(kernel, sets, 50), cuda_ms(plain, sets, 50)
            lib_sets = []
            for q, k, v, _, _, anc, q_cs, k_cs, gate in sets:
                if anc_on:
                    k, v, k_cs = (da.gather_ancestry(x, anc, BEAM) for x in (k, v, k_cs))
                lib_sets.append(pe_sdpa_inputs(q, q_cs, k, k_cs, v, gate, pos))
            lib, backend = sdpa_ms(lambda q2, k2, v2, m: torch.nn.functional
                                   .scaled_dot_product_attention(q2, k2, v2, attn_mask=m,
                                                                 scale=1.0), lib_sets, 50)
            if anc_on:
                rows = (torch.arange(n, device=dev) // BEAM * BEAM)[:, None] + anc.long()
                cells = (rows * tp + torch.arange(tp, device=dev))[:, : pos + 1].unique().numel()
                nbytes = 3 * cells * D * 2 + 3 * n * D * 2 + n * (pos + 1) * 4 + H * 4
            else:
                nbytes = 3 * n * (pos + 1) * D * 2 + 3 * n * D * 2 + H * 4
            res[key].update(ms=ms, plain_ms=plain_ms, library_ms=lib, sdpa_backend=backend,
                            **roofline(nbytes, 6 * n * H * (pos + 1) * 64, "bf16"))
            line += (f" kernel {ms:.4f} ms plain bf16 {plain_ms:.4f} ms sdpa ([q|q_cs], "
                     f"[k|k_cs], head dim 128/64, {backend}) "
                     + (f"{lib:.4f} ms" if lib is not None else "none")
                     + f" bound {res[key]['bound_ms']:.4f} ms")
        print(line, flush=True)
    return res


def quantized(x, dev):
    """JAX `_quantize_kv` of a (N, Tp, d) bf16 cache, on the card."""
    from agacs_tpu_torch.models.whisper import quantize_kv

    return quantize_kv(x.to(dev))


# Phase 3q's cases, (kind, rows or groups, Tp, pos, timed, splits): the
# greedy and beam cross-attention on the int8 cross-KV (K3-int8 S 6, chunks
# of 128 keys; K3s-int8 S 3, chunks of 256) at pos 749, 0 (empty blocks)
# and either side of the first chunk edge, 2 rows (S 8, the most) at pos
# 749, K3s-int8 at S = 1 (a ring of many tiles), and K3a-int8 at (40, 128)
# pos 103.
K3I8_CASES = (("rows", 8, 768, 749, True, None), ("rows", 8, 768, 0, False, None),
              ("rows", 8, 768, 127, False, None), ("rows", 8, 768, 128, False, None),
              ("rows", 2, 768, 749, False, None), ("shared", 8, 768, 749, True, None),
              ("shared", 8, 768, 0, False, None), ("shared", 8, 768, 255, False, None),
              ("shared", 8, 768, 256, False, None),
              ("shared", 8, 768, 749, False, 1), ("anc", 40, 128, 103, True, None))


def check_k3i8(dev, g, timed=True) -> dict:
    """Phase 3q: K3-int8 (greedy cross-attention, (8, 768, 768) at pos 749
    and pos 0), K3s-int8 (beam cross-attention, 8 x 5 queries over (8,
    768, 768)) and K3a-int8 ((40, 128, 768), beam 5, pos 103; no decode
    step launches it) against the kernel-folding plain version, bound
    KERNEL_RTOL x max |plain|, and within INT8_VS_BF16 x max of the
    attention over the unquantised bf16 caches. The int8 caches come from
    sharp bf16 ones through `quantize_kv`; keys past pos (and entries the
    map does not select) are poisoned to 127 x sign(q) (the largest score
    an int8 key can give) and values to 127. Returns {"rows", "shared",
    "anc"} errors and times."""
    from agacs_tpu_torch.ops import decode_attn as da

    res = {"rows": {"err": 0.0}, "shared": {"err": 0.0}, "anc": {"err": 0.0}}
    for kind, n, tp, pos, timed_case, splits in K3I8_CASES:
        nq = n * BEAM if kind == "shared" else n
        sets = []
        for _ in range(8 if timed and timed_case else 1):
            q, k, v = sharp_qkv(g, dev, (nq, D), (n, tp, D), q_scale=0.125)
            (k8, ks), (v8, vs) = quantized(k, dev), quantized(v, dev)
            anc = beam_ancestry(g, n, tp, BEAM, pos).to(dev) if kind == "anc" else None
            sets.append(((q, k8, v8, pos, H, anc, ks, vs), (k, v)))

        def kernel(q, k8, v8, pos, h, anc, ks, vs, plain=False):
            if kind == "shared":
                if plain:
                    return da.decode_shared_cache_attention_plain(q, k8, v8, pos, h, BEAM,
                                                                  k_scale=ks, v_scale=vs)
                return da.decode_shared_cache_attention(q, k8, v8, pos, h, BEAM, k_scale=ks,
                                                        v_scale=vs, splits=splits)
            fn = da.decode_cache_attention_plain if plain else da.decode_cache_attention
            return fn(q, k8, v8, pos, h, anc_local=anc, beam=BEAM, k_scale=ks, v_scale=vs)

        def plain(*args):
            return kernel(*args, plain=True)

        def unquantised(q, k, v, anc):
            return kernel(q, k, v, pos, H, anc, None, None, plain=True)

        (q, k8, v8, _, _, anc, ks, vs), (k, v) = sets[0]
        bad = unread(anc, n, tp, BEAM, pos, dev)
        q_row = q[:: BEAM] if kind == "shared" else q  # a group's first query
        worst = (127 * torch.sign(q_row.float() * ks)).to(torch.int8)
        k_bad, v_bad = k8.clone(), v8.clone()
        k_bad[bad] = worst[:, None, :].expand(n, tp, D)[bad]
        v_bad[bad] = 127
        name = {"rows": "K3-int8", "shared": "K3s-int8", "anc": "K3a-int8"}[kind]
        out = twice(name, kernel, q, k_bad, v_bad, pos, H, anc, ks, vs)
        err = hold(f"{name} pos={pos}", out,
                   plain(q.float(), k8, v8, pos, H, anc, ks, vs), (nq, tp, D))
        ref = unquantised(q.float(), k.float(), v.float(), anc)
        q_err = (out.float() - ref).abs().max().item()
        check(q_err <= INT8_VS_BF16 * ref.abs().max().item(),
              f"{name} pos={pos} vs unquantised: {q_err} <= {INT8_VS_BF16} x max")
        res[kind]["err"] = max(res[kind]["err"], err)
        s = splits or da.time_splits(n, H, tp, da.SHARED_SPLIT_BLOCKS if kind == "shared"
                                     else da.SPLIT_BLOCKS)
        line = (f"phase 3q {name} ({nq} queries, {n} x {tp}, {D}) pos={pos} S={s}: max_abs_err "
                f"{err:.3e} (bound {KERNEL_RTOL} x max|plain f32|), vs unquantised bf16 "
                f"{q_err:.3e} ({q_err / ref.abs().max().item():.2e} of max; bound "
                f"{INT8_VS_BF16}), bit-identical twice")
        if timed and timed_case:
            args = [a for a, _ in sets]
            ms, plain_ms = cuda_ms(kernel, args, 50), cuda_ms(plain, args, 50)
            lib = {"library_ms": None, "text": "sdpa none"}
            if kind != "anc":
                deq = [(q, da.dequantize_kv(k8, ks, torch.bfloat16),
                        da.dequantize_kv(v8, vs, torch.bfloat16), pos, H)
                       for q, k8, v8, *_ in args]
                lib = sdpa_yardsticks(deq, BEAM if kind == "shared" else 1)
            if kind == "anc":
                rows = (torch.arange(n, device=dev) // BEAM * BEAM)[:, None] + anc.long()
                cells = (rows * tp + torch.arange(tp, device=dev))[:, : pos + 1].unique().numel()
                nbytes = 2 * cells * D + n * (pos + 1) * 4
            else:
                nbytes = 2 * n * (pos + 1) * D
            res[kind].update(ms=ms, plain_ms=plain_ms, library_ms=lib["library_ms"],
                             **roofline(nbytes + 2 * nq * D * 2 + 2 * D * 4,
                                        4 * nq * H * (pos + 1) * 64, "bf16"))
            line += (f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms on dequantised bf16 (not "
                     f"the same function): {lib['text']} bound {res[kind]['bound_ms']:.4f} ms")
        print(line, flush=True)
    return res


def int8_weight(g, dev, d_in: int, d_out: int):
    """A whisper-like linear (uniform +-1/sqrt(d_in), rounded to bf16 as the
    trainer stores the frozen trunk) quantised per output channel: (w_q,
    w_s, f32 bias)."""
    from agacs_tpu_torch.ops.int8_linear import quantize_weight

    bnd = d_in ** -0.5
    w = ((torch.rand(d_in, d_out, generator=g) * 2 - 1) * bnd).to(torch.bfloat16)
    w_q, w_s = quantize_weight(w.to(dev))
    b = ((torch.rand(d_out, generator=g) * 2 - 1) * bnd).to(torch.bfloat16).float()
    return w_q, w_s, b.to(dev)


_L2_FLUSH: list = []


def cold_l2(dev) -> None:
    """Evict the 50 MB L2: write a 128 MB buffer, so the next kernel reads
    its weights from HBM, as a decode step streaming 99 MB of them does (a
    ring stage read before its copy arrived then shows)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.uint8, device=dev))
    _L2_FLUSH[0].zero_()


def differ(out, plain) -> float:
    """Share of output elements that differ from the plain version rounded
    to the output's dtype."""
    return (out != plain.to(out.dtype)).float().mean().item()


def wide_into(buf, q, s, w_q, w_s=None, w_t=None) -> None:
    """The wide K8g's C entry writing `buf` (M, N) bf16, a view of a larger
    buffer: the dgrad without `w_s`, else the forward on w_t = w_q^T.
    Phase 2i's seam for the rows past M (`int8_gemm` allocates its own
    output); not counted as a launch."""
    from agacs_tpu_torch.ops import cuda_lib
    from agacs_tpu_torch.ops import int8_linear as i8

    (m, k), n, dgrad = q.shape, buf.shape[1], w_s is None
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    fn = cuda_lib.load("int8_gemm", "int8_gemm",
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    cuda_lib.check(fn(q.data_ptr(), s.data_ptr(), w_q.data_ptr(),
                      None if dgrad else w_t.data_ptr(), None if dgrad else w_s.data_ptr(),
                      buf.data_ptr(), 1, m, n, k, int(dgrad), i8.gemm_tiling(m, n, sms)[0],
                      torch.cuda.current_stream(q.device).cuda_stream), "int8_gemm")


# K8q's shapes in phase 2i (rows, K, x dtype, column scale): the int8
# step's inputs at whisper-small (12000, 768) and whisper-large (12000,
# 1280), whisper-large's fc2 input (12000, 5120) and the dgrad's input of
# its fc1 (the column scale w_s), a ragged row count and K (1001, 1000: 125
# loads a row), a K whose rows are not 16-byte aligned (37, 1003: one element
# a load), float32 with the column scale, and a row past the registers (4 x
# 20000 float32: 5000 loads a row, 1536 in registers). The first K8Q_TIMED
# are timed against the bound, the first K8Q_TURNS in `--k8q-turns`.
K8Q_SHAPES = ((12000, 768, "bf16", False), (12000, 1280, "bf16", False),
              (12000, 5120, "bf16", False), (12000, 5120, "bf16", True),
              (1001, 1000, "bf16", True), (37, 1003, "bf16", False), (3000, 768, "f32", True),
              (4, 20000, "f32", True))
K8Q_TIMED, K8Q_TURNS = 4, 3


def k8q_bound(m: int, k: int, x_bytes: int = 2) -> dict:
    """K8q's bound: x read once, q written once (a byte an element), the
    row scales written; 4 operations an element (|v|, max, v / s, round)."""
    return roofline(m * k * x_bytes + m * k + m * 4, 4 * m * k, "f32")


def check_k8q(dev, g, timed=True) -> dict:
    """Phase 2i (K8q): int8_rowquant against `row_quant_ref` at K8Q_SHAPES:
    q and s identical, twice bit-identical, one launch a call; timed at the
    first K8Q_TIMED shapes beside the plain version and the bound. Returns
    a list, K8Q_SHAPES' order, of {err, ms, plain_ms, bound_ms, bound_by,
    library_ms} (the timed ones)."""
    from agacs_tpu_torch.ops import int8_linear as i8

    out = []
    for i, (m, k, dt, cs) in enumerate(K8Q_SHAPES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        n_sets = 4 if timed and i < K8Q_TIMED else 1
        sets = [(torch.randn(m, k, generator=g) * 3).to(dev, dtype) for _ in range(n_sets)]
        col = (torch.rand(k, generator=g) + 0.5).to(dev) if cs else None
        x = sets[0]
        before = i8.QUANT_LAUNCHES
        q, s = i8.rowquant(x, col)
        q2, s2 = i8.rowquant(x, col)
        q_ref, s_ref = i8.row_quant_ref(x.float(), col)
        torch.cuda.synchronize()
        check(i8.QUANT_LAUNCHES == before + 2, f"K8q ({m}, {k}): one launch a call")
        check(torch.equal(q, q2) and torch.equal(s, s2), f"K8q ({m}, {k}): bit-identical twice")
        q_err = (q.int() - q_ref.int()).abs().max().item()
        check(q_err == 0 and torch.equal(s, s_ref), f"K8q ({m}, {k}) {dt}: q off by {q_err} "
                                                    "steps or s differs from plain")
        res = {"err": 0.0}
        line = (f"phase 2i K8q ({m}, {k}) {dt}{' with the column scale' if cs else ''}: q and s "
                f"identical to plain, bit-identical twice, one launch a call")
        if timed and i < K8Q_TIMED:
            res.update(ms=cuda_ms(lambda x: i8.rowquant(x, col), [(x,) for x in sets], 50),
                       plain_ms=cuda_ms(lambda x: i8.row_quant_ref(x, col),
                                        [(x,) for x in sets], 10),
                       library_ms=None, **k8q_bound(m, k))
            line += (f" | kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms bound "
                     f"{res['bound_ms']:.4f} ms ({res['bound_by']}): "
                     f"{res['bound_ms'] / res['ms']:.1%} of the bound")
        out.append(res)
        print(line, flush=True)
    return out


# `--k8q-turns DIR`: one process per turn in the tree at `root`: K8q at the
# first K8Q_TURNS shapes (bf16, 4 distinct inputs, 50 calls after a warm-up),
# timed with CUDA events around the tree's own `int8_linear.rowquant`.
K8Q_TURN = ("import sys, json, torch; sys.path.insert(0, {root!r}); "
            "from agacs_tpu_torch.ops import int8_linear as i8\n"
            "dev = torch.device('cuda'); g = torch.Generator().manual_seed(0); out = {{}}\n"
            "for m, k in {shapes!r}:\n"
            "    xs = [(torch.randn(m, k, generator=g) * 3).to(dev, torch.bfloat16) "
            "for _ in range(4)]\n"
            "    for x in xs: i8.rowquant(x)\n"
            "    torch.cuda.synchronize(); torch.cuda._sleep(200_000_000)\n"
            "    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)\n"
            "    a.record()\n"
            "    for i in range(50): i8.rowquant(xs[i % 4])\n"
            "    b.record(); torch.cuda.synchronize()\n"
            "    out[str((m, k))] = a.elapsed_time(b) / 50\n"
            "print('K8Q_TURN', json.dumps(out))")


def k8q_turns(other: str) -> None:
    """K8q at the first K8Q_TURNS shapes in the tree at `other` and in this
    one, in turns (other, this, this, other), one process each; each tree
    builds its own int8_gemm library."""
    other = os.path.abspath(other)
    check(os.path.isdir(os.path.join(other, "agacs_tpu_torch")), f"{other} holds the port")
    shapes = [(m, k) for m, k, _, _ in K8Q_SHAPES[:K8Q_TURNS]]
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, "-c", K8Q_TURN.format(root=tree, shapes=shapes)],
                              cwd=tree, capture_output=True, text=True, timeout=600)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("K8Q_TURN ")]
        check(proc.returncode == 0 and len(found) == 1,
              f"K8q turn in {tree}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        print(f"k8q-turns {'this tree' if tree == ROOT else tree}: ms a call "
              + found[0].split(" ", 1)[1] + " | bound ms " + json.dumps(
                  {str(sh): round(k8q_bound(*sh)["bound_ms"], 5) for sh in shapes}), flush=True)


# `--k3k5-turns DIR`: K3's forms and K5 at d_head 64 and 128, the shapes
# the main paths give them (whisper-small's greedy self- and
# cross-attention, its beam rows with the ancestry map and shared cross-KV,
# PE and int8 caches; the conformer decoder's and the LM's rows, the LM's
# also over 6016 positions at 80 rows, one table of 6016 keys a block; the
# ladder's d_head 48; K5 at the conformer recipe's serving and training
# shapes, and its 128 instance at the XLarge conformer's (8, 468, 1024), 8
# heads), in the tree at DIR and in this one, one process a turn
# (`k3k5_turn`).
K3K5_TURN_CASES = (("K3", 8, 112, 768, 12, 103), ("K3", 8, 752, 768, 12, 749),
                   ("K3", 80, 112, 256, 4, 99), ("K3a", 40, 112, 768, 12, 103),
                   ("K3-PE", 8, 112, 768, 12, 103), ("K3-int8", 8, 768, 768, 12, 749),
                   ("K3-f32", 80, 112, 512, 8, 103), ("K3@48", 8, 752, 192, 4, 749),
                   ("K3@48", 8, 112, 192, 4, 103), ("K3s", 8, 752, 768, 12, 749),
                   ("K3-f32", 80, 6016, 512, 8, 5000))
K3K5_TURN_K5 = (("K5 fwd", 8, 468, 256, 4), ("K5 bwd", 16, 468, 256, 4),
                ("K5 fwd", 8, 468, 1024, 8), ("K5 bwd", 8, 468, 1024, 8))


def k3k5_turn(root: str) -> int:
    """One turn of `--k3k5-turns`: the tree at `root`'s own decode_attn and
    relpos_flash, each case of K3K5_TURN_CASES and K3K5_TURN_K5 timed by
    CUDA events over distinct inputs (cuda_ms); printed as one JSON line,
    `K3K5_TURN {...}` (ms a call)."""
    sys.path.insert(0, root)
    from agacs_tpu_torch.ops import decode_attn as da
    from agacs_tpu_torch.ops import relpos_flash as rf

    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(0)
    out = {}
    for kind, n, tp, d, h, pos in K3K5_TURN_CASES:
        sets = []
        big = n * tp * d > 10 ** 8  # drawn on the card, two sets past the L2
        gd = torch.Generator(device=dev).manual_seed(tp) if big else g
        for _ in range(2 if big else 8):
            dt = torch.float32 if kind == "K3-f32" else torch.bfloat16
            q, k, v = ((torch.randn(*sh, generator=gd, device=gd.device) * 0.5).to(dev, dt)
                       for sh in ((n * (BEAM if kind == "K3s" else 1), d), (n, tp, d),
                                  (n, tp, d)))
            kw = {}
            if kind == "K3a":
                kw = {"anc_local": torch.randint(0, BEAM, (n, tp), generator=g).to(
                    dev, torch.int32), "beam": BEAM}
            elif kind == "K3-PE":
                kw = {"q_cs": torch.randn(n, d, generator=g).to(dev, dt),
                      "k_cs": torch.randn(n, tp, d, generator=g).to(dev, dt),
                      "gate": torch.rand(h, generator=g).to(dev)}
            elif kind == "K3-int8":
                k, v = (torch.randint(-127, 128, (n, tp, d), generator=g).to(dev, torch.int8)
                        for _ in range(2))
                kw = {"k_scale": (torch.rand(d, generator=g) * 0.02).to(dev),
                      "v_scale": (torch.rand(d, generator=g) * 0.02).to(dev)}
            sets.append((q, k, v, kw))
        key = f"{kind} ({n}, {tp}, {d}) H={h} pos={pos}"
        if kind == "K3s":
            call = lambda q, k, v, kw: da.decode_shared_cache_attention(q, k, v, pos, h, BEAM)
        else:
            call = lambda q, k, v, kw: da.decode_cache_attention(q, k, v, pos, h, **kw)
        out[key] = cuda_ms(call, sets, 50)
    for kind, b, t, d, h in K3K5_TURN_K5:
        sets = []
        for _ in range(3):
            qu, qv, k, v = (torch.randn(b, t, d, generator=g).to(dev, torch.bfloat16)
                            for _ in range(4))
            pe = rf.pad_pe(torch.randn(2 * t - 1, d, generator=g).to(dev, torch.bfloat16), t)
            mask = torch.zeros(b, t, device=dev)
            x = (qu, qv, k, v, pe, mask)
            if kind == "K5 bwd":
                o, m, l = rf._launch_fwd(*x, h, stats=True)
                x += (o, torch.randn(b, t, d, generator=g).to(dev, torch.bfloat16), m, l)
            sets.append(x)
        if kind == "K5 bwd":
            ms = cuda_ms(lambda *a: rf._launch_bwd(*a, h), sets, 10)
        else:
            ms = cuda_ms(lambda *a: rf._launch_fwd(*a, h, stats=False), sets, 20)
        out[f"{kind} ({b}, {t}, {d}) H={h}"] = ms
    print("K3K5_TURN", json.dumps(out), flush=True)
    return 0


def k3k5_turns(other: str) -> None:
    """K3K5_TURN_CASES and K3K5_TURN_K5 in the tree at `other` and in this
    one, in turns (other, this, this, other), one process each
    (`--k3k5-turn`); each tree builds its own libraries."""
    other = os.path.abspath(other)
    check(os.path.isdir(os.path.join(other, "agacs_tpu_torch")), f"{other} holds the port")
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, "
                                f"{tree!r}); from agacs_tpu_torch.ops import cuda_lib; "
                                f"cuda_lib.build({name!r})"], cwd=tree)
              for tree in (other, ROOT) for name in ("decode_attn", "relpos_flash")]
    check(all(p.wait(timeout=900) == 0 for p in builds), "K3 and K5 built in both trees")
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                               "--k3k5-turn", tree], cwd=tree, capture_output=True, text=True,
                              timeout=900)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("K3K5_TURN ")]
        check(proc.returncode == 0 and len(found) == 1,
              f"K3/K5 turn in {tree}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        print(f"k3k5-turns {'this tree' if tree == ROOT else tree}: ms a call "
              + found[0].split(" ", 1)[1], flush=True)


def check_k8(dev, g, timed=True, shapes=K8_SHAPES, entries=(K8_SHAPES[0], K8_THIN_ENTRY),
             phase: str = "2i", profiled: bool = True) -> dict:
    """Phase 2i: K8q (rowquant) and K8g (int8_gemm, forward and dgrad)
    against their plain versions at `shapes` (K8_SHAPES; phase 49 passes
    whisper-large's, with its wide and thin `entries` and its label, and
    `profiled` False: the one-event-a-call profiles are phase 2i's, the
    launch counts hold at every shape). Above 64 rows the forward
    and every dgrad run the wide kernel (`int8_linear.gemm_tiling`), the
    forward on the kept w_q^T; at 64 rows or fewer the forward is one
    launch, `thin_matmul` (K8q folded into the thin K8g). Each product is
    called twice after the L2 is evicted and must give bit-identical
    outputs, one device event a call, with no element different from the
    plain version (both sum exact int32 products and repeat the same
    float32 epilogue); the wide kernel, given an output buffer with rows
    past M (`wide_into`), must leave those rows as they were. Timed beside
    them: the plain versions; at the thin shapes cuBLAS on the dequantised
    bf16 weight; above 16 rows `torch._int_mm` + dequant. (The two-launch
    design this replaced, K8q + a thin K8g on the int8 rows, is timed by
    its own tree's phase 2i.) Returns K8g's errors and times at (12000,
    768) -> 768 and the thin product's at (8, 768) -> 768 (K8q's times are
    `check_k8q`'s)."""
    from agacs_tpu_torch.ops import int8_linear as i8
    from agacs_tpu_torch.ops import int8_serve

    res = {"fwd": {"err": 0.0}, "dgrad": {"err": 0.0},
           "thin": {"err": 0.0}}
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    profiles = []  # one-launch checks, after every value check (a mutant fails on its fault)
    for m, k, n in shapes:
        thin = i8.thin_gemm(m, False)
        # > 50 MB of distinct buffers per cycle: the weights at decode shapes
        n_sets = (max(4, -(-(64 << 20) // (k * n))) if thin else 4) if timed else 1
        sets = []
        for _ in range(n_sets):
            w_q, w_s, _ = int8_weight(g, dev, k, n)
            x = torch.randn(m, k, generator=g).to(dev, bf16)
            dy = torch.randn(m, n, generator=g).to(dev, bf16)
            sets.append((x, w_q, w_s, dy, None if thin else w_q.t().contiguous()))
        x, w_q, w_s, dy, w_t = sets[0]
        q, s = i8.rowquant(x)
        q_ref, s_ref = i8.row_quant_ref(x.float())
        torch.cuda.synchronize()
        q_err = (q.int() - q_ref.int()).abs().max().item()
        check(q_err == 0 and torch.equal(s, s_ref), f"K8q ({m}, {k}): q off by {q_err} steps")
        shape = f"({m}, {k}) -> {n}"
        if thin:
            name, word = f"K8g thin_matmul {shape}", "thin_gemm_kernel"
            fwd = functools.partial(i8.thin_matmul, x, w_q, w_s)
        else:
            name, word = f"K8g wide {shape}", "wide_gemm_kernel"
            fwd = functools.partial(i8.int8_gemm, q, s, w_q, w_s, out_dtype=bf16, w_t=w_t)
        counts = i8.QUANT_LAUNCHES, i8.THIN_LAUNCHES
        cold_l2(dev)
        y = twice(name, fwd)
        check((i8.QUANT_LAUNCHES, i8.THIN_LAUNCHES) == (counts[0], counts[1] + 2 * thin),
              f"{name}: {'one thin launch, no K8q' if thin else 'the wide kernel'} a call")
        y_ref = i8.int8_matmul_ref(x.float(), w_q, w_s)
        check(differ(y, y_ref) == 0, f"{name}: {differ(y, y_ref):.4%} of elements differ "
                                     "from plain")
        err = hold(name, y, y_ref, (m, k, n))
        qd, sd = i8.rowquant(dy, w_s)
        qd_ref, _ = i8.row_quant_ref(dy.float(), w_s)
        check(torch.equal(qd, qd_ref), f"K8q dgrad ({m}, {n}) with the column pre-scale")
        dgr = functools.partial(i8.int8_gemm, qd, sd, w_q, dgrad=True, out_dtype=bf16)
        cold_l2(dev)
        dx = twice(f"K8g dgrad {shape}", dgr)
        dx_ref = i8.int8_matmul_dgrad_ref(dy.float(), w_q, w_s, torch.float32)
        check(differ(dx, dx_ref) == 0, f"K8g dgrad {shape}: {differ(dx, dx_ref):.4%} of "
                                       "elements differ from plain")
        d_err = hold("K8g dgrad", dx, dx_ref, (m, n, k))
        profiles += [(name, fwd, word), (f"K8g dgrad {shape}", dgr, "wide_gemm_kernel")]
        # the wide kernel's stores stop at row M: rows past it keep their value
        outs = [("dgrad", dx, (qd, sd, w_q))]
        if not thin:
            outs.append(("forward", y, (q, s, w_q, w_s, w_t)))
        for what, want, args in outs:
            buf = torch.full((m + 128, want.shape[1]), 7.0, dtype=bf16, device=dev)
            wide_into(buf[:m], *args)
            torch.cuda.synchronize()
            check(bool((buf[m:] == 7.0).all()) and torch.equal(buf[:m], want),
                  f"K8g wide {what} {shape}: the output's rows, and none past M, written")
        res["thin" if thin else "fwd"]["err"] = max(res["thin" if thin else "fwd"]["err"], err)
        res["dgrad"]["err"] = max(res["dgrad"]["err"], d_err)
        line = (f"phase {phase} K8 {shape}: K8q q/s identical to plain; "
                + (f"thin_matmul (BN, S) {int8_serve.thin_tiling(m, n, k, int8_serve.K8_KR)}"
                   if thin else f"wide (BM, BN) {i8.gemm_tiling(m, n, sms)}")
                + f", dgrad wide (BM, BN) {i8.gemm_tiling(m, k, sms)}: bit-identical twice "
                f"after an L2 eviction, no element different from plain; max_abs_err "
                f"{err:.3e}, dgrad {d_err:.3e}")
        if timed:
            iters = 100 if thin else 20
            qs = [(*i8.rowquant(x), w_q, w_s, w_t) for x, w_q, w_s, _, w_t in sets]
            qds = [(*i8.rowquant(dy, w_s), w_q) for _, w_q, w_s, dy, _ in sets]
            xs = [(x, w_q, w_s) for x, w_q, w_s, _, _ in sets]
            t = {}
            if thin:
                t["fwd"] = cuda_ms(i8.thin_matmul, xs, iters)
                t["fwd_plain"] = cuda_ms(i8.int8_matmul_ref, xs, 10)
                bfs = [(x, int8_serve.dequant_bf(w_q, w_s, bf16)) for x, w_q, w_s in xs]
                t["fwd_cublas_bf16"] = cuda_ms(torch.matmul, bfs, iters)
                del bfs
            else:
                t["fwd"] = cuda_ms(lambda q, s, w_q, w_s, w_t: i8.int8_gemm(
                    q, s, w_q, w_s, out_dtype=bf16, w_t=w_t), qs, iters)
                t["fwd_plain"] = cuda_ms(lambda q, s, w_q, w_s, _: i8.int8_gemm_ref(
                    q, s, w_q, w_s, out_dtype=bf16), qs, 10)
            t["dgrad"] = cuda_ms(lambda q, s, w_q: i8.int8_gemm(
                q, s, w_q, dgrad=True, out_dtype=bf16), qds, 20)
            t["dgrad_plain"] = cuda_ms(lambda q, s, w_q: i8.int8_gemm_ref(
                q, s, w_q, dgrad=True, out_dtype=bf16), qds, 10)
            if m > 16:  # torch._int_mm refuses M <= 16
                t["fwd_lib"] = cuda_ms(lambda q, s, w_q, w_s, _: (
                    torch._int_mm(q, w_q).float() * s * w_s).to(bf16), qs, iters)
                wts = [w_q.t().contiguous() for _, _, w_q in qds]
                t["dgrad_lib"] = cuda_ms(lambda q, s, wt: (
                    torch._int_mm(q, wt).float() * s).to(bf16),
                    [(q, s, wt) for (q, s, _), wt in zip(qds, wts)], 20)
                del wts
            # the forward's bound: x (bf16 for the thin product, else q and
            # its scales), the weight, its scales and the output, once each
            x_bytes = m * k * 2 if thin else m * k + m * 4
            bound = roofline(x_bytes + k * n + n * 4 + m * n * 2, 2 * m * k * n, "int8")
            d_bound = roofline(m * n + m * 4 + k * n + m * k * 2, 2 * m * k * n, "int8")
            line += (" | " + ", ".join(f"{key} {v:.4f} ms" for key, v in t.items())
                     + f", bound fwd {bound['bound_ms']:.4f} ms ({bound['bound_by']}), dgrad "
                     f"{d_bound['bound_ms']:.4f} ms")
            if (m, k, n) == entries[0]:
                res["fwd"].update(ms=t["fwd"], plain_ms=t["fwd_plain"],
                                  library_ms=t["fwd_lib"], **bound)
                res["dgrad"].update(ms=t["dgrad"], plain_ms=t["dgrad_plain"],
                                    library_ms=t["dgrad_lib"], **d_bound)
            if (m, k, n) == entries[1]:
                res["thin"].update(ms=t["fwd"], plain_ms=t["fwd_plain"],
                                   library_ms=t["fwd_cublas_bf16"], **bound)
        print(line, flush=True)
    if profiled:
        for what, fn, word in profiles:
            one_launch(what, fn, word, 1)
        print(f"phase {phase} K8: one device event a call in each of the {len(profiles)} "
              "products", flush=True)
    return res


def k2_inputs(g, dev, n: int, d: int, h: int) -> tuple:
    """Phase 2j's inputs at (n, d, h): x, w1q, s1, b1, w2q, s2, b2, dy
    (whisper-like int8 linears, bf16 activations)."""
    w1q, s1, b1 = int8_weight(g, dev, d, h)
    w2q, s2, b2 = int8_weight(g, dev, h, d)
    x = torch.randn(n, d, generator=g).to(dev, torch.bfloat16)
    dy = torch.randn(n, d, generator=g).to(dev, torch.bfloat16)
    return x, w1q, s1, b1, w2q, s2, b2, dy


def k2_agreement(shape, inputs, y, dx) -> tuple[str, float, float]:
    """K2f's y and K2b's dx against the plain versions (float32 on the same
    inputs), held to KERNEL_RTOL; and no element may differ from the plain
    version rounded to the output's dtype (both sum exact int32 products,
    divide by the same scales and repeat the same float32 epilogue): (the
    readout, K2f's and K2b's max abs error)."""
    from agacs_tpu_torch.ops import int8_mlp

    x, w1q, s1, b1, w2q, s2, b2, dy = inputs
    y_ref = int8_mlp.int8_mlp_fwd_ref(x.float(), w1q, s1, b1, w2q, s2, b2)
    dx_ref = int8_mlp.int8_mlp_bwd_ref(x.float(), w1q, s1, b1, w2q, s2, dy.float())
    f_diff, b_diff = differ(y, y_ref), differ(dx, dx_ref)
    check(f_diff == 0 and b_diff == 0, f"K2 {shape}: K2f {f_diff:.3e}, K2b {b_diff:.3e} of "
                                       "elements differ from plain")
    err = hold("K2f", y, y_ref, shape)
    b_err = hold("K2b", dx, dx_ref, shape)
    return (f"K2f max_abs_err {err:.3e} ({err / y_ref.abs().max().item():.2e} of max|plain|, "
            f"{f_diff:.4%} of elements differ), K2b {b_err:.3e} "
            f"({b_err / dx_ref.abs().max().item():.2e}, {b_diff:.4%}) (bound "
            f"{KERNEL_RTOL} x max|plain f32|; no element may differ)", err, b_err)


def check_k2(dev, g, timed=True) -> dict:
    """Phase 2j: K2f and K2b against their plain versions at K2_SHAPES.
    Each is called twice after the L2 is evicted (a ring slot read before
    its copy landed then shows) and must give bit-identical outputs, one
    device event a call; no element may differ from the plain version
    (`k2_agreement`). Timed beside the kernels: the plain versions and
    cuBLAS `torch._int_mm` on the same int8 products (K2f's two, K2b's
    three, in one call each; products only, no quantisation or epilogue).
    Returns errors and times at (12000, 768, 3072)."""
    from agacs_tpu_torch.ops import int8_linear as i8
    from agacs_tpu_torch.ops import int8_mlp

    res = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}}
    for n, d, h in K2_SHAPES:
        sets = [k2_inputs(g, dev, n, d, h) for _ in range((2 if n >= 6000 else 4) if timed else 1)]
        sets = [(*a, i8.transposed(a[1], a[4])) for a in sets]
        x, w1q, s1, b1, w2q, s2, b2, dy, wt = sets[0]
        shape = (n, d, h)
        fwd = lambda: int8_mlp._fwd_kernel(x, w1q, s1, b1, w2q, s2, b2, wt)  # noqa: E731
        bwd = lambda: int8_mlp._bwd_kernel(x, w1q, s1, b1, w2q, s2, dy, wt)  # noqa: E731
        cold_l2(dev)
        y = twice(f"K2f {shape}", fwd)
        cold_l2(dev)
        dx = twice(f"K2b {shape}", bwd)
        agree, err, b_err = k2_agreement(shape, sets[0][:8], y, dx)
        one_launch(f"K2f {shape}", lambda: (fwd(), fwd()), "mlp_fwd_kernel", 2)
        one_launch(f"K2b {shape}", lambda: (bwd(), bwd()), "mlp_bwd_kernel", 2)
        res["fwd"]["err"] = max(res["fwd"]["err"], err)
        res["bwd"]["err"] = max(res["bwd"]["err"], b_err)
        tf, tb = int8_mlp.mlp_tiling(d, h, False), int8_mlp.mlp_tiling(d, h, True)
        line = (f"phase 2j K2 int8_mlp {shape} (cluster {tf['C']}, {tf['units']} units a "
                f"rank, ring {tf['S']}/{tb['S']}, smem {tf['smem']}/{tb['smem']} B): bit-"
                f"identical twice after an L2 eviction, one launch a call; {agree}")
        if timed:
            fsets = [(*a[:7], a[8]) for a in sets]
            bsets = [(*a[:6], a[7], a[8]) for a in sets]
            lsets = [(i8.rowquant(a[0])[0], i8.rowquant(a[7], a[5])[0],
                      torch.randint(-127, 128, (n, h), generator=g, dtype=torch.int8).to(dev),
                      a[1], a[4], *a[8]) for a in sets]
            t = {"fwd": cuda_ms(int8_mlp._fwd_kernel, fsets, 10),
                 "fwd_plain": cuda_ms(lambda *a: int8_mlp.int8_mlp_fwd_ref(*a[:7]), fsets, 3),
                 "fwd_int_mm": cuda_ms(lambda xq, dq, gq, w1q, w2q, w1t, w2t: (
                     torch._int_mm(xq, w1q), torch._int_mm(gq, w2q)), lsets, 10),
                 "bwd": cuda_ms(int8_mlp._bwd_kernel, bsets, 10),
                 "bwd_plain": cuda_ms(lambda *a: int8_mlp.int8_mlp_bwd_ref(*a[:7]), bsets, 3),
                 "bwd_int_mm": cuda_ms(lambda xq, dq, gq, w1q, w2q, w1t, w2t: (
                     torch._int_mm(xq, w1q), torch._int_mm(dq, w2t), torch._int_mm(gq, w1t)),
                     lsets, 10)}
            w_bytes = 2 * d * h + 4 * (2 * h + 2 * d)
            bound = {"fwd": roofline(2 * n * d * 2 + w_bytes, 4 * n * d * h, "int8"),
                     "bwd": roofline(3 * n * d * 2 + w_bytes, 6 * n * d * h, "int8")}
            line += (" | " + ", ".join(f"{key} {v:.4f} ms" for key, v in t.items())
                     + f", bound fwd {bound['fwd']['bound_ms']:.4f} ms, bwd "
                     f"{bound['bwd']['bound_ms']:.4f} ms ({bound['fwd']['bound_by']})")
            if shape == K2_SHAPES[0]:
                for key in ("fwd", "bwd"):
                    res[key].update(ms=t[key], plain_ms=t[key + "_plain"],
                                    library_ms=t[key + "_int_mm"], **bound[key])
            del fsets, bsets, lsets
        del sets
        print(line, flush=True)
    return res


# The conformer recipe's encoder attention: d 256, 4 heads of 64.
CD, CH = 256, 4
# K5 against its plain version at the conformer encoder's 8 x 15 s shape
# and at T 64, 67 (a partial key tile), 128, 129 and 257 (the edges of the
# kernels' 128-row tiles) and 640 (the envelope's top).
K5_TAILS = ((2, 64), (2, 67), (2, 128), (2, 129), (2, 257), (2, 640))
K5_SHAPES = ((8, 468), *K5_TAILS)
# K5 at the other head widths (d, heads): d_head 32 (d 256, 8 heads), 128
# (the XLarge conformer's 1024 / 8) and two padded widths, 48 (384 / 8, run
# at the 64 instance) and 96 (768 / 8, at the 128 instance), each at the
# serving shape (8, 468) and the ragged T 67 and 257; timed at d_head 128
# and 32.
K5_WIDTHS = ((256, 8), (1024, 8), (384, 8), (768, 8))
K5_WIDTH_SHAPES = ((8, 468), (2, 67), (2, 257))
K5_WIDTH_TIMED = ((1024, 8), (256, 8))
# K5's wide route (heads above 128, zero-padded to a multiple of 128 and
# streamed in 128-wide chunks): d_head 160 (640 / 4, padded to 256), 256
# (1024 / 4 and 256 / 1), 384 (768 / 2), 512 (512 / 1) and 1024 (1024 / 1)
# at T 67 and 257; timed at (8, 468, 1024) with 4 heads (the bound of the
# 128 instance's (8, 468, 1024) row: the same 6 b h T^2 d_head) and at
# (16, 468, 256) with 1 head (phase 51's training shape).
K5_WIDE = ((640, 4), (1024, 4), (256, 1), (768, 2), (512, 1), (1024, 1))
K5_WIDE_SHAPES = ((2, 67), (2, 257))
K5_WIDE_TIMED = ((8, 468, 1024, 4), (16, 468, 256, 1))
# K3-f32 against its plain version (both float32; they differ by summation
# order, ~1e-6 of the largest output): 1e-4 x max |plain|.
K3F32_RTOL = 1e-4


def k5_inputs(g, dev, b: int, t: int, d: int = CD):
    """bf16 (qu, qv, k, v, pe, mask) for K5 at (b, t, d): qu and k as
    sharp_qkv's (content scores ~-8 +- 2.7 at d_head 64), qv and pe with a std of 1.5
    (position scores +- 2.3, as large as the content scores' spread, so a
    wrong pe row or shift moves the output), the projected pe padded to
    128 rows, row i's keys valid up to t - i*t/(2b); and a copy of k and v
    poisoned past each row's length (k = 0, a score far above the valid
    ones; v = 1e4)."""
    from agacs_tpu_torch.ops import relpos_flash

    qu, k, v = sharp_qkv(g, dev, (b, t, d), (b, t, d))
    qv = (torch.randn(b, t, d, generator=g) * 1.5).to(dev, torch.bfloat16)
    pe = relpos_flash.pad_pe(
        (torch.randn(2 * t - 1, d, generator=g) * 1.5).to(dev, torch.bfloat16), t)
    lens = [t - i * t // (2 * b) for i in range(b)]
    mask = torch.where(torch.arange(t)[None, :] < torch.tensor(lens)[:, None], 0.0,
                       relpos_flash.NEG_MASK).float().to(dev)
    k_bad, v_bad = k.clone(), v.clone()
    for i, n in enumerate(lens):
        k_bad[i, n:], v_bad[i, n:] = 0.0, 1e4
    return (qu, qv, k, v, pe, mask), (qu, qv, k_bad, v_bad, pe, mask)


def relpos_sdpa_bias(qu, qv, pe, mask, h: int) -> torch.Tensor:
    """(B, h, T, T) bf16 additive bias for SDPA: the shifted position scores
    qv . pe[T-1-q+j] times d_head^-0.5, plus the key mask."""
    from agacs_tpu_torch.models.conformer import rel_shift

    t = qu.shape[1]
    peh = sdpa_heads(pe[None, : 2 * t - 1], h)[0]  # (h, 2T-1, d_head)
    bd = rel_shift(sdpa_heads(qv, h).float() @ peh.float().transpose(-1, -2))
    return (bd * k5_scale(qu, h) + mask[:, None, None, :]).to(torch.bfloat16)


def k5_scale(x, h: int) -> float:
    """d_head^-0.5 of a packed (..., h * d_head) tensor."""
    return (x.shape[-1] // h) ** -0.5


def k5_cases(shapes=None) -> list:
    """(b, t, d, heads, timed) of phases 2r and 2s: the recipe's d 256 / 4
    heads at `shapes` (K5_SHAPES; timed at the first), K5_WIDTHS at
    K5_WIDTH_SHAPES (timed at K5_WIDTH_TIMED's widths' first shape), then
    the wide route: K5_WIDE at K5_WIDE_SHAPES and K5_WIDE_TIMED (timed)."""
    shapes = shapes or K5_SHAPES
    return ([(b, t, CD, CH, (b, t) == shapes[0]) for b, t in shapes]
            + [(b, t, d, h, (d, h) in K5_WIDTH_TIMED and (b, t) == K5_WIDTH_SHAPES[0])
               for d, h in K5_WIDTHS for b, t in K5_WIDTH_SHAPES]
            + [(b, t, d, h, False) for d, h in K5_WIDE for b, t in K5_WIDE_SHAPES]
            + [(b, t, d, h, True) for b, t, d, h in K5_WIDE_TIMED])


def k5_slot(res: dict, d: int, h: int) -> dict:
    """Where phases 2r and 2s keep a case's readings: d 256 / 4 heads at the
    top, d_head 128 and 32 under "w128" and "w32", the wide route under
    "wide" (its (8, 468, 1024) timing) but d 256 / 1 head under "wide1"
    (phase 51's width; its (16, 468) timing); the padded 48 and 96 nowhere."""
    dh = d // h
    if (d, h) == (CD, CH):
        return res
    if dh > 128:
        return res["wide1" if (d, h) == (256, 1) else "wide"]
    return res["w128"] if dh == 128 else res["w32"] if dh == 32 else {}


def k5_route(dh: int) -> str:
    """How K5 runs a head of dh on the card, for the printed lines."""
    from agacs_tpu_torch.ops import relpos_flash

    w = relpos_flash.instance(dh)
    if w in relpos_flash.INSTANCES:
        return f"instance {w}"
    return f"wide route: padded to {w}, {w // relpos_flash.CHUNK} chunks of 128"


def k5_design_ops(b: int, t: int, d: int, h: int, bwd: bool) -> int:
    """The tensor-core operations K5 does at (b, t, d, h), counted from its
    tiles (T in 64-row tiles, the head at its padded width W, the position
    block 64 x 128 a 64-key tile): the forward's S and position block once
    per 128-wide output chunk (NC times on the wide route, once at W <= 128)
    and P.V once; the backward's dkdv and dq each recompute S, dP and the
    position block per chunk, then dV, dK (2 units), dQu, dQv and dpe's two
    halves (5 units). A unit is 2 Tp^2 W a head."""
    from agacs_tpu_torch.ops import relpos_flash

    w = relpos_flash.instance(d // h)
    nc = max(1, w // relpos_flash.CHUNK)
    tp = -(-t // 64) * 64
    unit = 2 * b * h * tp * tp * w
    return unit * ((8 * nc + 7) if bwd else (3 * nc + 1))


def check_k5(dev, g, timed=True) -> dict:
    """Phase 2r: K5 (csrc/relpos_flash.cu) against its plain version in
    float32 on the same bf16 inputs, keys and values poisoned past each
    row's length in the kernel's input, at `k5_cases` (every head width:
    the instances 32, 64 and 128 and the padded 48 and 96); bound
    KERNEL_RTOL x max |plain|; each call made twice, bit-identical, one
    launch a call. Times at (8, 468, 256) with 4 and 8 heads and (8, 468,
    1024): the kernel,
    the plain version (on the bf16 inputs), SDPA given the shifted position
    scores and the mask as its materialised (B, h, T, T) additive bias (the
    bias is built outside the timing: `library_ms`, the redesign order's
    yardstick), and the whole PyTorch route, the bias built inside the
    timed call (`route_ms`). Returns d 256's readings, with d_head 128's
    and 32's under "w128" and "w32"."""
    from agacs_tpu_torch.ops import relpos_flash

    res = {"err": 0.0, **{k: {"err": 0.0} for k in ("w128", "w32", "wide", "wide1")}}
    for b, t, d, h, timed_case in k5_cases():
        dh = d // h
        into = k5_slot(res, d, h)
        clean, bad = k5_inputs(g, dev, b, t, d)
        before = relpos_flash.LAUNCHES
        out = twice(f"K5 ({b}, {t}, {d})", relpos_flash.relpos_mha, *bad, h)
        check(relpos_flash.LAUNCHES == before + 2, f"K5 ({b}, {t}, {d}): one launch a call")
        err = hold(f"K5 T={t} d_head={dh}", out,
                   relpos_flash.relpos_mha_plain(*(x.float() for x in clean), h), (b, t, d))
        into["err"] = max(into.get("err", 0.0), err)
        line = (f"phase 2r K5 relpos_flash_fwd ({b}, {t}, {d}) H={h} d_head {dh} "
                f"({k5_route(dh)}): max_abs_err {err:.3e} (bound {KERNEL_RTOL} x "
                "max|plain f32|; keys past each length poisoned), bit-identical twice")
        if timed and timed_case:
            sets = [k5_inputs(g, dev, b, t, d)[0] + (h,) for _ in range(4)]
            ms = cuda_ms(relpos_flash.relpos_mha, sets, 20)
            plain_ms = cuda_ms(relpos_flash.relpos_mha_plain, sets, 5)
            sc = dh ** -0.5
            lib_sets = [(sdpa_heads(qu, h), sdpa_heads(k, h), sdpa_heads(v, h),
                         relpos_sdpa_bias(qu, qv, pe, mask, h))
                        for qu, qv, k, v, pe, mask, _ in sets]
            lib = cuda_ms(lambda q, k, v, bias: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=sc), lib_sets, 20)
            del lib_sets
            route = cuda_ms(lambda qu, qv, k, v, pe, mask, h:
                            torch.nn.functional.scaled_dot_product_attention(
                                sdpa_heads(qu, h), sdpa_heads(k, h), sdpa_heads(v, h),
                                attn_mask=relpos_sdpa_bias(qu, qv, pe, mask, h), scale=sc),
                            sets, 10)
            wp = sets[0][4].shape[0]
            ops = 6 * b * h * t * t * dh
            into.update(ms=ms, plain_ms=plain_ms, library_ms=lib, route_ms=route,
                        design_ops=k5_design_ops(b, t, d, h, False), bound_ops=ops,
                        **roofline(5 * b * t * d * 2 + wp * d * 2 + b * t * 4, ops, "bf16"))
            line += (f" kernel {ms:.4f} ms plain bf16 {plain_ms:.4f} ms sdpa with the "
                     f"materialised bias {lib:.4f} ms, the whole route (bias built, then "
                     f"sdpa) {route:.4f} ms bound {into['bound_ms']:.4f} ms; tensor-core "
                     f"operations done {into['design_ops'] / ops:.2f}x the bound's count")
        print(line, flush=True)
    return res


# K5's backward against its plain version (float32, the same bf16 inputs
# and do) at the conformer's training shape (16 x 15 s: T 468) and at T 64,
# 67 and 640: dqu, dqv, dk, dv and dpe each within K1B_RTOL x its own max
# |plain| (ds rounded to bf16 and summed with mixed signs, as K1b's; dpe
# also sums over the batch).
K5B_SHAPES = ((16, 468), *K5_TAILS)


def k5_bwd_lib(qu, qv, k, v, pe, mask, do, h: int = CH):
    """The library yardstick of K5's backward: SDPA on the split heads with
    the shifted position scores as a materialised (B, h, T, T) bias that
    requires a gradient, run forward once; returns (its output, inputs, do)
    for torch.autograd.grad."""
    ins = [sdpa_heads(x, h).detach().requires_grad_() for x in (qu, k, v)]
    bias = relpos_sdpa_bias(qu, qv, pe, mask, h).detach().requires_grad_()
    o_s = torch.nn.functional.scaled_dot_product_attention(*ins, attn_mask=bias,
                                                           scale=k5_scale(qu, h))
    return o_s, (*ins, bias), sdpa_heads(do, h)


def check_k5_bwd(dev, g, timed=True) -> dict:
    """Phase 2s: K5's backward (relpos_flash.cu: rowdot, dkdv, dq with the
    dpe band) against its plain version evaluated in float32 on the same
    bf16 inputs and do, at K5B_SHAPES (d 256, 4 heads) and K5_WIDTHS at
    K5_WIDTH_SHAPES, keys and values poisoned past each row's length in the
    kernel's input (K5's forward, with its row statistics, runs first on the
    same inputs); a second backward on the same inputs must give
    bit-identical dqu, dqv, dk and dv (dpe sums with float32 atomics, in a
    varying order), one launch a call. Times at (16, 468, 256) and (8, 468)
    at d_head 128 and 32: the kernel, the plain backward on the bf16 inputs,
    and SDPA's backward with the bias requiring a gradient (its forward run
    outside the timing). Returns d 256's readings, d_head 128's and 32's
    under "w128" and "w32"."""
    from agacs_tpu_torch.ops import relpos_flash

    res = {"err": 0.0, **{k: {"err": 0.0} for k in ("w128", "w32", "wide", "wide1")}}
    for b, t, d, h, timed_case in k5_cases(K5B_SHAPES):
        dh = d // h
        into = k5_slot(res, d, h)
        clean, bad = k5_inputs(g, dev, b, t, d)
        do = torch.randn(b, t, d, generator=g).to(dev, torch.bfloat16)
        o, m, l = relpos_flash._launch_fwd(*bad, h, stats=True)
        before = relpos_flash.BWD_LAUNCHES
        got = relpos_flash._launch_bwd(*bad, o, do, m, l, h)
        again = relpos_flash._launch_bwd(*bad, o, do, m, l, h)
        torch.cuda.synchronize()
        check(relpos_flash.BWD_LAUNCHES == before + 2, f"K5 backward ({b}, {t}, {d}): one "
                                                       "launch a call")
        check(all(torch.equal(x, y) for x, y in zip(got[:4], again[:4])),
              f"K5 backward ({b}, {t}, {d}): a second run gives bit-identical dqu, dqv, dk, dv")
        del again
        f32 = [x.float() for x in clean]
        want = relpos_flash.relpos_mha_bwd_plain(
            *f32, relpos_flash.relpos_mha_plain(*f32, h), do.float(), h)
        torch.cuda.synchronize()
        errs = []
        for name, out, ref in zip(("dqu", "dqv", "dk", "dv", "dpe"), got, want):
            err = (out.float() - ref).abs().max().item()
            bound = K1B_RTOL * ref.abs().max().item()
            check(tuple(out.shape) == tuple(ref.shape) and err <= bound,
                  f"K5 backward {name} ({b}, {t}, {d}) H={h}: max_abs_err {err} <= {bound}")
            errs.append(f"{name} {err:.3e} ({err / (bound / K1B_RTOL):.2e} of max|plain|)")
            into["err"] = max(into.get("err", 0.0), err)
        del got, want, f32
        line = (f"phase 2s K5 relpos_flash_bwd ({b}, {t}, {d}) H={h} d_head {dh} "
                f"({k5_route(dh)}): " + ", ".join(errs)
                + f" (bound {K1B_RTOL} x max|plain f32|; keys past each length poisoned; "
                "a second run bit-identical in dqu, dqv, dk, dv)")
        if timed and timed_case:
            sets = []
            for _ in range(3):
                x = k5_inputs(g, dev, b, t, d)[0]
                o, m, l = relpos_flash._launch_fwd(*x, h, stats=True)
                sets.append((*x, o, torch.randn(b, t, d, generator=g).to(dev, torch.bfloat16),
                             m, l))
            ms = cuda_ms(lambda *a: relpos_flash._launch_bwd(*a, h), sets, 10)
            plain_ms = cuda_ms(lambda *a: relpos_flash.relpos_mha_bwd_plain(*a[:8], h), sets, 3)
            try:
                lib_sets = [k5_bwd_lib(*a[:6], a[7], h) for a in sets]
                lib = cuda_ms(lambda o_s, ins, do_s: torch.autograd.grad(
                    o_s, ins, do_s, retain_graph=True), lib_sets, 10)
                lib_line = f"sdpa backward with the bias's gradient {lib:.4f} ms"
            except RuntimeError as e:  # no SDPA backend returns a bias gradient
                lib, lib_line = None, f"sdpa backward: none ({str(e)[:120]})"
            lib_sets = None
            wp = sets[0][4].shape[0]
            # bytes: qu, qv, k, v, o, do read, dqu, dqv, dk, dv written (bf16),
            # pe read and dpe written, the mask and the row statistics read;
            # operations: the recomputed scores (content and position) and
            # dp, dv, dqu, dk, dqv, dpe: 8 products of 2 T^2 d_head a head
            ops = 16 * b * h * t * t * dh
            into.update(ms=ms, plain_ms=plain_ms, library_ms=lib,
                        design_ops=k5_design_ops(b, t, d, h, True), bound_ops=ops,
                        **roofline(10 * b * t * d * 2 + 2 * wp * d * 2 + b * t * 4
                                   + 2 * b * h * t * 4, ops, "bf16"))
            line += (f" kernel {ms:.4f} ms plain bf16 {plain_ms:.4f} ms {lib_line} bound "
                     f"{into['bound_ms']:.4f} ms; tensor-core operations done "
                     f"{into['design_ops'] / ops:.2f}x the bound's count")
            del sets
        print(line, flush=True)
    return res


# K4 against its plain version (float32 on the same bf16 x and W): the
# conformer's training shape (16 x 468 rows, d 256, the Whisper vocabulary)
# and ragged ones (rows not a multiple of 64, V not a multiple of 64) at K
# 256, at K 128 (V not a multiple of 8 either: W's rows padded), above K 256
# at every K from 384 to 1024 (the forward's 64 x 64 chunks, on 64-row
# blocks at K 896 and 1024; dx and dw the split kernels on clusters of 3, 4,
# 5, 6, 7 and 8) and at V 500 (8 V tiles on a cluster of 8: one tile a rank,
# so the forward's last tile is its first). lse within K4_LSE_RTOL relative
# per row, |lse| floored at 1 nat (float32 sums of exps in another order);
# dx and dW within KERNEL_RTOL x max |plain| (bf16 dz, bf16 outputs); db
# within K4_DB_RTOL x max |plain| (float32 column sums). K4_WIDE: the
# whisper CTC head's shape (K 768, 12000 rows: 16 x 15 s at 750 frames),
# the same bounds.
K4_SHAPES = ((7488, 256, 51865), (700, 256, 5000), (300, 128, 1001), (300, 384, 1001),
             (700, 512, 5000), (200, 640, 1001), (700, 768, 5000), (300, 896, 2000),
             (300, 1024, 1001), (60, 128, 500))
K4_WIDE = (12000, 768, 51865)
K4_LSE_RTOL, K4_DB_RTOL = 1e-4, 1e-4
# Phase 2v above K 1280 (the same bounds): the CTC head of phase 52's
# conformer at USM-2B's width, 16 x 468 rows (16 x 15 s at 468 encoder
# frames, phase 52's step) of d 1536 (KS-256 slices on a cluster of 6, the
# forward's resident rows at their limit); a ragged K 1400
# (padded to 1536); K 2048 (a cluster of 8; the forward streams x); and K
# 4224 (padded to 4608: 2 groups of 9 ranks, each recomputing S over the
# whole K). Each timed beside its plain version and cuBLAS with the logits.
K4_USM = (7488, 1536, 51865)
K4_ANY_SHAPES = (K4_USM, (700, 1400, 5000), (3000, 2048, 51865), (300, 4224, 1001))
K4_ANY_TIMED = (K4_USM, (3000, 2048, 51865), (300, 4224, 1001))


def poisoned(t: torch.Tensor, extra: int = 128) -> torch.Tensor:
    """t (1-D) as the first entries of a buffer whose `extra` others hold
    NaN: a kernel that reads past its end (b past V, lse or g past N) gives
    NaN."""
    buf = torch.full((t.numel() + extra,), float("nan"), device=t.device, dtype=t.dtype)
    buf[:t.numel()] = t
    return buf[:t.numel()]


def k4_inputs(g, dev, n: int, k: int, v: int):
    """bf16 x (N, K) and W (K, V) with products of std ~3 (a peaked
    softmax), f32 b with mean -20 and std 1, and g (the loss's d/d lse,
    std 1). Every real logit sits below 0, so a padded column counted with
    its zero logit would dominate the lse."""
    x = torch.randn(n, k, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(k, v, generator=g) * 3 / k ** 0.5).to(dev, torch.bfloat16)
    b = torch.randn(v, generator=g) - 20
    return x, w, b.to(dev), torch.randn(n, generator=g).to(dev)


def k4_lib(x, w, b, lse=None, g=None, part="fwd"):
    """The library yardsticks of K4, cuBLAS with the (N, V) logits
    materialised in float32: logsumexp(x W + b); bf16(dz) W^T; x^T bf16(dz)
    and the column sums of dz, dz recomputed from the logits."""
    z = torch.mm(x, w).float() + b
    if part == "fwd":
        return torch.logsumexp(z, -1)
    dz = torch.exp(z - lse[:, None]) * g[:, None]
    if part == "dx":
        return torch.mm(dz.to(w.dtype), w.t())
    return torch.mm(x.t(), dz.to(x.dtype)), dz.sum(0)


def k4_times(g, dev, shape, gr, n_sets: int, iters: dict, line: str) -> tuple[dict, str]:
    """K4's forward, dx and dw timed at `shape` (the padded W handed in,
    as the step hands it over), each beside its plain version (bf16
    inputs), its cuBLAS yardstick (k4_lib) and its bound; W's padding copy
    timed alone and added to the forward's time ("kernel + copy", the
    wrapper's cost when no copy is handed in). `n_sets` sets of inputs
    (larger than the L2 together); `iters`: the kernels' calls by part.
    Returns ({part: results}, line extended)."""
    from agacs_tpu_torch.ops import vocab_lse

    n, k, v = shape
    res = {}
    sets = [k4_inputs(g, dev, n, k, v)[:3] for _ in range(n_sets)]
    bw = [(*s, vocab_lse.lse_plain(*s), gr, vocab_lse._rows8(s[1]), vocab_lse._pad_x(s[0]))
          for s in sets]
    pad_ms = cuda_ms(lambda *a: vocab_lse._rows8(a[1]), bw, 20)
    io = n * k * 2 + k * v * 2 + v * 4
    ops = 2 * n * k * v
    for part, kern, plain, lib_fn, nbytes, nops in (
            ("fwd", lambda *a: vocab_lse._launch_fwd(*a[:3], wp=a[5], xp=a[6]),
             lambda *a: vocab_lse.lse_plain(*a[:3]), lambda *a: k4_lib(*a[:3]), io + n * 4, ops),
            ("dx", lambda *a: vocab_lse._launch_dx(*a[:5], wp=a[5], xp=a[6]),
             lambda *a: vocab_lse.lse_bwd_plain(*a[:5])[0],
             lambda *a: k4_lib(*a[:5], part="dx"), io + 8 * n + n * k * 2, 2 * ops),
            ("dw", lambda *a: vocab_lse._launch_dw(*a[:5], wp=a[5], xp=a[6]),
             lambda *a: vocab_lse.lse_bwd_plain(*a[:5])[1:],
             lambda *a: k4_lib(*a[:5], part="dw"), io + 8 * n + k * v * 2 + v * 4, 2 * ops)):
        ms = cuda_ms(kern, bw, iters[part])
        plain_ms = cuda_ms(plain, bw, min(3, iters[part]))
        lib = cuda_ms(lib_fn, bw, min(3, iters[part]))
        res[part] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                     **roofline(nbytes, nops, "bf16")}
        line += (f"; {part} kernel {ms:.4f} ms plain {plain_ms:.4f} ms cuBLAS+logits "
                 f"{lib:.4f} ms bound {res[part]['bound_ms']:.4f} ms")
        if part == "fwd":
            line += f" (kernel + W's padding copy {ms + pad_ms:.4f} ms)"
    return res, line + f"; W's rows padded (once a step) {pad_ms:.4f} ms"


def k4_errors(name_out_ref: tuple, n: int, k: int, v: int, res: dict | None = None) -> dict:
    """Each (part, name, out, ref, rtol) held against its bound (rtol None:
    lse, relative per row): finite, the plain version's shape, within the
    bound; {name: max_abs_err}, the parts' largest also into `res`."""
    errs = {}
    for part, name, out, ref, rtol in name_out_ref:
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        if rtol is None:  # relative per row, |lse| floored at 1 nat
            ok = bool((diff <= K4_LSE_RTOL * ref.abs().clamp(min=1.0)).all())
            bound = f"{K4_LSE_RTOL} x max(|lse|, 1) per row"
        else:
            bound = rtol * ref.abs().max().item()
            ok = err <= bound
        check(tuple(out.shape) == tuple(ref.shape) and ok and bool(torch.isfinite(out).all()),
              f"K4 {name} ({n}, {k}) x ({k}, {v}): finite, max_abs_err {err} <= {bound}")
        errs[name] = err
        if res is not None:
            res[part]["err"] = max(res[part]["err"], err)
    return errs


def k4_backward_tiling(n: int, k: int, v: int, sms: int) -> str:
    from agacs_tpu_torch.ops import vocab_lse

    tx, tw = vocab_lse.dx_tiling(n, k, v, sms), vocab_lse.dw_tiling(k)
    if tx["route"] == "split":
        groups = f", {tx['G']} groups recomputing S" if tx.get("G", 1) > 1 else ""
        return (f"backward split (dx and dw on clusters of C {tx['C']}, KS {tx['KS']}{groups}; "
                f"dx block {tx.get('BM', vocab_lse.DX_BM)} rows, dw block {tw['BV']} columns)")
    return f"backward {tx['route']} (dx C {tx['C']}; dw block {tw['BV']} columns)"


def check_k4(dev, g, timed=True) -> dict:
    """Phase 2v: K4's forward, dx and dw (csrc/vocab_lse.cu) against their
    plain versions at K4_SHAPES; when timed, their times at the training
    shape (`k4_times`) and the passes at K4_WIDE (`k4_wide`); then
    `k4_shapes` at K4_ANY_SHAPES (above K 1280; timed at K4_ANY_TIMED).
    Returns {"fwd", "dx", "dw"} results at the training shape (errors at K
    <= 256), "any": {K: results} at K4_ANY_TIMED when timed, and, when
    timed, "wide": K4_WIDE's times with the largest errors from K 384 to
    1024."""
    from agacs_tpu_torch.ops import vocab_lse

    res = {part: {"err": 0.0} for part in ("fwd", "dx", "dw")}
    split = {part: {"err": 0.0} for part in ("fwd", "dx", "dw")}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, k, v in K4_SHAPES:
        x, w, b, gr = k4_inputs(g, dev, n, k, v)
        b, gr = poisoned(b), poisoned(gr)
        lse = poisoned(vocab_lse._launch_fwd(x, w, b))
        dx = vocab_lse._launch_dx(x, w, b, lse, gr)
        dw, db = vocab_lse._launch_dw(x, w, b, lse, gr)
        # a second run, bit-identical: the cluster's pairs and partials are
        # merged in rank order and nothing is added atomically
        lse2 = vocab_lse._launch_fwd(x, w, b)
        dx2 = vocab_lse._launch_dx(x, w, b, lse, gr)
        dw2, db2 = vocab_lse._launch_dw(x, w, b, lse, gr)
        lse_p = vocab_lse.lse_plain(x.float(), w.float(), b)
        dx_p, dw_p, db_p = vocab_lse.lse_bwd_plain(x.float(), w.float(), b, lse_p, gr)
        torch.cuda.synchronize()
        errs = k4_errors((("fwd", "lse", lse, lse_p, None), ("dx", "dx", dx, dx_p, KERNEL_RTOL),
                          ("dw", "dW", dw, dw_p, KERNEL_RTOL), ("dw", "db", db, db_p, K4_DB_RTOL)),
                         n, k, v, split if k > vocab_lse.HK_MAX else res)
        check(torch.equal(lse, lse2) and torch.equal(dx, dx2) and torch.equal(dw, dw2)
              and torch.equal(db, db2),
              f"K4 lse, dx and dw ({n}, {k}) x ({k}, {v}): a second run bit-identical")
        del lse2, dx2, dw2, db2
        tf = vocab_lse.fwd_tiling(n, k, v, sms)
        line = (f"phase 2v K4 vocab_lse ({n}, {k}) x ({k}, {v}): max_abs_err "
                + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
                + f" (bounds lse {K4_LSE_RTOL} relative, dx/dW {KERNEL_RTOL} and db "
                f"{K4_DB_RTOL} x max|plain f32|), all finite; b, lse and g NaN past their "
                f"ends; lse, dx and dw bit-identical on a second run; forward "
                f"{tf['route']} (BM {tf['BM']}, C {tf['C']}); "
                + k4_backward_tiling(n, k, v, sms))
        if timed and (n, k, v) == K4_SHAPES[0]:
            times, line = k4_times(g, dev, (n, k, v), gr, 2, {"fwd": 10, "dx": 20, "dw": 20},
                                   line)
            for part in res:
                res[part].update(times[part])
        print(line, flush=True)
        torch.cuda.empty_cache()
    if timed:  # the K > 256 rows: K4_WIDE's times, the largest error above K 256
        res["wide"] = k4_wide(g, dev, sms)
        for part, r in split.items():
            res["wide"][part]["err"] = max(res["wide"][part]["err"], r["err"])
    # above K 1280: {K: results} at the timed shapes
    res["any"] = {shape[1]: r for shape, r in k4_shapes(
        g, dev, K4_ANY_SHAPES, K4_ANY_TIMED if timed else (), "2v").items()
        if shape in K4_ANY_TIMED}
    return res


def k4_waves(n: int, k: int, v: int) -> str:
    """The clusters of the split dx and dw kernels at K that the card holds
    at once (`vocab_lse_split_clusters`, which must be > 0), and the waves
    their tiles take at (N, V)."""
    from agacs_tpu_torch.ops import cuda_lib, vocab_lse

    waves = []
    tx, tw = vocab_lse.dx_tiling(n, k, v, 132), vocab_lse.dw_tiling(k)
    groups = tx.get("G", 1)
    for part, dw_flag, tiles in (("dx", 0, -(-n // tx.get("BM", vocab_lse.DX_BM)) * groups),
                                 ("dw", 1, -(-v // tw["BV"]) * groups)):
        held = cuda_lib.load("vocab_lse", "vocab_lse_split_clusters",
                             [ctypes.c_int, ctypes.c_int])(k, dw_flag)
        check(held > 0, f"the card holds clusters of the split {part} kernel at K {k}: {held}")
        waves.append(f"{part} {tiles} tiles x C {tx['C']} on {held} clusters at once: "
                     f"{-(-tiles // held)} waves ({tiles / (-(-tiles // held) * held):.1%} full)")
    return "; ".join(waves)


def k4_wide(g, dev, sms: int) -> dict:
    """Phase 2v at K4_WIDE, the whisper CTC head's shape: the forward, dx and
    dw (b and g NaN past their ends) against their plain versions, then
    timed as at the training shape (`k4_times`), and the clusters of the
    split kernels the card holds at once, with the waves their tiles take.
    Returns {"fwd", "dx", "dw"} results."""
    from agacs_tpu_torch.ops import vocab_lse

    n, k, v = K4_WIDE
    res = {part: {"err": 0.0} for part in ("fwd", "dx", "dw")}
    x, w, b, gr = k4_inputs(g, dev, n, k, v)
    b, gr = poisoned(b), poisoned(gr)
    lse = vocab_lse._launch_fwd(x, w, b)
    dx = vocab_lse._launch_dx(x, w, b, lse, gr)
    dw, db = vocab_lse._launch_dw(x, w, b, lse, gr)
    lse_p = vocab_lse.lse_plain(x, w, b)
    dx_p, dw_p, db_p = vocab_lse.lse_bwd_plain(x, w, b, lse_p, gr)
    torch.cuda.synchronize()
    errs = k4_errors((("fwd", "lse", lse, lse_p, None), ("dx", "dx", dx, dx_p, KERNEL_RTOL),
                      ("dw", "dW", dw, dw_p, KERNEL_RTOL), ("dw", "db", db, db_p, K4_DB_RTOL)),
                     n, k, v, res)
    del dx_p, dw_p, db_p, lse_p
    torch.cuda.empty_cache()
    tf = vocab_lse.fwd_tiling(n, k, v, sms)
    line = (f"phase 2v K4 vocab_lse {K4_WIDE} (the whisper CTC head): max_abs_err "
            + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
            + f" (the bounds above), all finite; forward {tf['route']} (BM {tf['BM']}, C "
            f"{tf['C']}); " + k4_backward_tiling(n, k, v, sms) + "; " + k4_waves(n, k, v))
    times, line = k4_times(g, dev, K4_WIDE, gr, 1, {"fwd": 10, "dx": 20, "dw": 20}, line)
    for part in res:
        res[part].update(times[part])
    print(line, flush=True)
    del x, w, b, gr, lse, dx, dw, db
    torch.cuda.empty_cache()
    return res


def k4_shapes(g, dev, shapes, timed, phase: str, iters: int = 5, profiled=()) -> dict:
    """K4's forward, dx and dw at each (N, K, V) of `shapes` against their
    plain versions (phase 2v's bounds; b, lse and g NaN past their ends),
    each wrapper call one launch (its count, and at the `profiled` shapes
    one device event under the profiler), bit-identical on a second run;
    the clusters the card holds with the waves their tiles take; the
    `timed` shapes timed as at the training shape (`k4_times`, `iters`
    calls). Returns {(N, K, V): {"fwd", "dx", "dw"} results}."""
    from agacs_tpu_torch.ops import vocab_lse

    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, k, v in shapes:
        res = {part: {"err": 0.0} for part in ("fwd", "dx", "dw")}
        x, w, b, gr = k4_inputs(g, dev, n, k, v)
        b, gr = poisoned(b), poisoned(gr)
        wp, xp = vocab_lse._rows8(w), vocab_lse._pad_x(x)
        before = k4_counts()
        lse = poisoned(vocab_lse._launch_fwd(x, w, b, wp, xp))
        dx = vocab_lse._launch_dx(x, w, b, lse, gr, wp, xp)
        dw, db = vocab_lse._launch_dw(x, w, b, lse, gr, wp, xp)
        lse2 = vocab_lse._launch_fwd(x, w, b, wp, xp)
        dx2 = vocab_lse._launch_dx(x, w, b, lse, gr, wp, xp)
        dw2, db2 = vocab_lse._launch_dw(x, w, b, lse, gr, wp, xp)
        calls = {key: c - before[key] for key, c in k4_counts().items()}
        check(calls == {"K4": 2, "K4 dx": 2, "K4 dw": 2},
              f"K4 ({n}, {k}): one launch of each pass a call, {calls}")
        lse_p = vocab_lse.lse_plain(x.float(), w.float(), b)
        dx_p, dw_p, db_p = vocab_lse.lse_bwd_plain(x.float(), w.float(), b, lse_p, gr)
        torch.cuda.synchronize()
        errs = k4_errors((("fwd", "lse", lse, lse_p, None), ("dx", "dx", dx, dx_p, KERNEL_RTOL),
                          ("dw", "dW", dw, dw_p, KERNEL_RTOL), ("dw", "db", db, db_p, K4_DB_RTOL)),
                         n, k, v, res)
        check(torch.equal(lse, lse2) and torch.equal(dx, dx2) and torch.equal(dw, dw2)
              and torch.equal(db, db2),
              f"K4 lse, dx and dw ({n}, {k}) x ({k}, {v}): a second run bit-identical")
        del lse2, dx2, dw2, db2, lse_p, dx_p, dw_p, db_p
        torch.cuda.empty_cache()
        kp = vocab_lse.padded_k(k)
        tf = vocab_lse.fwd_tiling(n, kp, v, sms)
        line = (f"phase {phase} K4 vocab_lse ({n}, {k}) x ({k}, {v})"
                + (f", K padded to {kp}" if kp != k else "") + ": max_abs_err "
                + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
                + f" (phase 2v's bounds), all finite; b, lse and g NaN past their ends; "
                f"bit-identical on a second run; one launch of each pass a call; forward "
                f"{tf['route']} (BM {tf['BM']}, C {tf['C']}); "
                + k4_backward_tiling(n, kp, v, sms) + "; " + k4_waves(n, kp, v))
        if (n, k, v) in profiled:
            for part, fn, word in (
                    ("fwd", lambda: vocab_lse._launch_fwd(x, w, b, wp, xp), "vocab_lse_fwd"),
                    ("dx", lambda: vocab_lse._launch_dx(x, w, b, lse, gr, wp, xp),
                     "vocab_lse_split_kernel<false"),
                    ("dw", lambda: vocab_lse._launch_dw(x, w, b, lse, gr, wp, xp),
                     "vocab_lse_split_kernel<true")):
                # the wrapper's own copies (dw's cast to w's dtype) aside
                exact_profile(f"K4 {part} at K {k}: one {word} device event a call", fn,
                              lambda word=word: {word: 1})
            line += "; one kernel event a call (profiled)"
        if (n, k, v) in timed:
            times, line = k4_times(g, dev, (n, k, v), gr, 1,
                                   {"fwd": iters, "dx": iters, "dw": iters}, line)
            for part in res:
                res[part].update(times[part])
        out[(n, k, v)] = res
        print(line, flush=True)
        del x, w, b, gr, wp, xp, lse, dx, dw, db
        torch.cuda.empty_cache()
    return out


# `--k4-ablate`: the split kernels at K4_WIDE with parts of their exchange
# taken out, each an edit of csrc/vocab_lse.cu built outside the checkout as
# `--mutants` builds: timing only (their outputs are wrong), to show what
# the exchange costs. Each keeps the barriers' byte counts whole: without
# the all-gather a rank's P reaches only itself, without the reduce-scatter
# a partial reaches only its own rank, and without the exchange nothing
# crosses the cluster and no exchange barrier is waited on.
K4_NO_GATHER = [("      if (r < C) hop::st_async(dst, pv, bar, r);",
                 "      if (r == rank) hop::st_async(dst, pv, bar, r);"),
                ("p_bytes = 32 * PBLK;", "p_bytes = nq * PBLK;")]
K4_NO_SCATTER = [("  const int q = tw >> 2, t = tw & 3, o = quad_owner(q, C);\n",
                  "  const int q = tw >> 2, t = tw & 3, o = quad_owner(q, C);\n  if (o != rank) return;\n"),
                 ("s_bytes = C * nq * QBLK,", "s_bytes = nq * QBLK,")]
# The same exchange with fewer of its bytes: a thread sends 4 or 1 of its 8
# float4 of partials, or 1 lane in 8 stores P, and the barriers await that
# many bytes (does a part's cost follow its bytes?).
K4_SCATTER_PART = [("  for (int j = 0; j < 8; ++j)\n    hop::st_async(dst + quad_at(t, j, q),",
                    "  for (int j = 0; j < {j}; ++j)\n    hop::st_async(dst + quad_at(t, j, q),"),
                   ("s_bytes = C * nq * QBLK,", "s_bytes = C * nq * QBLK / {d},")]
K4_ABLATIONS = {
    "as built": [],
    "no all-gather of P": K4_NO_GATHER,
    "no reduce-scatter of the partials": K4_NO_SCATTER,
    "the reduce-scatter at half its bytes": [(o, n.format(j=4, d=2)) for o, n in K4_SCATTER_PART],
    "the reduce-scatter at an eighth of its bytes": [(o, n.format(j=1, d=8))
                                                     for o, n in K4_SCATTER_PART],
    "the all-gather at an eighth of its bytes": [
        ("      if (r < C) hop::st_async(dst, pv, bar, r);",
         "      if (r < C && (lane & 7) == 0) hop::st_async(dst, pv, bar, r);"),
        ("p_bytes = 32 * PBLK;", "p_bytes = 32 * PBLK / 8;")],
    "no exchange": [
        ("    hop::mbar_wait_cluster(&sfull[x * NWG + wg], (it >> 1) & 1);\n", ""),
        ("    if (lead) hop::mbar_expect_tx(&sfull[x * NWG + wg], s_bytes);  // tile it + 2's\n", ""),
        ("      hop::mbar_wait_cluster(&pfull[(x ^ 1) * NWG + wg], ((it - 1) >> 1) & 1);\n", ""),
        ("      if (lead) hop::mbar_expect_tx(&pfull[(x ^ 1) * NWG + wg], p_bytes);  // tile it + 1's\n",
         ""),
        ("    hop::mbar_wait_cluster(&pfull[x * NWG + wg], ((nt - 1) >> 1) & 1);\n", ""),
        ("  for (int j = 0; j < 8; ++j)\n    hop::st_async(", "  for (int j = 0; j < 0; ++j)\n    hop::st_async("),
        ("    if (lq >= nq) break;\n    float4 z;", "    if (true) break;\n    float4 z;")],
}


def k4_ablate(dev) -> None:
    """Each K4_ABLATIONS edit built in a temp dir and its dx and dw timed at
    K4_WIDE (10 calls each, `cuda_ms`)."""
    import shutil
    import tempfile
    from pathlib import Path

    from agacs_tpu_torch.ops import cuda_lib, vocab_lse

    n, k, v = K4_WIDE
    x, w, b, gr = k4_inputs(torch.Generator().manual_seed(0), dev, n, k, v)
    args = [(x, w, b, vocab_lse.lse_plain(x, w, b), gr, vocab_lse._rows8(w))]
    src, build = cuda_lib.CSRC, cuda_lib.BUILD_DIR
    try:
        for name, edits in K4_ABLATIONS.items():
            tmp = Path(tempfile.mkdtemp(prefix="agacs_ablate_"))
            for f in [*src.glob("*.cu"), *src.glob("*.cuh")]:
                shutil.copy(f, tmp / f.name)
            text = (tmp / "vocab_lse.cu").read_text()
            for old, new in edits:
                check(old in text, f"ablation {name!r}: {old!r} is in vocab_lse.cu")
                text = text.replace(old, new, 1)
            (tmp / "vocab_lse.cu").write_text(text)
            cuda_lib.CSRC, cuda_lib.BUILD_DIR = tmp, tmp / "build"
            cuda_lib._LIBS.clear()
            cuda_lib._FNS.clear()
            dx = cuda_ms(lambda *a: vocab_lse._launch_dx(*a[:5], wp=a[5]), args, 10)
            dw = cuda_ms(lambda *a: vocab_lse._launch_dw(*a[:5], wp=a[5]), args, 10)
            print(f"k4-ablate {K4_WIDE} {name}: dx {dx:.4f} ms, dw {dw:.4f} ms a call", flush=True)
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        cuda_lib.CSRC, cuda_lib.BUILD_DIR = src, build
        cuda_lib._LIBS.clear()
        cuda_lib._FNS.clear()


# `--k4-turns DIR`: one process per turn, in the tree at `root`: K4's three
# passes at the conformer's training shape (K4_SHAPES[0]) and at K4_WIDE,
# timed by that tree's `k4_times` (its forward, dx and dw with the padded W
# handed in, beside their plain versions and cuBLAS).
K4_TURN = ("import sys, json, torch; sys.path.insert(0, {root!r}); import chip_smoke as c; "
           "dev = torch.device('cuda'); g = torch.Generator().manual_seed(0); "
           "out = {{}}\n"
           "for shape in (c.K4_SHAPES[0], c.K4_WIDE):\n"
           "    gr = torch.randn(shape[0], generator=g).to(dev)\n"
           "    res, _ = c.k4_times(g, dev, shape, gr, 1, {iters!r}, '')\n"
           "    out[str(shape)] = {{p: r['ms'] for p, r in res.items()}}\n"
           "    torch.cuda.empty_cache()\n"
           "print('K4_TURN', json.dumps(out))")


def k4_turns(other: str) -> None:
    """K4 at the training shape and K4_WIDE in the tree at `other` and in
    this one, in turns (other, this, this, other), one process each; each
    tree builds its own kernels."""
    other = os.path.abspath(other)
    check(os.path.isfile(os.path.join(other, "chip_smoke.py")), f"{other} holds chip_smoke.py")
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, "-c", K4_TURN.format(root=tree,
                                                  iters={"fwd": 10, "dx": 20, "dw": 20})],
            cwd=tree, capture_output=True, text=True, timeout=1200)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("K4_TURN ")]
        check(proc.returncode == 0 and len(found) == 1,
              f"K4 turn in {tree}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        print(f"k4-turns {'this tree' if tree == ROOT else tree}: ms a call "
              + found[0].split(" ", 1)[1], flush=True)


# K3's and K3-f32's plain rows at other head widths (rows, Tp, d, heads,
# pos): d_head 32 (256 / 8), 36 (144 / 4, Conformer(S)), 44 (176 / 4, NeMo
# Small), 128 (1024 / 8, the XLarge decoder's beam-10 self-attention: timed)
# and 256 (1024 / 4); each at the beam shape (80, 112) and at 2 rows of a
# 752-key cache (S 8, the split's cluster exchanges).
K3W_CASES = ((80, 112, 256, 8, 99), (2, 752, 256, 8, 749), (80, 112, 144, 4, 99),
             (2, 752, 144, 4, 94), (80, 112, 176, 4, 103), (80, 112, 1024, 8, 99),
             (80, 112, 1024, 8, 103), (2, 752, 1024, 8, 749), (80, 112, 1024, 4, 103),
             (2, 752, 1024, 4, 0), (2, 752, 1024, 4, 749))
K3W_TIMED = (80, 112, 1024, 8, 99)
# timed beside it in bf16: d_head 32, 36 and 44 at the beam shape
K3W_TIMED_NARROW = ((80, 112, 256, 8, 99), (80, 112, 144, 4, 99), (80, 112, 176, 4, 103))


def check_k3_widths(dev, g, timed=True) -> dict:
    """Phases 3 and 3f at other head widths: the plain rows of K3 (bf16)
    and K3-f32 (float32; the C entry decode_attn_rows_fwd) against their
    plain versions at K3W_CASES, keys past pos poisoned, each call made
    twice and bit-identical, one launch a call; bounds KERNEL_RTOL (bf16)
    and K3F32_RTOL (float32) x max |plain f32|. Timed at K3W_TIMED beside
    SDPA and the bound, and in bf16 at K3W_TIMED_NARROW. Returns {"bf16":
    ..., "f32": ...} at d_head 128 and {32 / 36 / 44: ...} in bf16."""
    from agacs_tpu_torch.ops import decode_attn

    out = {"bf16": {"err": 0.0}, "f32": {"err": 0.0}}
    for kind, dtype, rtol, counter in (("bf16", torch.bfloat16, KERNEL_RTOL, "LAUNCHES"),
                                        ("f32", torch.float32, K3F32_RTOL, "F32_LAUNCHES")):
        for case in K3W_CASES:
            n, tp, d, h, pos = case
            dh = d // h
            narrow = kind == "bf16" and case in K3W_TIMED_NARROW
            sets = [tuple(x.to(dtype) for x in sharp_qkv(g, dev, (n, d), (n, tp, d),
                                                         q_scale=dh ** -0.5)) + (pos, h)
                    for _ in range(8 if timed and (case == K3W_TIMED or narrow) else 1)]
            q, k, v, _, _ = sets[0]
            before = getattr(decode_attn, counter)
            got = twice(f"K3 {kind} d_head {dh}", decode_attn.decode_cache_attention, q,
                        *poison_past(k, v, pos), pos, h)
            check(getattr(decode_attn, counter) == before + 2 and got.dtype == dtype,
                  f"K3 {kind} ({n}, {tp}, {d}) H={h}: one {counter} launch a call")
            plain = decode_attn.decode_cache_attention_ref(q.float(), k.float(), v.float(),
                                                           pos, h)
            torch.cuda.synchronize()
            err = (got.float() - plain).abs().max().item()
            bound = rtol * plain.abs().max().item()
            check(got.shape == plain.shape and err <= bound,
                  f"K3 {kind} ({n}, {tp}, {d}) H={h} d_head {dh} pos={pos}: max_abs_err "
                  f"{err} <= {bound}")
            if dh == 128:
                out[kind]["err"] = max(out[kind]["err"], err)
            s = decode_attn.time_splits(n, h, tp)
            line = (f"phase {'3' if kind == 'bf16' else '3f'} K3 rows {kind} ({n}, {tp}, {d}) "
                    f"H={h} d_head {dh} pos={pos} S={s}: max_abs_err {err:.3e} (bound {rtol} x "
                    "max|plain f32|), bit-identical twice")
            if timed and (case == K3W_TIMED or narrow):
                res = out[kind] if case == K3W_TIMED else out.setdefault(dh, {"err": err})
                res["ms"] = cuda_ms(decode_attn.decode_cache_attention, sets, 50)
                res["plain_ms"] = cuda_ms(decode_attn.decode_cache_attention_ref, sets, 50)
                lib = sdpa_yardsticks(sets)
                res["library_ms"] = lib["library_ms"]
                esz = 2 if kind == "bf16" else 4
                res.update(roofline(2 * n * (pos + 1) * d * esz + 2 * n * d * esz,
                                    4 * n * (pos + 1) * d, kind))
                line += (f" kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms "
                         f"{lib['text']} bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
            print(line, flush=True)
    return out


def check_k3f32(dev, g, timed=True) -> dict:
    """Phase 3f: K3-f32 (decode_attn.cu, float32 query and caches) against
    its plain version at the LM's beam shape (80 rows = 8 x beam 10, 112,
    512), 8 heads, pos 103, keys past pos poisoned; bound K3F32_RTOL x max
    |plain|; SDPA over the same keys timed beside it."""
    from agacs_tpu_torch.ops import decode_attn

    n, tp, d, h, pos = 80, 112, 512, 8, 103
    sets = [tuple(x.float() for x in sharp_qkv(g, dev, (n, d), (n, tp, d), q_scale=0.125))
            + (pos, h) for _ in range(8)]
    q, k, v, _, _ = sets[0]
    k_bad, v_bad = k.clone(), v.clone()
    k_bad[:, pos + 1:] = 0.0
    v_bad[:, pos + 1:] = 1e4
    out = twice("K3-f32", decode_attn.decode_cache_attention, q, k_bad, v_bad, pos, h)
    plain = decode_attn.decode_cache_attention_ref(q, k, v, pos, h)
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    bound = K3F32_RTOL * plain.abs().max().item()
    check(out.dtype == torch.float32 and out.shape == plain.shape and err <= bound,
          f"K3-f32: max_abs_err {err} <= {bound}")
    res = {"err": err}
    line = (f"phase 3f K3-f32 decode_attn_f32 ({n}, {tp}, {d}) H={h} pos={pos} S="
            f"{decode_attn.time_splits(n, h, tp)}: max_abs_err {err:.3e} (bound {K3F32_RTOL} "
            f"x max|plain|), bit-identical twice")
    if timed:
        res["ms"] = cuda_ms(decode_attn.decode_cache_attention, sets, 50)
        res["plain_ms"] = cuda_ms(decode_attn.decode_cache_attention_ref, sets, 50)
        res["library_ms"] = cuda_ms(lambda q, k, v, p, hh: sdpa_one_query(q, k, v, p, hh),
                                    sets, 50)
        res.update(roofline(2 * n * (pos + 1) * d * 4 + 2 * n * d * 4,
                            4 * n * h * (pos + 1) * 64, "f32"))
        line += (f" kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms sdpa "
                 f"{res['library_ms']:.4f} ms bound {res['bound_ms']:.4f} ms")
    print(line, flush=True)
    return res


def check_k6(dev, g, timed=True) -> dict:
    """Phase 2w: K6 against its plain version (the same bf16-rounded
    weight, float32 sums) at the decode step's products and the padded
    logits head, rows 1, 5, 8 and 32 (a ragged count is padded on chip;
    the head also at beam 5's 40):
    1e-2 x max |plain| and element by element K6_ELEM, each called twice
    and bit-identical (the split's partials are added in rank order), one
    launch a call. Timed beside it: cuBLAS (`torch.matmul`) on the
    pre-dequantised bf16 weight and K8's one-launch `thin_matmul` on the
    int8 one. Distinct
    weights per call fill more than the 50 MB L2, as a decode step's 99 MB
    of weights do. Returns the error and the times at 8 rows of the logits
    head."""
    from agacs_tpu_torch.ops import int8_linear as i8
    from agacs_tpu_torch.ops import int8_serve

    res = {"err": 0.0}
    for k, n in K6_SHAPES:
        n_sets = max(2, -(-(64 << 20) // (k * n))) if timed else 1
        weights = [int8_weight(g, dev, k, n)[:2] for _ in range(n_sets)]
        bf = [int8_serve.dequant_bf(w_q, w_s, torch.bfloat16) for w_q, w_s in weights]
        line = []
        all_rows = K6_ROWS + ((K6_HEAD_BEAM,) if n == 52224 else ())
        for rows in all_rows:
            xs = [torch.randn(rows, k, generator=g).to(dev, torch.bfloat16) for _ in weights]
            w_q, w_s = weights[0]
            before = int8_serve.LAUNCHES
            cold_l2(dev)
            y = twice(f"K6 ({rows}, {k}) -> {n}", int8_serve.w8a16_matmul, xs[0], w_q, w_s)
            check(int8_serve.LAUNCHES == before + 2, "K6 launched once a call")
            plain = xs[0].float() @ bf[0].float()
            err = hold(f"K6 ({rows}, {k}) -> {n}", y, plain, (rows, k, n))
            over = ((y.float() - plain).abs()
                    > K6_ELEM[0] * plain.abs() + K6_ELEM[1] * plain.abs().max()).sum().item()
            check(over == 0, f"K6 ({rows}, {k}) -> {n}: {over} elements past "
                             f"{K6_ELEM[0]} |plain| + {K6_ELEM[1]} max |plain|")
            res["err"] = max(res["err"], err)
            bn, splits = int8_serve.thin_tiling(rows, n, k, int8_serve.K6_KR)
            item = f"rows {rows} (BN {bn}, S {splits}): err {err:.2e}"
            if timed:
                sets = [(x, wq, ws) for x, (wq, ws) in zip(xs, weights)]
                iters = 20 if n > 10000 else 100
                t = {"k6": cuda_ms(int8_serve.w8a16_matmul, sets, iters),
                     "cublas": cuda_ms(torch.matmul, list(zip(xs, bf)), iters),
                     "k8": cuda_ms(i8.thin_matmul, sets, iters)}
                bound = roofline(k * n + n * 4 + rows * k * 2 + rows * n * 2,
                                 2 * rows * k * n, "bf16")
                item += (f" K6 {t['k6']:.4f} cuBLAS {t['cublas']:.4f} K8 thin_matmul {t['k8']:.4f} "
                         f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
                if rows == 8:
                    t["plain"] = cuda_ms(int8_serve.w8a16_matmul_ref, sets, 10)
                    item += f" plain {t['plain']:.4f}"
                    if n == 52224:
                        res.update(ms=t["k6"], plain_ms=t["plain"], library_ms=t["cublas"],
                                   **bound)
            line.append(item)
        # one profile a call: with the calls back to back in one profile the
        # profiler lost one or two of their four device records in every try
        # on some hosts (H100, 2 of 4 whole-script runs), as phase 2i's
        # one-call profiles never did
        for rows in all_rows:
            x = torch.randn(rows, k, generator=g).to(dev, torch.bfloat16)
            one_launch(f"K6 ({k} -> {n}) at {rows} rows",
                       functools.partial(int8_serve.w8a16_matmul, x, *weights[0]),
                       "w8a16_kernel", 1)
        print(f"phase 2w K6 w8a16 ({k} -> {n}), {n_sets} weight sets, one launch a call, "
              "bit-identical twice: " + "; ".join(line)
              + f" (bounds {KERNEL_RTOL} x max|plain f32|, elementwise {K6_ELEM})",
              flush=True)
        del weights, bf
    return res


def check_k3_d48(dev, g, timed=True) -> dict:
    """Phase 3d: K3 at d_head 48 against its plain version at the side
    ladder's greedy self-attention (8, 112, 192), 4 heads, pos 0/57/103,
    its beam rows (40, 112, 192) pos 103 and its cross-attention (8, 752,
    192) pos 749 (S 8, the most: chunks of 94 keys), and at the cross
    shape's split edges, pos 0 (seven empty blocks), 93 and 94; keys past
    pos poisoned as in phase 3, every call twice, bit for bit. Returns the
    error and the times at the cross shape."""
    from agacs_tpu_torch.ops import decode_attn

    h, d = 4, 192
    res = {"err": 0.0}
    for n, tp, pos in ((8, 112, 0), (8, 112, 57), (8, 112, 103), (40, 112, 103),
                       (8, 752, 749), (8, 752, 0), (8, 752, 93), (8, 752, 94)):
        timed_case = (tp, pos) not in ((752, 0), (752, 93), (752, 94))
        sets = [(*sharp_qkv(g, dev, (n, d), (n, tp, d), q_scale=48 ** -0.5), pos, h)
                for _ in range(8 if timed and timed_case else 1)]
        q, k, v, _, _ = sets[0]
        before = decode_attn.D48_LAUNCHES
        out = twice("K3@48", decode_attn.decode_cache_attention, q, *poison_past(k, v, pos),
                    pos, h)
        check(decode_attn.D48_LAUNCHES == before + 2, "K3 at d_head 48 launched")
        err = hold(f"K3@48 pos={pos}", out, decode_attn.decode_cache_attention_ref(
            q.float(), k.float(), v.float(), pos, h), (n, tp, d))
        res["err"] = max(res["err"], err)
        line = (f"phase 3d K3@48 decode_attn ({n}, {tp}, {d}) H={h} pos={pos} S="
                f"{decode_attn.time_splits(n, h, tp)}: max_abs_err {err:.3e} (bound "
                f"{KERNEL_RTOL} x max|plain f32|), bit-identical twice")
        if timed and timed_case:
            ms = cuda_ms(decode_attn.decode_cache_attention, sets, 50)
            plain_ms = cuda_ms(decode_attn.decode_cache_attention_ref, sets, 50)
            lib = sdpa_yardsticks(sets)
            bound = roofline(2 * n * (pos + 1) * d * 2 + 2 * n * d * 2,
                             4 * n * h * (pos + 1) * 48, "bf16")
            line += (f" kernel {ms:.4f} ms plain bf16 {plain_ms:.4f} ms {lib['text']} "
                     f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            if tp == 752:
                res.update(ms=ms, plain_ms=plain_ms, library_ms=lib["library_ms"], **bound)
        print(line, flush=True)
    return res


def device_profile(fn, counts: dict | None = None) -> tuple[float, int, dict]:
    """Run fn() once under torch.profiler, device activity only: (device
    busy ms, device events, ms by kernel name); `counts`, when given, gets
    the events by name. Recording the host's operator events as well gave
    the same busy time and tripled the time the profile takes (H100, the
    greedy request of phase 6: 24-31 s against 10-11 s). LEAD_IN_SPINS
    short sleep kernels, each synchronised, and 50 ms on the host lead in,
    outside the tallies, and 50 ms lead out: without them a kernel at an
    end of the trace was missing from it (H100: one of four K6 calls, or a
    lone K8g call, in a profile of those calls alone; with one sleep kernel,
    on some hosts, the lone K6 call's record or the sleep kernel's own). A
    profile that holds no device event at all
    (H100: once, a lone K8g call's after several profiles of other calls)
    is taken again, PROFILE_TRIES times at most, and says so. The device
    records are read as the profiler keeps them (`kineto_results`), under
    the names its events would carry: building its event tree
    (`prof.events()`) for the ~160,000 records of a whisper-large greedy
    request took longer than the request."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN_SPINS):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        per_name: dict[str, float] = collections.defaultdict(float)
        n_events, seen = 0, {}
        for e in prof.profiler.kineto_results.events():
            # record_function ranges (e.g. Optimizer.step) also show on the
            # device timeline; they overlap the kernels, so they are skipped
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            name = _rewrite_name(e.name(), with_wildcard=True)
            if "spin_kernel" not in name:
                per_name[name] += e.duration_ns() / 1e6
                n_events += 1
                seen[name] = seen.get(name, 0) + 1
        if n_events:
            break
        print("device_profile: the profiler recorded no device event; taken again", flush=True)
    check(n_events > 0, "the profiler recorded device events")
    if counts is not None:
        for name, c in seen.items():
            counts[name] = counts.get(name, 0) + c
    return sum(per_name.values()), n_events, per_name


def events_of(counts: dict, word: str) -> int:
    """Device events whose kernel name contains `word`."""
    return sum(c for name, c in counts.items() if word in name)


def exact_profile(what: str, fn, want, reset=None) -> tuple[float, int, dict]:
    """device_profile(fn) in which each kernel's device events match the
    launches its wrapper counted: `want()`, read after the run, maps a word
    of kernel names to their launches (the word "" to every device event);
    `reset()`, when given, zeroes the wrappers' counts before the run. The
    profiler now and then loses device records (H100: one request's
    profile of ~62,000 events missed 1-3% of each kernel's, in one run of
    this script of several), and a lost record only lowers a tally: a
    profile whose tallies all lie at or below the launches, one at least
    below, is taken again, PROFILE_TRIES times at most, and says so. A
    tally above its launches (a second pass) fails at once; a kernel that
    is counted but not launched falls short in every try."""
    seen = []
    for i in range(PROFILE_TRIES):
        if reset is not None:
            reset()
        counts: dict = {}
        busy, n_events, per_name = device_profile(fn, counts)
        expect = want()
        got = {word: events_of(counts, word) for word in expect}
        if got == expect:
            return busy, n_events, per_name
        seen.append(got)
        if i + 1 == PROFILE_TRIES or any(got[word] > n for word, n in expect.items()):
            break
        print(f"{what}: the profile lost device records ({got} of {expect}); taken again",
              flush=True)
    check(False, f"{what}: device events by kernel {seen} against launches {expect}: "
          f"{counts}")


def one_launch(what: str, fn, word: str, calls: int) -> None:
    """fn(), which makes `calls` calls of a kernel wrapper, under the
    profiler: exactly `calls` device events, every one a kernel whose name
    holds `word` (one launch a call, nothing else on the device)."""
    exact_profile(f"{what}: {calls} calls made one {word} launch each", fn,
                  lambda: {"": calls, word: calls})


def top_kernels(per_name: dict, n: int = 8) -> str:
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{name[:48]} {t:.2f} ms" for name, t in top)


def profile_request(s2t, audio, ms_batch: float, n_steps: int) -> None:
    """Phase 6: one warm request under torch.profiler."""
    busy, n_events, per_name = device_profile(lambda: s2t(audio))
    k3 = sum(t for name, t in per_name.items() if "decode_attn_kernel" in name)
    print(f"phase 6 profile: device busy {busy:.1f} ms in {n_events} device "
          f"events ({n_events / n_steps:.0f} per decode step); idle "
          f"{1 - busy / ms_batch:.1%} of phase 4's {ms_batch:.1f} ms/batch; K3 {k3:.2f} ms "
          f"({k3 / busy:.1%}); top: " + top_kernels(per_name), flush=True)


def beam_phase(model, asr_cfg, audio) -> dict:
    """Phases 10 and 11: the beam5 8 x 15 s request (bench.py's
    beam5_8x15s row) with exact launch counts, then one more under the
    profiler. Returns its results, launches, time and kernel errors."""
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.ops import decode_attn, flash_train

    cfg = model.cfg
    s2t = Speech2Text(model, asr_cfg, beam_size=BEAM, max_steps=100, loop="scan")
    warm_up(Speech2Text(model, asr_cfg, beam_size=BEAM, max_steps=WARM_STEPS, loop="scan"),
            audio)
    flash_train.LAUNCHES = decode_attn.LAUNCHES = 0
    decode_attn.ANC_LAUNCHES = decode_attn.SHARED_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = s2t(audio)
    times = [time.perf_counter() - t0]
    launches = {"K1f": flash_train.LAUNCHES, "K3": decode_attn.LAUNCHES,
                "K3a": decode_attn.ANC_LAUNCHES, "K3s": decode_attn.SHARED_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        s2t(audio)
        times.append(time.perf_counter() - t0)
    n_steps = min(len(PRIMER) + 100, cfg.n_text_ctx) - 1  # prefill + search steps
    per_step = cfg.n_text_layer * n_steps
    check(len(results) == 8, "8 beam hypotheses")
    for r in results:
        check(r.tokens[:5] == PRIMER and 5 < len(r.tokens) <= 106 and np.isfinite(r.score),
              f"beam hypothesis {r.tokens[:8]}... score {r.score}")
    check(launches == {"K1f": cfg.n_audio_layer, "K3": 0, "K3a": per_step,
                       "K3s": per_step},
          f"beam launches {launches} == K1f 12, K3 0, K3a and K3s 12 x {n_steps}")
    ms_batch = statistics.median(times) * 1e3
    print(f"phase 10 beam slice: whisper-small+adapters bf16, 8 x 15 s, beam {BEAM}, "
          f"{n_steps} decode steps, loop scan: {ms_batch:.1f} ms/batch (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {120.0 / (ms_batch / 1e3):.1f} x "
          f"realtime, {ms_batch / n_steps:.2f} ms/step incl. encode; peak {peak_gb:.2f} GB; "
          f"launches {launches}; lengths {[len(r.tokens) for r in results]}", flush=True)

    busy, n_events, per_name = device_profile(lambda: s2t(audio))
    k3a = sum(t for name, t in per_name.items() if "decode_attn_kernel<true," in name)
    k3s = sum(t for name, t in per_name.items() if "decode_attn_shared_kernel" in name)
    print(f"phase 11 beam profile: device busy {busy:.1f} ms in {n_events} device events "
          f"({n_events / n_steps:.0f} per decode step); idle {1 - busy / ms_batch:.1%} of "
          f"phase 10's {ms_batch:.1f} ms/batch; K3a {k3a:.2f} ms ({k3a / busy:.1%}), K3s "
          f"{k3s:.2f} ms ({k3s / busy:.1%}); top: " + top_kernels(per_name), flush=True)
    return {"results": results, "launches": launches, "ms": ms_batch, "s2t": s2t}


def rescore(model, enc, hyps, limit: int) -> np.ndarray:
    """Teacher-forced scores of beam hypotheses (token lists): the sum of
    each searched token's log-softmax value (plus the length bonus per
    searched token, 0 here). An eot the search selected counts; the eot
    appended at the cap (length limit + 2) joins at an unchanged score and
    counts nothing (composed_beam.py:326-345)."""
    from agacs_tpu_torch.models import whisper as tw

    n_p = len(PRIMER)
    width = max(len(h) for h in hyps)
    ids = torch.full((len(hyps), width), 50257, dtype=torch.long)
    for i, h in enumerate(hyps):
        ids[i, : len(h)] = torch.tensor(h)
    ids = ids.to(enc.device)
    with torch.inference_mode():
        logits, _ = tw.whisper_decode(model, ids[:, :-1], enc)
        logp = torch.log_softmax(logits.float(), -1).double().cpu()
    out = []
    for i, h in enumerate(hyps):
        end = len(h) - 1 if len(h) == limit + 2 else len(h)
        t = torch.arange(n_p, end)
        out.append(float(logp[i, t - 1, ids[i, t].cpu()].sum()))
    return np.array(out)


@contextlib.contextmanager
def plain_decode_attention():
    """Every decode-step attention (self and cross) through its plain
    PyTorch version instead of K3 and its variants: the beam phases'
    control."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.ops import decode_attn

    kernels = tw.decode_cache_attention, tw.decode_shared_cache_attention
    tw.decode_cache_attention = decode_attn.decode_cache_attention_plain
    tw.decode_shared_cache_attention = decode_attn.decode_shared_cache_attention_plain
    try:
        yield
    finally:
        tw.decode_cache_attention, tw.decode_shared_cache_attention = kernels


def beam_e2e(model, asr_cfg, audio, beam, cpu_model, enc_cpu, phase: int = 12,
             rows: str = "K3", anc: str = "K3a") -> dict:
    """Phase 12 (and 20, on the PE decoder): the beam request's reported
    scores against teacher-forced rescoring, on the card (bf16, plain
    attention) and on the CPU (float32, utterance 0); a control search with
    plain decode attention read the same way; and the search with the
    caches gathered physically (the `rows` kernel) against the ancestry
    map (the `anc` kernel)."""
    from agacs_tpu_torch.decode.beam import beam_decode
    from agacs_tpu_torch.models.asr_model import encode

    dev = next(model.parameters()).device
    limit = len(PRIMER) + 100 - 1
    with torch.inference_mode():
        enc, _ = encode(model, asr_cfg, torch.from_numpy(audio).to(dev),
                        torch.full((audio.shape[0],), audio.shape[1], device=dev))
    hyps = [r.tokens for r in beam["results"]]
    scores = np.array([r.score for r in beam["results"]])
    card = np.abs(rescore(model, enc, hyps, limit) / scores - 1)
    cpu = abs(rescore(cpu_model, enc_cpu, hyps[:1], limit)[0] / scores[0] - 1)

    def search(**kw):
        with torch.inference_mode():
            t, l, sc = beam_decode(model, enc, beam_size=BEAM, max_steps=100, loop="scan",
                                   **kw)
        return [t[i, : l[i]].tolist() for i in range(len(l))], sc.double().cpu().numpy()

    k3 = decode_counts()[rows]
    gathered, g_scores = search(ancestry=False)
    check(decode_counts()[rows] - k3 == beam["launches"][anc],
          f"the physical-gather search ran {rows} plain rows")
    with plain_decode_attention():
        c_hyps, c_scores = search()
    control = np.abs(rescore(model, enc, c_hyps, limit) / c_scores - 1)
    same = gathered == hyps and np.array_equal(g_scores, scores)
    print(f"phase {phase} beam e2e: reported score vs teacher-forced rescore (rel, max over "
          f"8): card bf16 {card.max():.2e}, cpu f32 (utt 0) {cpu:.2e}; control search "
          f"with plain decode attention: card bf16 {control.max():.2e}; bounds "
          f"{RESCORE_REL}; scores {np.round(scores, 2).tolist()}; physical-gather "
          f"search ({rows} rows) identical to the ancestry map ({anc}): {same}", flush=True)
    check(card.max() <= RESCORE_REL["card"] and cpu <= RESCORE_REL["cpu"],
          f"beam rescore rel card {card.max()} cpu {cpu} within {RESCORE_REL}")
    check(same, "the physical-gather search returns the same hypotheses and scores")
    return {"card": card.max(), "cpu": cpu, "control": control.max()}


def make_train_batch(b: int, seconds: int, dev) -> dict:
    """bench.py's `_make_batch` (:155-184): seeded noise at 0.05, 32-id
    texts (primer, random ids, eot; rows 1-3 ids shorter), language labels
    (prompt pattern, then ZH)."""
    from agacs_tpu_torch.adapt.cs_loss import LANG_EN, LANG_PAD, LANG_ZH

    rng = np.random.RandomState(0)
    n_text = 32
    text = np.full((b, n_text), -1, np.int64)
    labels = np.full((b, n_text + 1), LANG_PAD, np.int8)
    for i in range(b):
        n = n_text - (i % 4)
        text[i, :4] = [50260, 50259, 50359, 50363]
        text[i, 4:n] = rng.randint(100, 50000, n - 4)
        text[i, n - 1] = 50257
        labels[i, :5] = [0, LANG_ZH, LANG_EN, 0, 0]
        labels[i, 5: n + 1] = LANG_ZH
    s = seconds * 16000
    return {
        "speech": torch.from_numpy((rng.randn(b, s) * 0.05).astype(np.float32)).to(dev),
        "speech_lengths": torch.full((b,), s, device=dev),
        "text": torch.from_numpy(text).to(dev),
        "cs_labels": torch.from_numpy(labels).to(dev),
    }


def train_model(sd, dev, dtype, specaug: bool, int8: bool = False, pe: bool = False,
                side: bool = False, size: str = "small"):
    """The stage-2 recipe's trainable model (whisper `size`): built in float32 from `sd`,
    preset `adapter`, frozen parameters stored in `dtype` (then, with
    `int8`, quantised: `freeze_quant: int8`); with its config. A state dict
    that already holds int8 buffers builds the int8 trunk from them. With
    `pe`, the TMECS cs_loss_pe recipe's instead: PE attention in both
    stacks, preset `whisper_pe` (only query_cs / key_cs train), cs_weight 1.
    With `side`, the side-network recipe's: the default ladder, no adapters,
    preset `sidenetwork` (both ladders train, the trunk is frozen)."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig
    from agacs_tpu_torch.train.freeze import apply_freeze

    if pe:
        cfg = tw.make_config("small", pe_attention=True, compute_dtype=dtype)
    elif side:
        cfg = tw.make_config("small", side_network=tw.SideNetworkConfig(),
                             compute_dtype=dtype)
    else:
        cfg = tw.make_config(size, adapter=True, adapter_encoder=True,
                             adapter_decoder=True, compute_dtype=dtype)
    model = tw.Whisper.from_state_dict(cfg, sd, device=dev, param_dtype=torch.float32)
    params = apply_freeze(model, "whisper_pe" if pe else "sidenetwork" if side else "adapter")
    model.cast_frozen_(dtype)
    if int8:
        model.quantize_frozen_()
    return model, params, ASRModelConfig(whisper=cfg, cs_weight=1.0 if pe else 0.01,
                                         use_specaug=specaug)


def int8_counts() -> dict:
    from agacs_tpu_torch.ops import int8_linear, int8_mlp

    return {"K2f": int8_mlp.FWD_LAUNCHES, "K2b": int8_mlp.BWD_LAUNCHES,
            "K8g": int8_linear.LAUNCHES, "K8g dgrad": int8_linear.DGRAD_LAUNCHES,
            "K8q": int8_linear.QUANT_LAUNCHES}


def kept_transposes(model) -> dict:
    """Bytes of the int8 weights a model keeps transposed for the kernels
    (not state): the wide K8g forward's (`Int8Linear.weight_t` and the
    fused projections' cache) and K2's (`MLP.k2_weights`)."""
    from agacs_tpu_torch.models import whisper as tw

    k8 = k2 = 0
    for m in model.modules():
        if isinstance(m, tw.Int8Linear):
            k8 += sum(t.numel() for wt, _ in m._t_cache.values() for t in wt)
        elif isinstance(m, tw.MultiHeadAttention):
            k8 += sum(t.numel() for c, _ in m._fused.values()
                      for wt, _ in c[2].values() for t in [wt])
        elif isinstance(m, tw.MLP):
            k2 += sum(t.numel() for wt, _ in m._k2_cache.values() for t in wt)
    return {"K8g": k8, "K2": k2}


def reset_int8_counts() -> None:
    from agacs_tpu_torch.ops import int8_linear, int8_mlp

    int8_mlp.FWD_LAUNCHES = int8_mlp.BWD_LAUNCHES = 0
    int8_linear.LAUNCHES = int8_linear.DGRAD_LAUNCHES = int8_linear.QUANT_LAUNCHES = 0
    int8_linear.THIN_LAUNCHES = 0


def train_phase(sd, dev, int8: bool = False, bf16: dict | None = None, size: str = "small",
                steps: int = TRAIN_STEPS, phase: tuple | None = None,
                keep_state: bool = False) -> dict:
    """Phases 7 and 8 (bf16 trunk), or 13 and 14 (`int8`: the trunk
    quantised; `bf16` is phase 7's result, printed beside it): timed
    adapter + CS-loss optimizer steps, then one more under the profiler;
    `size`, `steps` and `phase` (the two lines' labels) for phase 49's
    whisper-large, whose int8 serving loads the trained model's state
    (`keep_state`: returned as "state", on the card)."""
    from agacs_tpu_torch.ops import flash_train
    from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step

    model, params, acfg = train_model(sd, dev, torch.bfloat16, specaug=True, int8=int8,
                                      size=size)
    n_layer = acfg.whisper.n_audio_layer
    opt, sched = build_optimizer(params, OptimConfig(warmup_steps=500))
    step = make_train_step(model, acfg, opt, sched, grad_clip=1.0,
                           generator=torch.Generator().manual_seed(1))
    batch = make_train_batch(TRAIN_B, TRAIN_S, dev)
    trainable = {id(p) for p in params}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if id(p) not in trainable}
    frozen.update((n, b.clone()) for n, b in model.named_buffers() if "weight_" in n)
    before = [p.detach().clone() for p in params]
    step([batch])  # warm-up: cuBLAS handles, the kernels' first launches
    torch.cuda.synchronize()
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    reset_int8_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        stats = step([batch])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(stats["loss"]), float(stats["loss_cs"])))
    launches = {"K1f": flash_train.LAUNCHES, "K1b": flash_train.BWD_LAUNCHES}
    if int8:
        launches.update(int8_counts())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kept = kept_transposes(model) if int8 else {}
    check(all(np.isfinite(v) for pair in losses for v in pair)
          and int(stats["grad_nonfinite_total"]) == 0, f"finite losses {losses}")
    # layer 0's q/k/v need no gradient (nothing upstream of it trains), so
    # its attention takes no backward: 12 K1f and 11 K1b per micro-step
    check(launches["K1f"] == n_layer * steps,
          f"K1f launches {launches['K1f']} == {n_layer} x {steps}")
    check(launches["K1b"] == (n_layer - 1) * steps,
          f"K1b launches {launches['K1b']} == {n_layer - 1} x {steps}")
    per_step = int8_train_launches(acfg.whisper)
    if int8:
        want = {k: v * steps for k, v in per_step.items()}
        check({k: launches[k] for k in want} == want,
              f"int8 launches {launches} == {per_step} x {steps}")
    state = dict(model.named_parameters(), **dict(model.named_buffers()))
    check(len(frozen) > 0 and all(torch.equal(state[n], t) for n, t in frozen.items()),
          "every frozen parameter and int8 buffer bit-identical after the steps")
    check(all(not torch.equal(a, p) for a, p in zip(before, params)),
          "every adapter parameter changed")
    ms = statistics.median(times) * 1e3
    audio_s = TRAIN_B * TRAIN_S
    phase = phase or ((13, 14) if int8 else (7, 8))
    vs = (f" [the bf16 trunk's: {bf16['ms']:.1f} ms/step, {audio_s / (bf16['ms'] / 1e3):.1f} "
          f"audio-s/s, peak {bf16['peak_gb']:.2f} GB, loss {bf16['loss']:.3f}]") if bf16 else ""
    print(f"phase {phase[0]} train: whisper-{size}+adapters, "
          f"{'int8' if int8 else 'bf16'} trunk / f32 adapters, "
          f"{TRAIN_B} x {TRAIN_S} s, cs_weight 0.01, SpecAug on: {ms:.1f} ms/step "
          f"(median of {[round(t * 1e3, 1) for t in times]}), "
          f"{audio_s / (ms / 1e3):.1f} audio-s/s; peak {peak_gb:.2f} GB"
          + (f" (of it the int8 weights kept transposed: K8g {kept['K8g'] / 1e6:.1f} MB, "
             f"K2 {kept['K2'] / 1e6:.1f} MB)" if int8 else "") + "; "
          f"{sum(p.numel() for p in params) / 1e6:.2f}M trainable; losses (loss, "
          f"loss_cs) {[(round(a, 3), round(c, 3)) for a, c in losses]}; "
          f"launches {launches} (K1f {n_layer} and K1b {n_layer - 1} per step"
          + (f", int8 {per_step} per step" if int8 else "") + ")" + vs,
          flush=True)

    busy, n_events, per_name = device_profile(lambda: step([batch]))

    def share(*keys):
        t = sum(v for name, v in per_name.items() if any(k in name for k in keys))
        return f"{t:.2f} ms ({t / busy:.1%})"

    print(f"phase {phase[1]} train profile: device busy {busy:.1f} ms in {n_events} device "
          f"events; idle {1 - busy / ms:.1%} of phase {phase[0]}'s {ms:.1f} ms/step; K1b "
          f"{share('dkdv_kernel', 'dq_kernel', 'rowdot_kernel')}, K1f "
          f"{share('packed_flash_fwd')}"
          + (f"; K2f {share('mlp_fwd_kernel')}, K2b {share('mlp_bwd_kernel')}, K8g "
             f"{share('gemm_kernel')}, K8q {share('rowquant_kernel')}" if int8 else "")
          + "; top: " + top_kernels(per_name), flush=True)
    state = dict(model.state_dict()) if keep_state else None
    del model, opt, frozen, before
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "peak_gb": peak_gb, "batch": batch,
            "loss": float(np.mean([a for a, _ in losses])), "busy": busy,
            "per_name": per_name, "state": state}


def micro_step(sd, dev, dtype, one, int8: bool = False, pe: bool = False,
               side: bool = False) -> tuple[float, float, dict]:
    """One micro-step of the stage-2 (or, `pe`, the cs_loss_pe; `side`, the
    side-network) model on `dev` (SpecAug off): the loss, loss_cs, and
    every trainable parameter's gradient, float32 on the CPU, by name."""
    from agacs_tpu_torch.models import asr_model

    model, _, acfg = train_model(sd, dev, dtype, specaug=False, int8=int8, pe=pe, side=side)
    loss, stats = asr_model.forward(model, acfg, {k: v.to(dev) for k, v in one.items()})
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
             if p.requires_grad}
    return float(loss.detach()), float(stats["loss_cs"].detach()), grads


def parity(run, ref, groups=("encoder.", "decoder.")) -> dict:
    """`run` against `ref` (micro_step results): relative errors of the
    loss, loss_cs and the global gradient norm; cosines of all, the
    encoder's and the decoder's trainable gradients (`groups`: their
    name prefixes)."""
    (loss, cs, grads), (loss_r, cs_r, grads_r) = run, ref
    check(grads.keys() == grads_r.keys(), "the same trainable parameters")

    def flat(g, prefix=""):
        return torch.cat([x.double().ravel() for n, x in sorted(g.items())
                          if n.startswith(prefix)])

    def cos(prefix):
        return float(torch.nn.functional.cosine_similarity(
            flat(grads, prefix), flat(grads_r, prefix), dim=0))

    return {"loss": abs(loss / loss_r - 1), "loss_cs": abs(cs / cs_r - 1),
            "grad_norm": abs(flat(grads).norm().item() / flat(grads_r).norm().item() - 1),
            "cos": cos(""), "cos_enc": cos(groups[0]), "cos_dec": cos(groups[1])}


@contextlib.contextmanager
def plain_encoder_attention():
    """The encoder's self-attention through its plain PyTorch version under
    torch autograd (bf16 products, f32 softmax) instead of K1f/K1b: the
    bf16 control of phase 9."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.ops import flash_train

    kernel = tw.packed_flash_mha
    tw.packed_flash_mha = flash_train.packed_flash_mha_ref
    try:
        yield
    finally:
        tw.packed_flash_mha = kernel


def fmt_parity(r: dict) -> str:
    return ", ".join(f"{k} {v:.2e}" if k in TRAIN_REL else f"{k} {v:.6f}"
                     for k, v in r.items())


def train_parity(sd, dev, batch) -> float:
    """Phase 9: one micro-step on one utterance, card bf16 (the kernels,
    and the bf16 control without them) vs the port on the CPU in f32."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.ops import flash_train

    one = {k: v[:1] for k, v in batch.items()}
    ref = micro_step(sd, torch.device("cpu"), torch.float32, one)
    n_layer = tw.make_config("small").n_audio_layer
    k1b_before = flash_train.BWD_LAUNCHES
    run = micro_step(sd, dev, torch.bfloat16, one)
    check(flash_train.BWD_LAUNCHES - k1b_before == n_layer - 1,
          "the card micro-step ran K1b in encoder layers 1-11")
    launches = (flash_train.LAUNCHES, flash_train.BWD_LAUNCHES)
    with plain_encoder_attention():
        control = parity(micro_step(sd, dev, torch.bfloat16, one), ref)
    check((flash_train.LAUNCHES, flash_train.BWD_LAUNCHES) == launches,
          "the bf16 control launched no K1 kernel")
    card = parity(run, ref)
    print(f"phase 9 train parity vs cpu f32 (1 x {TRAIN_S} s; rel errors, "
          f"cosines): card bf16 {fmt_parity(card)}; bf16 control (plain encoder "
          f"attention) {fmt_parity(control)}; bounds {TRAIN_REL} {TRAIN_COS}",
          flush=True)
    check(all(np.isfinite(x) for x in (run[0], run[1]))
          and all(bool(torch.isfinite(g).all()) for g in run[2].values()),
          "finite card loss and grads")
    for key, bound in TRAIN_REL.items():
        check(card[key] <= bound, f"train parity {key} rel {card[key]} <= {bound}")
    for key, bound in TRAIN_COS.items():
        check(card[key] >= bound, f"train parity {key} {card[key]} >= {bound}")
    return run[0]


@contextlib.contextmanager
def plain_int8():
    """Every int8 product (K8q/K8g, K2f/K2b) through its plain PyTorch
    version on the card: phase 15's control."""
    from agacs_tpu_torch.ops import int8_linear as i8
    from agacs_tpu_torch.ops import int8_mlp

    saved = i8._matmul, i8._dgrad, int8_mlp.int8_mlp_fwd, int8_mlp.int8_mlp_bwd
    i8._matmul = lambda x2, w_q, w_s, w_t=None: i8.int8_matmul_ref(x2, w_q, w_s)
    i8._dgrad = i8.int8_matmul_dgrad_ref
    # the refs without the transposed weights (the wrappers' last argument)
    int8_mlp.int8_mlp_fwd = lambda *a: int8_mlp.int8_mlp_fwd_ref(*a[:7])
    int8_mlp.int8_mlp_bwd = lambda *a: int8_mlp.int8_mlp_bwd_ref(*a[:7])
    try:
        yield
    finally:
        i8._matmul, i8._dgrad, int8_mlp.int8_mlp_fwd, int8_mlp.int8_mlp_bwd = saved


def int8_state(sd, dev) -> dict:
    """The int8 trunk as the card's trainer builds it (bf16-stored frozen
    linears, then quantised), as a CPU state dict: what both sides of
    phases 15 and 16 load, so they run the same int8 weights."""
    model, _, _ = train_model(sd, dev, torch.bfloat16, specaug=False, int8=True)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def int8_train_parity(sd8, dev, batch, bf16_loss: float) -> dict:
    """Phase 15: one int8 micro-step on one utterance, the card (bf16,
    K2/K8) against the port on the CPU (float32, plain versions) on the
    same int8 weights; beside it the card with the int8 plain versions."""
    one = {k: v[:1] for k, v in batch.items()}
    ref = micro_step(sd8, torch.device("cpu"), torch.float32, one)
    before = int8_counts()
    run = micro_step(sd8, dev, torch.bfloat16, one)
    after = int8_counts()
    check(after["K2b"] - before["K2b"] == 12 and after["K8g dgrad"] > before["K8g dgrad"],
          f"the card micro-step ran K2b in the 12 encoder MLPs and K8g dgrad: {after}")
    with plain_int8():
        control = parity(micro_step(sd8, dev, torch.bfloat16, one), ref)
    check(int8_counts() == after, "the int8 control launched no int8 kernel")
    card = parity(run, ref)
    print(f"phase 15 int8 train parity vs cpu f32 (1 x {TRAIN_S} s, same int8 weights; "
          f"rel errors, cosines): card bf16 {fmt_parity(card)}; control (int8 plain "
          f"versions on the card) {fmt_parity(control)}; bounds {INT8_TRAIN_REL} "
          f"{INT8_TRAIN_COS}; for information: int8 loss {run[0]:.4f} vs the bf16 "
          f"trunk's {bf16_loss:.4f} (phase 9's card micro-step)", flush=True)
    check(all(np.isfinite(x) for x in (run[0], run[1]))
          and all(bool(torch.isfinite(g).all()) for g in run[2].values()),
          "finite int8 card loss and grads")
    for key, bnd in INT8_TRAIN_REL.items():
        check(card[key] <= bnd, f"int8 train parity {key} rel {card[key]} <= {bnd}")
    for key, bnd in INT8_TRAIN_COS.items():
        check(card[key] >= bnd, f"int8 train parity {key} {card[key]} >= {bnd}")
    return {"card": card, "control": control}


def int8_serve_phase(sd8, dev, audio) -> dict:
    """Phase 16: greedy Speech2Text (8 x 15 s, 100 steps) on the int8
    trunk with exact launch counts, and its first-step logits (card bf16)
    against the port on the CPU (float32) on the same int8 weights."""
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import encode
    from agacs_tpu_torch.ops import decode_attn, flash_train, int8_linear

    out = model_pair(sd8, dev)
    model, asr_cfg = out["card"]
    s2t = Speech2Text(model, asr_cfg, max_steps=100)
    warm_up(Speech2Text(model, asr_cfg, max_steps=WARM_STEPS), audio)
    flash_train.LAUNCHES = decode_attn.LAUNCHES = 0
    reset_int8_counts()
    t0 = time.perf_counter()
    results = s2t(audio)
    times = [time.perf_counter() - t0]
    launches = {"K1f": flash_train.LAUNCHES, "K3": decode_attn.LAUNCHES, **int8_counts()}
    thin = int8_linear.THIN_LAUNCHES
    for _ in range(2):
        t0 = time.perf_counter()
        s2t(audio)
        times.append(time.perf_counter() - t0)
    cfg = model.cfg
    n_steps = min(len(PRIMER) + 100, cfg.n_text_ctx) - 1
    L = cfg.n_text_layer
    # encoder: fused q/k/v + out per layer (JAX's `mha`), K2f per layer;
    # cross-KV: key and value per layer (JAX's precompute_cross_kv, unfused);
    # a step: self q, k, v, out, cross q, out, and the 8-row MLP's fc1, fc2,
    # each one `thin_matmul` launch (no K8q)
    want = {"K1f": cfg.n_audio_layer, "K3": 2 * L * n_steps, "K2f": cfg.n_audio_layer,
            "K2b": 0, "K8g": 2 * cfg.n_audio_layer + 2 * L + 8 * L * n_steps,
            "K8g dgrad": 0, "K8q": 2 * cfg.n_audio_layer + 2 * L}
    check(len(results) == 8 and all(r.tokens[:5] == PRIMER and 5 < len(r.tokens) <= 105
                                    for r in results), "8 int8 hypotheses")
    check(launches == want, f"int8 serving launches {launches} == {want}")
    # the decode steps' products (8 rows) take `thin_matmul`, the
    # encoder's and the cross-KV projections' (6000 rows) the wide kernel
    check(thin == 8 * L * n_steps, f"int8 serving: {thin} thin K8g launches == "
                                   f"{8 * L * n_steps}")
    ms_batch = statistics.median(times) * 1e3
    first = torch.tensor([PRIMER[0]])
    logits = []
    with torch.inference_mode():
        for m, c in out.values():
            d = next(m.parameters()).device
            enc, _ = encode(m, c, torch.from_numpy(audio[:1]).to(d),
                            torch.tensor([audio.shape[1]], device=d))
            kv = tw.init_self_kv_cache(m.cfg, 1, 16, device=d)
            lg, _ = tw.whisper_decode_step(m, first.to(d), 0, kv, tw.precompute_cross_kv(m, enc))
            logits.append(lg.float().cpu())
    e_log = rel_l2(*logits)
    print(f"phase 16 int8 serving: whisper-small+adapters, int8 trunk, bf16, 8 x 15 s, "
          f"{n_steps} greedy steps: {ms_batch:.1f} ms/batch (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {120.0 / (ms_batch / 1e3):.1f} x realtime; "
          f"launches {launches}; first-step logits card bf16 vs cpu f32 rel L2 {e_log:.3e} "
          f"(bound {INT8_LOGITS_REL_L2}), argmax card {int(logits[0].argmax())} cpu "
          f"{int(logits[1].argmax())}", flush=True)
    check(bool(torch.isfinite(logits[0]).all()) and e_log < INT8_LOGITS_REL_L2,
          f"int8 first-step logits rel L2 {e_log} < {INT8_LOGITS_REL_L2}")
    # one device kernel a K8g call (the thin one with its K8q folded in), one
    # K8q kernel a wide call
    busy, n_events, per_name = exact_profile(
        "int8 serving profile: one launch a K8g and a K8q call", lambda: s2t(audio),
        lambda: {"thin_gemm_kernel": int8_linear.THIN_LAUNCHES,
                 "gemm_kernel": int8_linear.LAUNCHES,
                 "rowquant_kernel": int8_linear.QUANT_LAUNCHES}, reset_int8_counts)
    check(int8_linear.THIN_LAUNCHES == thin and int8_linear.LAUNCHES == want["K8g"]
          and int8_linear.QUANT_LAUNCHES == want["K8q"],
          f"int8 serving profile: {int8_linear.THIN_LAUNCHES} thin K8g launches of "
          f"{int8_linear.LAUNCHES} (want {thin} of {want['K8g']}), K8q "
          f"{int8_linear.QUANT_LAUNCHES} (want {want['K8q']})")

    def share(*keys):
        t = sum(v for name, v in per_name.items() if any(k in name for k in keys))
        return f"{t:.2f} ms ({t / busy:.1%})"

    print(f"phase 16 int8 serving profile: device busy {busy:.1f} ms in {n_events} device "
          f"events ({n_events / n_steps:.0f} per decode step); idle {1 - busy / ms_batch:.1%} "
          f"of {ms_batch:.1f} ms/batch; K8g {share('gemm_kernel')} (of it the thin kernel "
          f"{share('thin_gemm_kernel')} in {int8_linear.THIN_LAUNCHES} launches), "
          f"K8q {share('rowquant_kernel')}, K2f {share('mlp_fwd_kernel')}, K3 "
          f"{share('decode_attn_kernel')}; top: " + top_kernels(per_name), flush=True)
    del s2t, out, model
    torch.cuda.empty_cache()
    return {"ms": ms_batch, "launches": launches, "thin": thin, "results": results,
            "k8g": share("gemm_kernel"), "busy": busy}


# Decode-attention launch counters (agacs_tpu_torch/ops/decode_attn.py) by
# kernel name.
DECODE_COUNTERS = {"K3": "LAUNCHES", "K3a": "ANC_LAUNCHES", "K3-PE": "PE_LAUNCHES",
                   "K3a-PE": "ANC_PE_LAUNCHES", "K3-int8": "I8_LAUNCHES",
                   "K3a-int8": "ANC_I8_LAUNCHES", "K3s": "SHARED_LAUNCHES",
                   "K3s-int8": "SHARED_I8_LAUNCHES", "K3-f32": "F32_LAUNCHES",
                   "K3@48": "D48_LAUNCHES", "K3-long": "LONG_LAUNCHES"}


def decode_counts() -> dict:
    """Every serving kernel's launches: the decode attention's, K1f, K5,
    and the int8 products (K6, K8q, K8g, K2f)."""
    from agacs_tpu_torch.ops import decode_attn, flash_train, int8_serve, relpos_flash

    return {"K1f": flash_train.LAUNCHES, "K5": relpos_flash.LAUNCHES,
            **{k: getattr(decode_attn, v) for k, v in DECODE_COUNTERS.items()},
            "K6": int8_serve.LAUNCHES, **int8_counts()}


def reset_decode_counts() -> None:
    from agacs_tpu_torch.ops import decode_attn, flash_train, int8_serve, relpos_flash

    flash_train.LAUNCHES = relpos_flash.LAUNCHES = int8_serve.LAUNCHES = 0
    for v in DECODE_COUNTERS.values():
        setattr(decode_attn, v, 0)
    reset_int8_counts()


# A warm-up request decodes WARM_STEPS steps: every kernel of a step and of
# the encode launches in it, and the cuBLAS and cuDNN handles are made, at
# a twentieth of a 100-step request's time.
WARM_STEPS = 5


def warm_up(s2t, audio) -> None:
    s2t(audio)
    torch.cuda.synchronize()


def warm_turn(steps: int) -> int:
    """One turn of `--warm-turns`: phase 4's whisper-small with adapters
    (bf16, random weights from seed 0) on 8 x 15 s; for beam BEAM (loop
    scan) and then greedy, a warm-up request of `steps` steps, then two
    timed 100-step requests (the second a control, warm at every step).
    Printed as one line, `WARM_TURN {...}` (ms a request), with the
    caching allocator's cudaMalloc calls during the first timed request."""
    sys.path.insert(0, ROOT)
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig

    dev = torch.device("cuda:0")
    cfg = tw.make_config("small", adapter=True, adapter_encoder=True,
                         adapter_decoder=True, compute_dtype=torch.bfloat16)
    sd = tw.init_whisper_params(torch.Generator(device="cpu").manual_seed(0), cfg)
    model = tw.Whisper.from_state_dict(cfg, sd, device=dev)
    asr_cfg = ASRModelConfig(whisper=cfg)
    audio = (np.random.RandomState(0).randn(8, 15 * 16000) * 0.1).astype(np.float32)
    out = {}
    for name, beam in (("beam", BEAM), ("greedy", 1)):
        s2t = Speech2Text(model, asr_cfg, beam_size=beam, max_steps=100, loop="scan")
        warm_up(Speech2Text(model, asr_cfg, beam_size=beam, max_steps=steps, loop="scan"),
                audio)
        times, mallocs = [], torch.cuda.memory_stats().get("num_device_alloc", 0)
        for i in range(2):
            t0 = time.perf_counter()
            s2t(audio)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - mallocs
        out[name] = {"first_ms": times[0], "second_ms": times[1], "mallocs": mallocs}
    print("WARM_TURN " + json.dumps(out), flush=True)
    return 0


def warm_turns() -> None:
    """Serving after a warm-up request of 100 steps (a full request) and of
    WARM_STEPS, in turns (100, WARM_STEPS, WARM_STEPS, 100), one process
    each (`--warm-turn`): whether the shorter warm-up leaves the timed
    request anything to warm."""
    from agacs_tpu_torch.ops import cuda_lib

    for name in ("packed_flash_fwd", "decode_attn"):
        cuda_lib.build(name)
    for steps in (100, WARM_STEPS, WARM_STEPS, 100):
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                               "--warm-turn", str(steps)], cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("WARM_TURN ")]
        check(proc.returncode == 0 and len(found) == 1,
              f"warm turn {steps}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        print(f"warm-turns, a warm-up of {steps} steps: " + found[0].split(" ", 1)[1],
              flush=True)


def serve(label: str, model, asr_cfg, audio, beam: int, want: dict) -> dict:
    """One serving configuration on 8 x 15 s, 100 steps (beam: loop scan):
    a warm-up request (WARM_STEPS steps), then a timed one that must launch
    exactly `want` (every other counter 0)."""
    from agacs_tpu_torch.decode.speech2text import Speech2Text

    s2t = Speech2Text(model, asr_cfg, beam_size=beam, max_steps=100, loop="scan")
    warm_up(Speech2Text(model, asr_cfg, beam_size=beam, max_steps=WARM_STEPS, loop="scan"), audio)
    reset_decode_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = s2t(audio)
    ms = (time.perf_counter() - t0) * 1e3
    launches = decode_counts()
    want = {k: want.get(k, 0) for k in launches}
    check(launches == want, f"{label} launches {launches} == {want}")
    check(len(results) == 8 and all(r.tokens[:5] == PRIMER and 5 < len(r.tokens) <= 106
                                    and np.isfinite(r.score) for r in results),
          f"{label}: 8 hypotheses")
    return {"results": results, "launches": {k: v for k, v in launches.items() if v},
            "ms": ms, "s2t": s2t,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


@contextlib.contextmanager
def w8a16_env(value: str):
    """AGACS_W8A16 set to `value` inside the block (the wrappers read it at
    call time), unset after it."""
    os.environ["AGACS_W8A16"] = value
    try:
        yield
    finally:
        del os.environ["AGACS_W8A16"]


def model_pair(sd, dev, **flags) -> dict:
    """A whisper-small model built from `sd` (which may hold int8 buffers
    and an int8 head) with config `flags` (by default the stage-2 recipe's
    adapters) on the card (bf16) and on the CPU (float32): {"card":
    (model, asr_cfg), "cpu": (model, asr_cfg)}."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig

    flags = flags or dict(adapter=True, adapter_encoder=True, adapter_decoder=True)
    out = {}
    for role, d, dtype in (("card", dev, torch.bfloat16),
                           ("cpu", torch.device("cpu"), torch.float32)):
        cfg = tw.make_config("small", compute_dtype=dtype, **flags)
        out[role] = (tw.Whisper.from_state_dict(cfg, sd, device=d),
                     ASRModelConfig(whisper=cfg))
    return out


def w8a16_serve_phase(sd8, dev, audio, int8_greedy: dict) -> dict:
    """Phase 32: phase 16's int8-trunk greedy request under AGACS_W8A16=1:
    every thin-row product (the decode step's self q, k, v, out, cross q,
    out, fc1, fc2 at 8 rows) on K6, K8 left in the encoder and the cross-KV
    projections; first-step logits card bf16 against the CPU in float32
    (under "interpret", so the CPU runs K6's plain version too); K6's share
    of the device time beside phase 16's K8g."""
    models = model_pair(sd8, dev)
    model, asr_cfg = models["card"]
    cfg = model.cfg
    n_steps = min(len(PRIMER) + 100, cfg.n_text_ctx) - 1
    L = cfg.n_text_layer
    want = {"K1f": cfg.n_audio_layer, "K3": 2 * L * n_steps, "K2f": cfg.n_audio_layer,
            "K6": 8 * L * n_steps, "K8g": 2 * cfg.n_audio_layer + 2 * L,
            "K8q": 2 * cfg.n_audio_layer + 2 * L}
    with w8a16_env("1"):
        run = serve("phase 32 W8A16 greedy", model, asr_cfg, audio, 1, want)
        # one device kernel a K6 call (no second pass)
        busy, n_events, per_name = exact_profile(
            "W8A16 profile: one launch a K6 call", lambda: run["s2t"](audio),
            lambda: {"w8a16_kernel": decode_counts()["K6"]}, reset_decode_counts)
        k6_calls = decode_counts()["K6"]
    check(k6_calls == want["K6"], f"W8A16 profile: {k6_calls} K6 calls (want {want['K6']})")
    with w8a16_env("interpret"):
        (lg_c, _), (lg_g, _) = (first_step(m, c, audio[:1]) for m, c in
                                (models["cpu"], models["card"]))
    e_log = rel_l2(lg_g, lg_c)
    k6 = sum(v for name, v in per_name.items() if "w8a16_kernel" in name)
    print(f"phase 32 W8A16 int8 greedy: whisper-small+adapters, int8 trunk, AGACS_W8A16=1, "
          f"8 x 15 s, {n_steps} steps: {run['ms']:.1f} ms/batch (one request; phase 16 W8A8: "
          f"{int8_greedy['ms']:.1f}), launches {run['launches']}; tokens vs phase 16: "
          f"{agreement(run['results'], int8_greedy['results'])}; first-step logits card vs "
          f"cpu f32 rel L2 {e_log:.3e} (bound {INT8_LOGITS_REL_L2}); profile: busy "
          f"{busy:.1f} ms in {n_events} events, idle {1 - busy / run['ms']:.1%}, K6 {k6:.2f} "
          f"ms ({k6 / busy:.1%}) in {k6_calls} launches [phase 16: "
          f"K8g {int8_greedy['k8g']} of "
          f"{int8_greedy['busy']:.1f} ms busy]; top: " + top_kernels(per_name), flush=True)
    check(bool(torch.isfinite(lg_g).all()) and e_log < INT8_LOGITS_REL_L2,
          f"W8A16 first-step logits rel L2 {e_log} < {INT8_LOGITS_REL_L2}")
    del run["s2t"], models, model
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "ms": run["ms"]}


def quant_profile(s2t, audio, ms_batch: float) -> str:
    """One more request of a serving-quantised model under the profiler:
    one device kernel a K6 and a K8g call; device busy, idle share, and
    K6's and thin K8g's device ms."""
    from agacs_tpu_torch.ops import int8_linear

    busy, n_events, per_name = exact_profile(
        "phase 33 profile: one launch a K6 and a K8g call", lambda: s2t(audio),
        lambda: {"w8a16_kernel": decode_counts()["K6"],
                 "thin_gemm_kernel": int8_linear.THIN_LAUNCHES,
                 "gemm_kernel": decode_counts()["K8g"]}, reset_decode_counts)
    calls = decode_counts()

    def ms(word):
        t = sum(v for name, v in per_name.items() if word in name)
        return f"{t:.2f} ms ({t / busy:.1%})"

    return (f"busy {busy:.1f} ms in {n_events} events, idle {1 - busy / ms_batch:.1%}, K6 "
            f"{ms('w8a16_kernel')} in {calls['K6']} launches, K8g thin "
            f"{ms('thin_gemm_kernel')} in {int8_linear.THIN_LAUNCHES}, K8g in all "
            f"{ms('gemm_kernel')}")


def serving_quant_phase(sd, dev, audio) -> dict:
    """Phase 33: `quantize_for_serving` of phase 4's weights (on the CPU
    in float32, as JAX quantises a checkpoint), served on the card: greedy
    and beam 5, without and with AGACS_W8A16=1. The logits head runs K6
    once a step in every request; the trunk's products run K6 for thin
    rows under the variable (greedy: 8 rows) and K8 otherwise (beam: 40
    rows); first-step logits card against CPU float32."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.ops import int8_serve

    cpu = model_pair(sd, dev)["cpu"][0]
    sdq = int8_serve.quantize_for_serving(cpu).state_dict()
    models = model_pair(sdq, dev)
    model, asr_cfg = models["card"]
    cfg = model.cfg
    L, E = cfg.n_text_layer, cfg.n_audio_layer
    n_steps = min(len(PRIMER) + 100, cfg.n_text_ctx) - 1
    out, line = {}, []
    for env in ("0", "1"):
        for beam in (1, BEAM):
            thin = env == "1" and beam == 1
            want = {"K1f": E, "K2f": E, "K6": n_steps * (1 + (8 * L if thin else 0)),
                    "K8g": 2 * E + 2 * L + (0 if thin else 8 * L * n_steps),
                    "K8q": 2 * E + 2 * L}  # the wide products': `thin_matmul` folds it in
            if beam == 1:
                want["K3"] = 2 * L * n_steps
            else:
                want.update({"K3a": L * n_steps, "K3s": L * n_steps})
            with w8a16_env(env):
                run = serve(f"phase 33 AGACS_W8A16={env} beam {beam}", model, asr_cfg,
                            audio, beam, want)
            out[(env, beam)] = run
            line.append(f"AGACS_W8A16={env} beam {beam}: {run['ms']:.1f} ms/batch, K6 "
                        f"{run['launches'].get('K6', 0)}")
            if env == "0":  # the default: the device time of K6's head and thin K8g
                line[-1] += ", profile: " + quant_profile(run["s2t"], audio, run["ms"])
            del run["s2t"]
    (lg_c, _), (lg_g, _) = (first_step(m, c, audio[:1]) for m, c in
                            (models["cpu"], models["card"]))
    e_log = rel_l2(lg_g, lg_c)
    print(f"phase 33 serving-quantised (int8 trunk, int8 token table and logits head "
          f"(768, 52224)), 8 x 15 s, {n_steps} steps: " + "; ".join(line) + f"; greedy "
          f"tokens with vs without the variable: "
          f"{agreement(out[('1', 1)]['results'], out[('0', 1)]['results'])}; first-step "
          f"logits card vs cpu f32 rel L2 {e_log:.3e} (bound {INT8_LOGITS_REL_L2})",
          flush=True)
    check(bool(torch.isfinite(lg_g).all()) and e_log < INT8_LOGITS_REL_L2,
          f"serving-quantised first-step logits rel L2 {e_log} < {INT8_LOGITS_REL_L2}")
    check(isinstance(model.decoder.blocks[0].mlp[0], tw.Int8Linear)
          and model.decoder.logits_w_q.shape == (cfg.n_text_state, 52224),
          "the served model carries the int8 trunk and the int8 head")
    del models, model, cpu, sdq
    torch.cuda.empty_cache()
    return {k: v["launches"] for k, v in out.items()}


def side_state() -> dict:
    """The side-network model's random float32 state dict (SIDE_SEED)."""
    from agacs_tpu_torch.models import whisper as tw

    cfg = tw.make_config("small", side_network=tw.SideNetworkConfig())
    return tw.init_whisper_params(torch.Generator().manual_seed(SIDE_SEED), cfg)


def side_serve_phase(dev, audio) -> dict:
    """Phase 34: greedy and beam 5 on the side-network model (8 x 15 s, 100
    steps) with exact launches: K3 at d_head 48 for the ladder's 6 self-
    and 6 cross-attentions a step, the trunk's plain-row K3 24 a step (a
    side beam keeps per-row caches: no K3a, no K3s); first-step logits card
    against CPU float32; each beam hypothesis's score against its
    teacher-forced rescoring (card bf16)."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import encode

    models = model_pair(side_state(), dev, side_network=tw.SideNetworkConfig())
    model, asr_cfg = models["card"]
    cfg = model.cfg
    n_steps = min(len(PRIMER) + 100, cfg.n_text_ctx) - 1
    n_side = len(cfg.side_network.layers)
    want = {"K1f": cfg.n_audio_layer, "K3": 2 * cfg.n_text_layer * n_steps,
            "K3@48": 2 * n_side * n_steps}
    greedy = serve("phase 34 side greedy", model, asr_cfg, audio, 1, want)
    beam = serve("phase 34 side beam", model, asr_cfg, audio, BEAM, want)
    (lg_c, enc_c), (lg_g, _) = (first_step(m, c, audio[:1]) for m, c in
                                (models["cpu"], models["card"]))
    e_log = rel_l2(lg_g, lg_c)
    limit = len(PRIMER) + 100 - 1
    with torch.inference_mode():
        enc, _ = encode(model, asr_cfg, torch.from_numpy(audio).to(dev),
                        torch.full((audio.shape[0],), audio.shape[1], device=dev))
    scores = np.array([r.score for r in beam["results"]])
    resc = np.abs(rescore(model, enc, [r.tokens for r in beam["results"]], limit) / scores - 1)
    busy, _, per_name = device_profile(lambda: greedy["s2t"](audio))
    k3_48 = sum(t for name, t in per_name.items()
                if "decode_attn_kernel" in name and ", 48>" in name)
    k3 = sum(t for name, t in per_name.items() if "decode_attn_kernel" in name) - k3_48
    print(f"phase 34 side greedy profile: device busy {busy:.1f} ms, idle "
          f"{1 - busy / greedy['ms']:.1%} of {greedy['ms']:.1f} ms/batch; K3@48 {k3_48:.2f} ms, "
          f"trunk K3 {k3:.2f} ms; top: " + top_kernels(per_name), flush=True)
    print(f"phase 34 side network (whisper-small + ladder 192 x 4 heads, taps "
          f"{list(cfg.side_network.layers)}), bf16, 8 x 15 s, {n_steps} steps: greedy "
          f"{greedy['ms']:.1f} ms/batch, beam {BEAM} {beam['ms']:.1f} ms/batch (peak "
          f"{beam['peak_gb']:.2f} GB); launches greedy {greedy['launches']} beam "
          f"{beam['launches']}; first-step logits card vs cpu f32 rel L2 {e_log:.3e} "
          f"(bound {LOGITS_REL_L2}); beam score vs teacher-forced rescore (rel, max over 8) "
          f"{resc.max():.2e} (bound {RESCORE_REL['card']})", flush=True)
    check(bool(torch.isfinite(lg_g).all()) and e_log < LOGITS_REL_L2,
          f"side first-step logits rel L2 {e_log} < {LOGITS_REL_L2}")
    check(resc.max() <= RESCORE_REL["card"], f"side beam rescore rel {resc.max()}")
    del greedy["s2t"], beam["s2t"], models, model
    torch.cuda.empty_cache()
    return {"greedy": greedy["launches"], "beam": beam["launches"]}


def side_train_phase(dev) -> dict:
    """Phase 35: the `sidenetwork` step on 16 x 15 s (AdamW, WarmupLR 500,
    clip 1.0, SpecAug): one warm-up and 3 timed steps, exact launches (K1f
    12 a step in the frozen trunk's encoder, K1b none: nothing upstream of
    the trunk trains), the trunk bit-identical, every ladder parameter
    changed; its profile; then one micro-step card bf16 against CPU float32
    (loss, grad norm, the encoder and decoder ladders' gradient cosines)."""
    from agacs_tpu_torch.ops import flash_train
    from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step

    sd = side_state()
    model, params, acfg = train_model(sd, dev, torch.bfloat16, specaug=True, side=True)
    opt, sched = build_optimizer(params, OptimConfig(warmup_steps=500))
    step = make_train_step(model, acfg, opt, sched, grad_clip=1.0,
                           generator=torch.Generator().manual_seed(1))
    batch = make_train_batch(TRAIN_B, TRAIN_S, dev)
    trainable = {id(p) for p in params}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if id(p) not in trainable}
    before = [p.detach().clone() for p in params]
    step([batch])
    torch.cuda.synchronize()
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        stats = step([batch])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"K1f": flash_train.LAUNCHES, "K1b": flash_train.BWD_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times) * 1e3
    check(np.isfinite(float(stats["loss"])) and int(stats["grad_nonfinite_total"]) == 0,
          "finite side-network losses")
    check(launches == {"K1f": 3 * acfg.whisper.n_audio_layer, "K1b": 0},
          f"side training launches {launches} == K1f 12, K1b 0 a step")
    check(all(torch.equal(dict(model.named_parameters())[n], t) for n, t in frozen.items()),
          "the frozen trunk bit-identical after the steps")
    check(all(not torch.equal(a, p) for a, p in zip(before, params)),
          "every ladder parameter changed")
    busy, n_events, per_name = device_profile(lambda: step([batch]))
    del model, opt, frozen, before
    torch.cuda.empty_cache()
    one = {k: v[:1] for k, v in batch.items()}
    ref = micro_step(sd, torch.device("cpu"), torch.float32, one, side=True)
    run = micro_step(sd, dev, torch.bfloat16, one, side=True)
    card = parity(run, ref, ("encoder_side.", "decoder_side."))
    print(f"phase 35 side training: whisper-small + ladder, bf16 trunk / f32 ladders, "
          f"`sidenetwork`, {TRAIN_B} x {TRAIN_S} s, SpecAug on: {ms:.1f} ms/step (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {TRAIN_B * TRAIN_S / (ms / 1e3):.1f} "
          f"audio-s/s; peak {peak_gb:.2f} GB; {sum(p.numel() for p in params) / 1e6:.2f}M "
          f"trainable; launches {launches}; profile: busy {busy:.1f} ms in {n_events} "
          f"events, idle {1 - busy / ms:.1%}; top: {top_kernels(per_name)}; micro-step card "
          f"bf16 vs cpu f32: {fmt_parity(card)}; bounds {SIDE_TRAIN_REL} {SIDE_TRAIN_COS}",
          flush=True)
    for key, bound in SIDE_TRAIN_REL.items():
        check(card[key] <= bound, f"side train parity {key} rel {card[key]} <= {bound}")
    for key, bound in SIDE_TRAIN_COS.items():
        check(card[key] >= bound, f"side train parity {key} {card[key]} >= {bound}")
    return {"launches": launches, "ms": ms}


def first_step(model, asr_cfg, audio1) -> tuple[torch.Tensor, torch.Tensor]:
    """(the first decode step's float32 logits, the encoder output) of one
    utterance, both on the CPU."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import encode

    d = next(model.parameters()).device
    with torch.inference_mode():
        enc, _ = encode(model, asr_cfg, torch.from_numpy(audio1).to(d),
                        torch.tensor([audio1.shape[1]], device=d))
        kv = tw.init_self_kv_cache(model.cfg, 1, 16, device=d)
        logits, _ = tw.whisper_decode_step(model, torch.tensor([PRIMER[0]], device=d), 0,
                                           kv, tw.precompute_cross_kv(model, enc))
    return logits.float().cpu(), enc.float().cpu()


def agreement(a, b) -> str:
    """How far two runs' hypotheses agree: identical utterances, and the
    share of equal tokens over each pair's common length."""
    same = sum(x.tokens == y.tokens for x, y in zip(a, b))
    eq = [np.mean([s == t for s, t in zip(x.tokens, y.tokens)]) for x, y in zip(a, b)]
    return f"{same}/{len(a)} identical, {np.mean(eq):.1%} of tokens equal"


def int8_cross_phase(model, sd, asr_cfg, audio, bf16_greedy: dict, bf16_beam: dict) -> dict:
    """Phase 18: `--cross_kv_int8` on phase 4's stage-2 model: greedy (K3 for
    the self-, K3-int8 for the cross-attention) and beam 5 (K3a, K3s-int8)
    with exact launches; the int8 buffers and scales bit-identical to the
    plain quantisation (on the CPU, float32) of the bf16 cross-KV; the
    first-step logits within INT8_CROSS_LOGITS_REL_L2 of the bf16
    cross-KV's; token agreement with phases 4 and 10 (`bf16_greedy`,
    `bf16_beam`: their "s2t" and "results"); and ms/batch of bf16 and int8
    cross-KV timed alternately in this process."""
    import dataclasses

    import torch.nn.functional as F

    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode

    dev = next(model.parameters()).device
    cfg8 = dataclasses.replace(model.cfg, cross_kv_int8=True)
    model8 = tw.Whisper.from_state_dict(cfg8, sd, device=dev)
    acfg8 = ASRModelConfig(whisper=cfg8)
    per = model.cfg.n_text_layer * (min(len(PRIMER) + 100, model.cfg.n_text_ctx) - 1)
    enc_layers = model.cfg.n_audio_layer
    # one timed request each: the loop below times both cross-KV forms in turns
    greedy = serve("int8 cross-KV greedy", model8, acfg8, audio, 1,
                   {"K1f": enc_layers, "K3": per, "K3-int8": per})
    beam = serve("int8 cross-KV beam", model8, acfg8, audio, BEAM,
                 {"K1f": enc_layers, "K3a": per, "K3s-int8": per})
    with torch.inference_mode():
        enc, _ = encode(model, asr_cfg, torch.from_numpy(audio).to(dev),
                        torch.full((audio.shape[0],), audio.shape[1], device=dev))
        kv16, kv8 = tw.precompute_cross_kv(model, enc), tw.precompute_cross_kv(model8, enc)
    tp = kv8["k_packed"][0].shape[1]
    for name in ("k", "v"):
        for l, x in enumerate(kv16[f"{name}_packed"]):
            q, s = tw.quantize_kv(F.pad(x.float().cpu(), (0, 0, 0, tp - x.shape[1])))
            check(torch.equal(kv8[f"{name}_packed"][l].cpu(), q)
                  and torch.equal(kv8[f"{name}_scale"][l].cpu(), s),
                  f"layer {l} int8 {name} buffer and scales identical to the plain "
                  "quantisation")
    e_log = rel_l2(first_step(model8, acfg8, audio[:1])[0],
                   first_step(model, asr_cfg, audio[:1])[0])
    check(e_log < INT8_CROSS_LOGITS_REL_L2,
          f"int8 cross-KV first-step logits rel L2 {e_log} < {INT8_CROSS_LOGITS_REL_L2}")
    runs = {("bf16", 1): bf16_greedy["s2t"], ("int8", 1): greedy["s2t"],
            ("bf16", BEAM): bf16_beam["s2t"], ("int8", BEAM): beam["s2t"]}
    alt = {key: [] for key in runs}
    for _ in range(2):
        for key, s2t in runs.items():
            t0 = time.perf_counter()
            s2t(audio)
            alt[key].append((time.perf_counter() - t0) * 1e3)
    ms = {key: statistics.median(v) for key, v in alt.items()}
    busy, n_events, per_name = device_profile(lambda: greedy["s2t"](audio))
    k3i8 = sum(t for name, t in per_name.items() if "signed char>" in name)
    print(f"phase 18 int8 cross-KV serving (stage-2 model, bf16, 8 x 15 s, 100 steps): "
          f"greedy {greedy['ms']:.1f} ms/batch, beam {BEAM} {beam['ms']:.1f} ms/batch "
          f"(one request each); alternating with the bf16 cross-KV, median of 2 each: greedy "
          f"bf16 {ms[('bf16', 1)]:.1f} / int8 {ms[('int8', 1)]:.1f} ms, beam bf16 "
          f"{ms[('bf16', BEAM)]:.1f} / int8 {ms[('int8', BEAM)]:.1f} ms; launches greedy "
          f"{greedy['launches']} beam {beam['launches']}; Tp {tp}, int8 buffers and "
          f"scales identical to the plain quantisation; first-step logits vs bf16 "
          f"cross-KV rel L2 {e_log:.3e} (bound {INT8_CROSS_LOGITS_REL_L2}); tokens vs "
          f"phase 4: {agreement(greedy['results'], bf16_greedy['results'])}, beam vs "
          f"phase 10: {agreement(beam['results'], bf16_beam['results'])}; greedy profile: "
          f"device busy {busy:.1f} ms in {n_events} events, K3-int8 {k3i8:.2f} ms; top: "
          + top_kernels(per_name, 4), flush=True)
    del model8, greedy["s2t"], beam["s2t"]
    return {"greedy": greedy["launches"], "beam": beam["launches"], "ms": ms}


def pe_serve_phase(dev, audio) -> dict:
    """Phases 19 and 20: a PE decoder (the TMECS pedecoder recipes' layout),
    whisper-small, bf16, random weights from torch seed 1: greedy (K3-PE
    for the self-, K3 for the cross-attention) and beam 5 (K3a-PE, K3s) on
    8 x 15 s, 100 steps, with exact launches; the first-step logits against
    the port on the CPU in float32 (LOGITS_REL_L2); then phase 12's checks
    of the beam request (rescoring, plain-attention control, and the
    physical-gather search on K3-PE rows)."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig

    cfg = tw.make_config("small", pe_decoder=True, compute_dtype=torch.bfloat16)
    sd = tw.init_whisper_params(torch.Generator().manual_seed(1), cfg)
    model = tw.Whisper.from_state_dict(cfg, sd, device=dev)
    asr_cfg = ASRModelConfig(whisper=cfg)
    per = cfg.n_text_layer * (min(len(PRIMER) + 100, cfg.n_text_ctx) - 1)
    greedy = serve("PE greedy", model, asr_cfg, audio, 1,
                   {"K1f": cfg.n_audio_layer, "K3-PE": per, "K3": per})
    beam = serve("PE beam", model, asr_cfg, audio, BEAM,
                 {"K1f": cfg.n_audio_layer, "K3a-PE": per, "K3s": per})
    cpu_cfg = tw.make_config("small", pe_decoder=True, compute_dtype=torch.float32)
    cpu_model = tw.Whisper.from_state_dict(cpu_cfg, sd, device="cpu")
    lg_card, _ = first_step(model, asr_cfg, audio[:1])
    lg_cpu, enc_cpu = first_step(cpu_model, ASRModelConfig(whisper=cpu_cfg), audio[:1])
    e_log = rel_l2(lg_card, lg_cpu)
    busy, n_events, per_name = device_profile(lambda: greedy["s2t"](audio))
    k3pe = sum(t for name, t in per_name.items() if "decode_attn_kernel<false, true," in name)
    print(f"phase 19 PE serving: whisper-small, PE decoder, bf16, 8 x 15 s, 100 steps: "
          f"greedy {greedy['ms']:.1f} ms/batch ({120.0 / (greedy['ms'] / 1e3):.1f} x "
          f"realtime), beam {BEAM} {beam['ms']:.1f} ms/batch, peak {beam['peak_gb']:.2f} "
          f"GB; launches greedy {greedy['launches']} beam {beam['launches']}; first-step "
          f"logits card bf16 vs cpu f32 rel L2 {e_log:.3e} (bound {LOGITS_REL_L2}), argmax "
          f"card {int(lg_card.argmax())} cpu {int(lg_cpu.argmax())}; greedy profile: device "
          f"busy {busy:.1f} ms in {n_events} events "
          f"({n_events * cfg.n_text_layer / per:.0f} per step), K3-PE {k3pe:.2f} ms; top: "
          + top_kernels(per_name, 4), flush=True)
    check(bool(torch.isfinite(lg_card).all()) and e_log < LOGITS_REL_L2,
          f"PE first-step logits rel L2 {e_log} < {LOGITS_REL_L2}")
    e2e = beam_e2e(model, asr_cfg, audio, beam, cpu_model, enc_cpu, phase=20,
                   rows="K3-PE", anc="K3a-PE")
    del model, cpu_model, greedy["s2t"], beam["s2t"]
    torch.cuda.empty_cache()
    return {"greedy": greedy["launches"], "beam": beam["launches"], "e2e": e2e}


def pe_train_phase(dev) -> dict:
    """Phases 21-23: the TMECS cs_loss_pe recipe's step (PE in both stacks,
    preset `whisper_pe`, cs_weight 1.0 over the PE decoder's p_cols,
    SpecAug on, AdamW + WarmupLR 500, clip 1.0) on whisper-small with random
    weights from torch seed 2, bf16 with every frozen leaf stored bf16, on
    phase 7's 16 x 15 s batch: one warm-up and 5 timed steps (a PE block
    bypasses K1, so no kernel of this repository runs: no launch), only
    query_cs / key_cs change, everything frozen (the gates among it)
    bit-identical; one more step under the profiler; and one micro-step,
    the card (bf16) against the port on the CPU (float32), SpecAug off:
    loss, loss_cs, grad norm and the *_cs gradient cosines per stack."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.ops import flash_train
    from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step

    sd = tw.init_whisper_params(torch.Generator().manual_seed(2),
                                tw.make_config("small", pe_attention=True))
    model, params, acfg = train_model(sd, dev, torch.bfloat16, specaug=True, pe=True)
    names = {id(p): n for n, p in model.named_parameters()}
    check(len(params) == 3 * 24 and all("_cs." in names[id(p)] for p in params),
          "only query_cs (w, b) and key_cs (w) train, in 24 PE blocks")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters() if not p.requires_grad),
          "every frozen parameter (the gates, layer norms and embeddings among them) "
          "stored bf16")
    opt, sched = build_optimizer(params, OptimConfig(warmup_steps=500))
    step = make_train_step(model, acfg, opt, sched, grad_clip=1.0,
                           generator=torch.Generator().manual_seed(1))
    batch = make_train_batch(TRAIN_B, TRAIN_S, dev)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    before = [p.detach().clone() for p in params]
    step([batch])
    torch.cuda.synchronize()
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        stats = step([batch])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(stats["loss"]), float(stats["loss_cs"])))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(v) for pair in losses for v in pair)
          and int(stats["grad_nonfinite_total"]) == 0, f"finite PE losses {losses}")
    check(flash_train.LAUNCHES == flash_train.BWD_LAUNCHES == 0,
          "the PE encoder bypasses K1")
    state = dict(model.named_parameters())
    check(all(torch.equal(state[n], t) for n, t in frozen.items()),
          "every frozen parameter (the gates among them) bit-identical after the steps")
    check(all(not torch.equal(a, p) for a, p in zip(before, params)),
          "every query_cs / key_cs parameter changed")
    ms = statistics.median(times) * 1e3
    audio_s = TRAIN_B * TRAIN_S
    print(f"phase 21 PE train: whisper-small, PE both stacks, whisper_pe, bf16 frozen / "
          f"f32 *_cs, {TRAIN_B} x {TRAIN_S} s, cs_weight 1.0, SpecAug on: {ms:.1f} ms/step "
          f"(median of {[round(t * 1e3, 1) for t in times]}), {audio_s / (ms / 1e3):.1f} "
          f"audio-s/s; peak {peak_gb:.2f} GB; {sum(p.numel() for p in params) / 1e6:.2f}M "
          f"trainable; losses (loss, loss_cs) "
          f"{[(round(a, 3), round(c, 4)) for a, c in losses]}", flush=True)
    busy, n_events, per_name = device_profile(lambda: step([batch]))
    print(f"phase 22 PE train profile: device busy {busy:.1f} ms in {n_events} device "
          f"events; idle {1 - busy / ms:.1%} of phase 21's {ms:.1f} ms/step; top: "
          + top_kernels(per_name, 10), flush=True)
    del model, opt, frozen, before, step
    torch.cuda.empty_cache()

    one = {k: v[:1] for k, v in batch.items()}
    ref = micro_step(sd, torch.device("cpu"), torch.float32, one, pe=True)
    run = micro_step(sd, dev, torch.bfloat16, one, pe=True)
    card = parity(run, ref)
    print(f"phase 23 PE train parity vs cpu f32 (1 x {TRAIN_S} s; rel errors, cosines of "
          f"the *_cs gradients): card bf16 {fmt_parity(card)}; bounds {PE_TRAIN_REL} "
          f"{PE_TRAIN_COS}", flush=True)
    check(all(np.isfinite(x) for x in (run[0], run[1]))
          and all(bool(torch.isfinite(g).all()) for g in run[2].values()),
          "finite PE card loss and grads")
    for key, bnd in PE_TRAIN_REL.items():
        check(card[key] <= bnd, f"PE train parity {key} rel {card[key]} <= {bnd}")
    for key, bnd in PE_TRAIN_COS.items():
        check(card[key] >= bnd, f"PE train parity {key} {card[key]} >= {bnd}")
    return {"ms": ms, "peak_gb": peak_gb, "parity": card}


# The conformer recipe's serving (run_conformer.sh stage 4, decode_asr.yaml):
# beam 10, ctc_weight 0.4, lm_weight 0.2, a step cap of 100 (loop scan: the
# step runs 100 times whatever ends).
CONF_BEAM, CONF_CTC, CONF_LM, CONF_S = 10, 0.4, 0.2, 100
# Phase 26 profiles the request at 5 steps: it launches ~3100 kernels a
# step, and collecting the events of 20 steps took ~35 s.
CONF_PROFILE_S = 5
# card (bf16 encoder and decoder, float32 LM) vs CPU (float32): bf16
# rounding through 12 conformer blocks, as ENC_REL_L2.
CONF_REL_L2 = 5e-2


def conformer_models(dev, dtype, sd=None, lsd=None, lm_blocks: int = 16, raw=None):
    """The recipe's conformer (train_asr_conformer.yaml: 12 blocks, d 256,
    4 heads, units 2048, kernel 15, decoder 6 blocks, vocabulary 51865,
    global MVN; or the config `raw`) in `dtype` and the transformer LM (d
    512, 8 heads, units 2048, `lm_blocks` blocks) in float32 on `dev`,
    random weights from torch seeds 3 and 4 unless state dicts are given.
    Returns (model, lm, sd, lsd)."""
    import dataclasses

    from agacs_tpu_torch.models import conformer_asr, lm as tlm
    from agacs_tpu_torch.utils.config import task_from_dict

    raw = raw or conformer_raw()
    # identity MVN statistics: the recipe's stats file is stage 1's output
    cfg = dataclasses.replace(task_from_dict(raw, compute_dtype=dtype).cfg,
                              mvn_stats_path=None)
    lcfg = tlm.TransformerLMConfig(num_blocks=lm_blocks)
    if sd is None:
        sd = conformer_asr.init_conformer_asr_params(torch.Generator().manual_seed(3), cfg)
    if lsd is None:
        lsd = tlm.init_lm_params(torch.Generator().manual_seed(4), lcfg)
    return (conformer_asr.ConformerASR.from_state_dict(cfg, sd, device=dev),
            tlm.TransformerLM.from_state_dict(lcfg, lsd, device=dev), sd, lsd)


def first_step_joint(model, lm, audio1, cands=None):
    """Utterance 0's first joint-beam step, in the model's device and dtype:
    (the joint scores (1-l)·log p_att + m·log p_lm + l·psi_ctc over
    `cands` (default: the 20 best by attention + LM, the recipe's pre-beam),
    cands, the encoder output), all float32 on the CPU."""
    from agacs_tpu_torch.decode.composed_beam import top_k
    from agacs_tpu_torch.decode.ctc_prefix import (ctc_eos_score, ctc_prefix_init,
                                                   ctc_prefix_score)
    from agacs_tpu_torch.models import conformer as tconf, lm as tlm
    from agacs_tpu_torch.models.conformer_asr import ctc_log_probs, encode

    d = next(model.parameters()).device
    sos, eos = model.cfg.sos, model.cfg.eos
    with torch.inference_mode():
        enc, elen = encode(model, torch.from_numpy(audio1).to(d),
                           torch.tensor([audio1.shape[1]], device=d))
        logp = ctc_log_probs(model, enc)
        first = torch.tensor([sos], device=d)
        logits, _ = tconf.transformer_decode_step(
            model.decoder, first, 0, tconf.init_decoder_kv_cache(model.cfg.decoder, 1, 8, d),
            tconf.precompute_decoder_cross_kv(model.decoder, enc), elen)
        lm_lp, _ = tlm.lm_score_step_cached(lm, first, 0, tlm.init_lm_kv_cache(lm.cfg, 1, 8, d))
        full = (1 - CONF_CTC) * torch.log_softmax(logits.float(), -1) + CONF_LM * lm_lp
        if cands is None:
            cands = top_k(full, 2 * CONF_BEAM)[1]
        cands = cands.to(d)
        state = ctc_prefix_init(logp)
        psi, _ = ctc_prefix_score(logp, state, cands, frame_lens=elen)
        psi = torch.where(cands == eos, ctc_eos_score(state, elen)[:, None], psi)
        joint = full.gather(1, cands) + CONF_CTC * psi
    return joint.float().cpu(), cands.cpu(), enc.float().cpu()


def conformer_serve_phase(dev, audio) -> dict:
    """Phases 25-27: the conformer recipe's serving at full width (encoder
    12 blocks bf16, decoder 6 blocks bf16, LM 16 blocks float32, vocabulary
    51865), random weights, on phase 4's 8 x 15 s, through
    `decode_conformer_batch` (the decode CLI's per-batch call): beam 10,
    ctc 0.4, lm 0.2, CONF_S steps. A warm-up, then a request with exact
    launch counts (K5 12 per encode, K3 6 per step, K3-f32 16 per step,
    nothing else), timed; one more with the CTC prefix scoring
    timed apart (synchronised around each call) for its share; a
    CONF_PROFILE_S-step request under the profiler beside the same
    request's wall time; and
    utterance 0's encoder output and first joint step against the port on
    the CPU in float32 (CONF_REL_L2)."""
    from agacs_tpu_torch.decode import ctc_prefix
    from agacs_tpu_torch.decode.joint_beam import decode_conformer_batch

    t0 = time.perf_counter()
    model, lm, sd, lsd = conformer_models(dev, torch.bfloat16)
    load_s = time.perf_counter() - t0
    speech = torch.from_numpy(audio).to(dev)
    lens = torch.full((audio.shape[0],), audio.shape[1], device=dev)

    def request(steps=CONF_S):
        out = decode_conformer_batch(model, lm, speech, lens, beam_size=CONF_BEAM,
                                     ctc_weight=CONF_CTC, lm_weight=CONF_LM,
                                     max_steps=steps, loop="scan")
        torch.cuda.synchronize()
        return out

    t_phase = time.perf_counter()
    request(10)  # warm-up: cuBLAS handles, the kernels' first launches
    reset_decode_counts()
    t0 = time.perf_counter()
    rows, scores = request()
    times = [time.perf_counter() - t0]
    launches = {k: v for k, v in decode_counts().items() if v}
    want = {"K5": model.cfg.encoder.num_blocks,
            "K3": model.cfg.decoder.num_blocks * CONF_S, "K3-f32": lm.cfg.num_blocks * CONF_S}
    check(launches == want, f"conformer serving launches {launches} == {want}")
    check(len(rows) == audio.shape[0] and bool(torch.isfinite(scores).all())
          and all(len(r) <= CONF_S for r in rows), "conformer serving: 8 finite hypotheses")
    ms = statistics.median(times) * 1e3

    real, ctc_s = ctc_prefix.ctc_prefix_score, []

    def timed_ctc(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        ctc_s.append(time.perf_counter() - t)
        return out

    ctc_prefix.ctc_prefix_score = timed_ctc
    try:
        t0 = time.perf_counter()
        request()
        ctc_req = time.perf_counter() - t0
    finally:
        ctc_prefix.ctc_prefix_score = real
    ctc_share = sum(ctc_s) / ctc_req
    print(f"phase 25 conformer serving: conformer 12 x 256 bf16 + decoder 6 + LM 16 x 512 "
          f"f32, vocabulary 51865, 8 x 15 s ({int(lens[0]) // 128 + 1} frames -> 468), beam "
          f"{CONF_BEAM}, ctc {CONF_CTC}, lm {CONF_LM}, {CONF_S} steps: {ms:.1f} ms/batch "
          f"(one request after a warm-up), {120.0 / (ms / 1e3):.1f} x "
          f"realtime, {ms / CONF_S:.2f} ms/step incl. encode; launches {launches}; CTC prefix "
          f"scoring {sum(ctc_s) * 1e3:.1f} ms of a {ctc_req * 1e3:.1f} ms request "
          f"({ctc_share:.1%}, {len(ctc_s)} calls, synchronised around each); lengths "
          f"{[len(r) for r in rows]}; models built in {load_s:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    t_short = []
    for _ in range(2):
        t0 = time.perf_counter()
        request(CONF_PROFILE_S)
        t_short.append((time.perf_counter() - t0) * 1e3)
    ms_short = statistics.median(t_short)
    busy, n_events, per_name = device_profile(lambda: request(CONF_PROFILE_S))

    def share(*keys):
        t = sum(v for name, v in per_name.items() if any(k in name for k in keys))
        return f"{t:.2f} ms ({t / busy:.1%})"

    print(f"phase 26 conformer serving profile (the same request at {CONF_PROFILE_S} steps): "
          f"{ms_short:.1f} ms/batch unprofiled; device busy {busy:.1f} ms in {n_events} device "
          f"events ({n_events / CONF_PROFILE_S:.0f} per step); idle {1 - busy / ms_short:.1%}; K5 "
          f"{share('relpos_flash')}, K3 {share('decode_attn_kernel<false, false, __nv')}, "
          f"K3-f32 {share('decode_attn_kernel<false, false, float')}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; top: " + top_kernels(per_name, 8), flush=True)
    t_phase = time.perf_counter()

    cpu_model, lm_cpu, _, _ = conformer_models("cpu", torch.float32, sd, lsd)
    j_cpu, cands, enc_cpu = first_step_joint(cpu_model, lm_cpu, audio[:1])
    j_card, _, enc_card = first_step_joint(model, lm, audio[:1], cands)
    e_enc, e_joint = rel_l2(enc_card, enc_cpu), rel_l2(j_card, j_cpu)
    print(f"phase 27 conformer card (bf16, K5/K3/K3-f32) vs cpu f32: encoder rel L2 "
          f"{e_enc:.3e}, first-step joint scores over the {cands.shape[1]} pre-beam "
          f"candidates rel L2 {e_joint:.3e} (bounds {CONF_REL_L2}); best candidate card "
          f"{int(cands[0, j_card.argmax()])} cpu {int(cands[0, j_cpu.argmax()])}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(enc_card.shape == (1, 468, CD) and bool(torch.isfinite(enc_card).all())
          and e_enc <= CONF_REL_L2, f"conformer encoder rel L2 {e_enc} <= {CONF_REL_L2}")
    check(bool(torch.isfinite(j_card).all()) and e_joint <= CONF_REL_L2,
          f"conformer first-step joint scores rel L2 {e_joint} <= {CONF_REL_L2}")
    del model, lm, cpu_model, lm_cpu
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "ctc_share": ctc_share, "sd": sd}


def conformer_cli_phase(sd) -> dict:
    """Phase 28: the recipe's stages 1-5 on the card, on `cli_data`'s 6
    utterances: bin.collect_stats (stage 1), bin.lm_train (stage 2: the LM
    at 2 blocks, the rest at full width, one epoch), bin.train with
    train_asr_conformer.yaml (stage 3: 2 encoder and 2 decoder blocks, the
    rest at full width, one epoch, the stage-1 statistics), then bin.decode
    with decode_asr.yaml and the stage-2 LM on its n-best average and
    bin.score --per_bucket (stages 4, 5). Then bin.decode on phase 25's
    full-depth weights as a .params.npz with an LM exp dir (4 blocks), 8
    steps: exact launches K5 12, K3 6 x 8, K3-f32 4 x 8, a hypothesis for
    every utterance, and bin.score."""
    import shutil

    import yaml

    from agacs_tpu_torch.bin import collect_stats, decode, lm_train, score, train
    from agacs_tpu_torch.models import lm as tlm
    from agacs_tpu_torch.models.checkpoint import numpy_from_conformer_params, numpy_from_lm_params
    from agacs_tpu_torch.utils.config import load_yaml, task_from_dict

    conf_dir = os.path.join(ROOT, "recipes", "seame", "conf")
    config = os.path.join(conf_dir, "train_asr_conformer.yaml")
    root = os.path.join(ROOT, "build", "chip_smoke_cli_conformer")
    data, n_utts = cli_data(root)
    utts = {f"u{i}" for i in range(n_utts)}
    stage_s = {}
    t0 = time.perf_counter()
    stats = collect_stats.main(["--data_dir", data, "--output_dir", os.path.join(root, "stats")])
    stage_s[1] = time.perf_counter() - t0
    check(stats["n_frames"] > 0 and np.isfinite(stats["std"]).all(), "stage 1 statistics")
    t0 = time.perf_counter()
    lm_out = lm_train.main(["--train_text", os.path.join(data, "text"), "--valid_text",
                            os.path.join(data, "text"), "--exp_dir", os.path.join(root, "lm1"),
                            "--num_blocks", "2", "--max_epoch", "1"])
    stage_s[2] = time.perf_counter() - t0
    check(np.isfinite(lm_out["history"][1]["valid"]["loss"]), "stage 2 LM loss")
    reset_conformer_counts()
    t0 = time.perf_counter()
    out = train.main(["--config", config, "--train_dir", data, "--valid_dir", data,
                      "--exp_dir", os.path.join(root, "exp"), "--max_epoch", "1",
                      "--batch_bins", "150000", "--override", "encoder_conf.num_blocks=2",
                      "decoder_conf.num_blocks=2", "keep_nbest_models=1",
                      "normalize_conf.stats_file=" + os.path.join(root, "stats",
                                                                  "feats_stats.npz")])
    stage_s[3] = time.perf_counter() - t0
    train_counts = conformer_counts()
    hist = out["history"][1]
    check(np.isfinite(hist["train"]["loss"]) and hist["train"]["loss_ctc"] > 0
          and "cer" in hist["valid"], f"stage 3 history {hist}")
    check(all(train_counts[k] > 0 for k in CONF_TRAIN_LAUNCHES)
          and train_counts["K5"] % 2 == 0 and train_counts["K5 bwd"] % 2 == 0,
          f"stage 3 ran K5 and K4 both ways: {train_counts}")
    with np.load(out["ave"]) as ave:
        check(np.array_equal(ave["mvn/mean"], stats["mean"].astype(np.float32))
              and ave["encoder/blocks/attn/q/w"].shape == (2, 256, 256),
              "the stage-3 checkpoint holds the stage-1 statistics and 2 blocks")
    reset_decode_counts()
    t0 = time.perf_counter()
    res = decode.main(["--config", os.path.join(root, "exp", "config.yaml"), "--params",
                       out["ave"], "--data_dir", data, "--output_dir", os.path.join(root, "dec1"),
                       "--decode_config", os.path.join(conf_dir, "decode_asr.yaml"),
                       "--lm_exp", os.path.join(root, "lm1"), "--max_steps", "8"])
    stage_s[4] = time.perf_counter() - t0
    trained_counts = {k: v for k, v in decode_counts().items() if v}
    check(set(res["hyps"]) == utts and trained_counts == {"K5": 2, "K3": 2 * 8,
                                                          "K3-f32": 2 * 8},
          f"stage 4 on the trained checkpoint: launches {trained_counts}")
    rep1 = score.main(["--ref", os.path.join(root, "dec1", "ref.trn"), "--hyp",
                       os.path.join(root, "dec1", "hyp.trn"), "--output_dir",
                       os.path.join(root, "score1"), "--per_bucket"])
    check(rep1["mer"]["utts"] == n_utts, "stage 5 scored every utterance")
    print(f"phase 28a conformer recipe stages 1-5 on the card ({n_utts} utterances): "
          f"collect_stats {stats['n_frames']} frames {stage_s[1]:.1f} s; lm_train (2 x 512, "
          f"1 epoch) valid loss {lm_out['history'][1]['valid']['loss']:.3f} {stage_s[2]:.1f} s; "
          f"train (train_asr_conformer.yaml, 2 + 2 blocks, 1 epoch) loss "
          f"{hist['train']['loss']:.3f} valid cer {hist['valid']['cer']:.3f} {stage_s[3]:.1f} s, "
          f"launches {train_counts}; decode (decode_asr.yaml, the stage-2 LM, 8 steps) "
          f"{stage_s[4]:.1f} s, launches {trained_counts}; score MER {rep1['mer']['err']}%",
          flush=True)

    cfg = task_from_dict(load_yaml(config)).cfg
    np.savez(os.path.join(root, "p.params.npz"), **numpy_from_conformer_params(sd, cfg))
    lm_dir = os.path.join(root, "lm")
    os.makedirs(lm_dir)
    lcfg = tlm.TransformerLMConfig(num_blocks=4)
    with open(os.path.join(lm_dir, "config.yaml"), "w") as f:
        yaml.safe_dump({"lm_conf": {"num_blocks": 4}}, f)
    np.savez(os.path.join(lm_dir, "valid.loss.ave.params.npz"), **numpy_from_lm_params(
        tlm.init_lm_params(torch.Generator().manual_seed(5), lcfg), lcfg))
    reset_decode_counts()
    t0 = time.perf_counter()
    res = decode.main(["--config", config, "--params", os.path.join(root, "p.params.npz"),
                       "--data_dir", data, "--output_dir", os.path.join(root, "dec"),
                       "--decode_config", os.path.join(conf_dir, "decode_asr.yaml"),
                       "--lm_exp", lm_dir, "--max_steps", "8"])
    decode_s = time.perf_counter() - t0
    counts = {k: v for k, v in decode_counts().items() if v}
    check(set(res["hyps"]) == utts, "conformer bin.decode wrote a hypothesis for every utterance")
    check(counts == {"K5": 12, "K3": 6 * 8, "K3-f32": 4 * 8},
          f"conformer bin.decode launches {counts}")
    rep = score.main(["--ref", os.path.join(root, "dec", "ref.trn"), "--hyp",
                      os.path.join(root, "dec", "hyp.trn"), "--output_dir",
                      os.path.join(root, "score"), "--per_bucket"])
    check(rep["mer"]["utts"] == n_utts, "bin.score scored every utterance")
    print(f"phase 28 conformer CLIs on the card: bin.decode (train_asr_conformer.yaml, "
          f"decode_asr.yaml, LM 4 x 512, {n_utts} utterances, 8 steps) {decode_s:.1f} s, "
          f"launches {counts}, rtf {res['rtf']['rtf']:.3f}; bin.score MER "
          f"{rep['mer']['err']}%; hyps {sorted(res['hyps'].items())[:2]}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"decode": counts, "train": train_counts}


# Phase 29: the conformer recipe's training step (train_asr_conformer.yaml,
# 16 x 15 s in one micro-batch): exact launches per micro-batch. 12 blocks
# each run K5 forward and backward; the CTC head runs K4 once each way.
CONF_TRAIN_LAUNCHES = {"K5": 12, "K5 bwd": 12, "K4": 1, "K4 dx": 1, "K4 dw": 1}
# Phase 31: one micro-step on one 15 s utterance, card bf16 against the port
# on the CPU in float32 (dropout and SpecAug off): relative errors of the
# loss, loss_ctc and the global gradient norm, and the gradient cosines of
# the encoder, the decoder and the CTC head. The card must also be within
# 2x a bf16 control on the card with K5's and K4's plain versions under
# torch autograd, or within a tenth of the fixed bound where both sit at
# bf16 noise; a fixed bound the control itself misses becomes 2x the
# control's reading (PERF.md, Findings).
CONF_TRAIN_REL = {"loss": 5e-3, "loss_ctc": 5e-3, "grad_norm": 2e-2}
CONF_TRAIN_COS = {"cos_enc": 0.995, "cos_dec": 0.995, "cos_ctc": 0.995}


def conformer_counts() -> dict:
    from agacs_tpu_torch.ops import relpos_flash, vocab_lse

    return {"K5": relpos_flash.LAUNCHES, "K5 bwd": relpos_flash.BWD_LAUNCHES,
            "K4": vocab_lse.FWD_LAUNCHES, "K4 dx": vocab_lse.DX_LAUNCHES,
            "K4 dw": vocab_lse.DW_LAUNCHES}


def reset_conformer_counts() -> None:
    from agacs_tpu_torch.ops import relpos_flash, vocab_lse

    relpos_flash.LAUNCHES = relpos_flash.BWD_LAUNCHES = 0
    vocab_lse.FWD_LAUNCHES = vocab_lse.DX_LAUNCHES = vocab_lse.DW_LAUNCHES = 0


def conformer_raw(**widths) -> dict:
    """train_asr_conformer.yaml as a dict, its encoder_conf / decoder_conf
    entries overridden by `widths` (enc_* and dec_* keys, e.g. enc_output_size)."""
    from agacs_tpu_torch.utils.config import load_yaml

    raw = load_yaml(os.path.join(ROOT, "recipes", "seame", "conf", "train_asr_conformer.yaml"))
    for key, value in widths.items():
        part, name = key.split("_", 1)
        raw[{"enc": "encoder_conf", "dec": "decoder_conf"}[part]][name] = value
    return raw


def conformer_train_model(dev, dtype, sd=None, aug: bool = True, raw=None, seed: int = 6):
    """The conformer recipe's trainable model (train_asr_conformer.yaml,
    full width, or the config `raw`; identity MVN statistics) in float32
    masters under `dtype`, random weights drawn on `dev` from a generator
    of it seeded `seed` unless `sd` is given (the host takes ~30 s a
    billion values; phase 49 makes whisper-large's on the card too); `aug`
    False turns SpecAug and dropout off. Returns (model, cfg, sd on the
    CPU, raw config)."""
    import dataclasses

    from agacs_tpu_torch.models import conformer_asr
    from agacs_tpu_torch.models.conformer import init_params_
    from agacs_tpu_torch.utils.config import task_from_dict

    raw = raw or conformer_raw()
    cfg = dataclasses.replace(task_from_dict(raw, compute_dtype=dtype).cfg, mvn_stats_path=None)
    if not aug:
        cfg = dataclasses.replace(cfg, use_specaug=False, encoder=dataclasses.replace(
            cfg.encoder, dropout_rate=0.0))
    if sd is None:
        f32 = {part: dataclasses.replace(getattr(cfg, part), compute_dtype=torch.float32)
               for part in ("encoder", "decoder")}
        init = conformer_asr.ConformerASR(dataclasses.replace(cfg, **f32), device=dev)
        init_params_(init, torch.Generator(device=dev).manual_seed(seed))
        sd = {k: v.detach() for k, v in init.state_dict().items()}
        del init
    model = conformer_asr.ConformerASR.from_state_dict(cfg, sd, device=dev,
                                                       param_dtype=torch.float32)
    sd = {k: v.cpu() for k, v in sd.items()}  # off the card for the step's memory
    return model, cfg, sd, raw


def ctc_lattice_ms(batch, t_enc: int, dev) -> float:
    """The CTC lattice (`ctc_loss_from_planes`, forward and backward) alone
    on a micro-batch's plane shapes (B, t_enc) and (B, t_enc, U) in float32,
    synchronised: median ms of 3."""
    from agacs_tpu_torch.train.losses import ctc_loss_from_planes

    text = batch["text"]
    b, u = text.shape
    lens = (text != -1).sum(-1)
    times = []
    for i in range(4):
        lpb = torch.randn(b, t_enc, device=dev).requires_grad_()
        lpl = torch.randn(b, t_enc, u, device=dev).requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctc_loss_from_planes(lpb - 5, lpl - 5, torch.full((b,), t_enc, device=dev),
                             torch.where(text == -1, 0, text), lens).backward()
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def conformer_train_phase(dev) -> dict:
    """Phases 29 and 30: the recipe's stage 3 step at full width
    (train_asr_conformer.yaml: conformer 12 x 256, decoder 6, vocabulary
    51865, ctc_weight 0.3, lsm 0.1, Adam lr 1e-3 WarmupLR 25000, clip 5,
    SpecAug on, dropout 0.1; accum_grad 1: one 16 x 15 s micro-batch a
    step), random weights: one warm-up step, then TRAIN_STEPS timed steps
    with exact launch counts (CONF_TRAIN_LAUNCHES per step), ms per step,
    audio-s/s, peak memory, the CTC lattice's share; then one more step
    under torch.profiler."""
    from agacs_tpu_torch.models import conformer_asr
    from agacs_tpu_torch.train.optim import build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step
    from agacs_tpu_torch.utils.config import optim_config_from_dict

    t0 = time.perf_counter()
    model, cfg, sd, raw = conformer_train_model(dev, torch.bfloat16)
    ocfg = optim_config_from_dict(raw)
    check(ocfg.optim == "adam" and ocfg.warmup_steps == 25000 and ocfg.grad_clip == 5,
          f"the recipe's optimizer {ocfg}")
    opt, sched = build_optimizer(model.parameters(), ocfg)
    step = make_train_step(model, cfg, opt, sched, grad_clip=ocfg.grad_clip,
                           generator=torch.Generator().manual_seed(1),
                           loss_fn=conformer_asr.forward)
    batch = make_train_batch(TRAIN_B, TRAIN_S, dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.endswith(("ctc.weight", "blocks.11.attn.qkv.weight"))}
    step([batch])  # warm-up: cuBLAS handles, the kernels' first launches
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reset_conformer_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        stats = step([batch])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(stats["loss"]), float(stats["loss_ctc"]), float(stats["loss_att"])))
    launches = conformer_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * TRAIN_STEPS for k, v in CONF_TRAIN_LAUNCHES.items()}
    check(launches == want, f"conformer train launches {launches} == {want}")
    check(all(np.isfinite(v) for row in losses for v in row)
          and int(stats["grad_nonfinite_total"]) == 0, f"finite conformer losses {losses}")
    params = dict(model.named_parameters())
    check(all(not torch.equal(params[n], p) for n, p in before.items()),
          "the CTC head and block 11's q/k/v changed")
    ms = statistics.median(times) * 1e3
    t_enc = ((TRAIN_S * 16000 // 128 + 1 - 1) // 2 - 1) // 2
    lattice = ctc_lattice_ms(batch, t_enc, dev)
    audio_s = TRAIN_B * TRAIN_S
    print(f"phase 29 conformer train: train_asr_conformer.yaml (12 x 256, decoder 6, vocabulary "
          f"51865, ctc 0.3, Adam, WarmupLR 25000, clip 5, SpecAug, dropout 0.1), bf16 / f32 "
          f"masters, {TRAIN_B} x {TRAIN_S} s (T {t_enc}) a step: {ms:.1f} ms/step (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {audio_s / (ms / 1e3):.1f} audio-s/s; peak "
          f"{peak_gb:.2f} GB; {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
          f"parameters; losses (loss, ctc, att) "
          f"{[tuple(round(v, 3) for v in row) for row in losses]}; launches {launches} "
          f"({CONF_TRAIN_LAUNCHES} per step); the CTC lattice alone (forward + backward, "
          f"synchronised) {lattice:.1f} ms = {lattice / ms:.1%} of the step; built + warm-up "
          f"{load_s:.1f} s", flush=True)

    busy, n_events, per_name = device_profile(lambda: step([batch]))

    def share(*keys):
        t = sum(v for name, v in per_name.items() if any(k in name for k in keys))
        return f"{t:.2f} ms ({t / busy:.1%})"

    print(f"phase 30 conformer train profile: device busy {busy:.1f} ms in {n_events} device "
          f"events; idle {1 - busy / ms:.1%} of phase 29's {ms:.1f} ms/step; K5 fwd "
          f"{share('relpos_flash_fwd')}, K5 bwd "
          f"{share('relpos_dkdv', 'relpos_dq', 'relpos_rowdot')}, K4 fwd "
          f"{share('vocab_lse_fwd')}, K4 dx {share('vocab_lse_dx')}, "
          f"K4 dw {share('vocab_lse_dw')}; top: " + top_kernels(per_name), flush=True)
    del model, opt, step, before, params
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "sd": sd, "batch": batch, "lattice_ms": lattice,
            "busy": busy}


def conformer_micro_step(sd, dev, dtype, one, raw=None) -> tuple[dict, dict]:
    """One micro-step of the conformer recipe's model (or the config `raw`)
    on `dev` (SpecAug and dropout off): ({loss, loss_ctc, loss_att}, every
    gradient in float32 on the CPU by name)."""
    from agacs_tpu_torch.models import conformer_asr

    model, cfg, _, _ = conformer_train_model(dev, dtype, sd, aug=False, raw=raw)
    loss, stats = conformer_asr.forward(model, cfg, {k: v.to(dev) for k, v in one.items()},
                                        generator=torch.Generator().manual_seed(0))
    loss.backward()
    return ({k: float(stats[k].detach()) for k in ("loss", "loss_ctc", "loss_att")},
            {n: p.grad.float().cpu() for n, p in model.named_parameters()})


def conformer_parity(run, ref) -> dict:
    (vals, grads), (vals_r, grads_r) = run, ref

    def flat(g, prefix=""):
        return torch.cat([x.double().ravel() for n, x in sorted(g.items())
                          if n.startswith(prefix)])

    def cos(prefix):
        return float(torch.nn.functional.cosine_similarity(
            flat(grads, prefix), flat(grads_r, prefix), dim=0))

    out = {k: abs(vals[k] / vals_r[k] - 1) for k in ("loss", "loss_ctc", "loss_att")}
    out["grad_norm"] = abs(flat(grads).norm().item() / flat(grads_r).norm().item() - 1)
    out.update(cos_enc=cos("encoder."), cos_dec=cos("decoder."), cos_ctc=cos("ctc."))
    return out


@contextlib.contextmanager
def plain_k5_k4():
    """K5's and K4's plain versions under torch autograd on the card (bf16
    products, float32 softmax and logits): the bf16 control of phase 31."""
    from agacs_tpu_torch.ops import relpos_flash, vocab_lse

    k5, k4 = relpos_flash.relpos_mha, vocab_lse.streaming_lse
    relpos_flash.relpos_mha, vocab_lse.streaming_lse = (relpos_flash.relpos_mha_plain,
                                                        vocab_lse.lse_plain)
    try:
        yield
    finally:
        relpos_flash.relpos_mha, vocab_lse.streaming_lse = k5, k4


def hold_parity(card: dict, control: dict, fixed_bounds: dict, what: str) -> dict:
    """Phase 31's rule for each key of `fixed_bounds` (a relative error, or
    a cosine whose bound is on 1 - cos): the card within the fixed bound, or
    2x the control where the control itself misses it, and within 2x the
    control or a tenth of the fixed bound. Returns the limit applied by key."""
    bounds = {}
    for key, bound in fixed_bounds.items():
        is_cos = key.startswith("cos")
        c_err, k_err = (1 - control[key], 1 - card[key]) if is_cos else (control[key], card[key])
        fixed = 1 - bound if is_cos else bound
        limit = fixed if c_err <= fixed else 2 * c_err
        bounds[key] = limit
        check(k_err <= limit, f"{what} {key}: card {k_err} <= {limit}")
        check(k_err <= max(2 * c_err, fixed / 10),
              f"{what} {key}: card {k_err} <= 2 x control {c_err} (or {fixed / 10})")
    return bounds


def conformer_train_parity(sd, dev, batch, raw=None, phase: str = "31",
                           launches: dict | None = None) -> dict:
    """Phase 31: one micro-step on one 15 s utterance, card bf16 (K5, K4)
    and the bf16 control (their plain versions) against the port on the CPU
    in float32, same weights (the recipe's model, or the config `raw` with
    its micro-step's `launches`; phase 50c)."""
    launches = launches or CONF_TRAIN_LAUNCHES
    one = {k: v[:1] for k, v in batch.items()}
    t0 = time.perf_counter()
    ref = conformer_micro_step(sd, torch.device("cpu"), torch.float32, one, raw)
    cpu_s = time.perf_counter() - t0
    reset_conformer_counts()
    run = conformer_micro_step(sd, dev, torch.bfloat16, one, raw)
    check(conformer_counts() == launches,
          f"the card micro-step's launches {conformer_counts()} == {launches}")
    with plain_k5_k4():
        control = conformer_parity(conformer_micro_step(sd, dev, torch.bfloat16, one, raw), ref)
    check(conformer_counts() == launches, "the bf16 control launched no K5 or K4")
    card = conformer_parity(run, ref)
    check(all(np.isfinite(v) for v in run[0].values())
          and all(bool(torch.isfinite(g).all()) for g in run[1].values()),
          "finite card loss and gradients")
    bounds = hold_parity(card, control, {**CONF_TRAIN_REL, **CONF_TRAIN_COS},
                         "conformer train parity")
    fmt = lambda r: ", ".join(f"{k} {v:.2e}" if not k.startswith("cos") else f"{k} {v:.6f}"
                              for k, v in r.items())
    print(f"phase {phase} conformer train parity vs cpu f32 (1 x {TRAIN_S} s; rel errors, "
          f"cosines): card bf16 {fmt(card)}; bf16 control (plain K5 and K4) {fmt(control)}; "
          f"bounds (1 - cos for cosines) {bounds}; cpu step {cpu_s:.1f} s", flush=True)
    return {"card": card, "control": control}


# Phases 36-38: the TMECS full fine-tune recipe (train_asr_whisper_small.yaml,
# no freeze preset) with ctc_weight overridden to 0.3, the ESPnet hybrid
# weight of the conformer recipe: whisper-small at full depth with its CTC
# head, so K4 runs at (12000, 768) x (768, 51865) once each way a micro-batch
# of 16 x 15 s. Phase 38 holds loss_ctc and the CTC head's gradients to
# phase 31's bounds (CONF_TRAIN_REL, CONF_TRAIN_COS) against the CPU in
# float32.
WHISPER_CTC_WEIGHT = 0.3
WHISPER_CTC_LAUNCHES = {"K4": 1, "K4 dx": 1, "K4 dw": 1}
WHISPER_CTC_STEPS = 3


def k4_counts() -> dict:
    from agacs_tpu_torch.ops import vocab_lse

    return {"K4": vocab_lse.FWD_LAUNCHES, "K4 dx": vocab_lse.DX_LAUNCHES,
            "K4 dw": vocab_lse.DW_LAUNCHES}


def whisper_ctc_model(dev, dtype, sd=None, specaug: bool = True, size: str = "small",
                      layers: int | None = None):
    """The recipe's model as `bin.train` builds it (its config with
    ctc_weight WHISPER_CTC_WEIGHT and `whisper_model: size` in both parts,
    float32 masters, the recipe's freeze preset: none, so every parameter
    trains) from `sd`, or from random weights with the CTC head (torch seed
    7; made on `dev` for a size other than the recipe's small); `layers`
    cuts both stacks to that many blocks. Returns (model, trainable
    parameters, config, sd, raw config, task)."""
    import dataclasses

    from agacs_tpu_torch.models.whisper import Whisper
    from agacs_tpu_torch.train.freeze import apply_freeze
    from agacs_tpu_torch.utils.config import load_yaml, task_from_dict

    raw = load_yaml(os.path.join(ROOT, "recipes", "tmecs", "conf",
                                 "train_asr_whisper_small.yaml"))
    raw = {**raw, "model_conf": {**raw["model_conf"], "ctc_weight": WHISPER_CTC_WEIGHT},
           **{part: {**raw[part], "whisper_model": size}
              for part in ("encoder_conf", "decoder_conf")}}
    task = task_from_dict(raw, compute_dtype=dtype)
    cfg = task.cfg if specaug else dataclasses.replace(task.cfg, use_specaug=False)
    if layers:
        cfg = dataclasses.replace(cfg, whisper=dataclasses.replace(
            cfg.whisper, n_audio_layer=layers, n_text_layer=layers))
    if sd is None:
        gen = torch.Generator(device="cpu" if size == "small" else dev)
        sd = task.init_fn(gen.manual_seed(7), cfg)
    model = Whisper.from_state_dict(cfg.whisper, sd, device=dev, param_dtype=torch.float32)
    params = apply_freeze(model, raw.get("freeze_param"))
    model.cast_frozen_(dtype)
    return model, params, cfg, sd, raw, task


def whisper_ctc_phase(dev, size: str = "small", b: int = TRAIN_B,
                      steps: int = WHISPER_CTC_STEPS, phase: tuple = (36, 37)) -> dict:
    """Phases 36 and 37: the recipe's training step with the CTC head, 16 x
    15 s a step: one warm-up, then WHISPER_CTC_STEPS timed steps with
    exact K4 and K1 launches, then one more under torch.profiler; `size`,
    `b` (rows a step), `steps` and `phase` (the lines' labels) for phase
    49's whisper-large."""
    from agacs_tpu_torch.ops import flash_train, vocab_lse
    from agacs_tpu_torch.train.optim import build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step
    from agacs_tpu_torch.utils.config import optim_config_from_dict

    t0 = time.perf_counter()
    model, params, cfg, sd, raw, task = whisper_ctc_model(dev, torch.bfloat16, size=size)
    ocfg = optim_config_from_dict(raw)
    n_params = sum(p.numel() for p in model.parameters())
    check(ocfg.optim == "adamw" and ocfg.grad_clip == 1.0 and cfg.ctc_weight == WHISPER_CTC_WEIGHT
          and sum(p.numel() for p in params) == n_params and model.ctc.weight.shape == (
              cfg.whisper.n_vocab, cfg.whisper.n_audio_state),
          f"the recipe's full fine-tune with a CTC head: {ocfg}")
    opt, sched = build_optimizer(params, ocfg)
    step = make_train_step(model, cfg, opt, sched, grad_clip=ocfg.grad_clip,
                           generator=torch.Generator().manual_seed(1), loss_fn=task.loss_fn)
    batch = make_train_batch(b, TRAIN_S, dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in ("ctc.weight", "ctc.bias")}
    step([batch])  # warm-up: cuBLAS handles, the kernels' first launches
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    vocab_lse.FWD_LAUNCHES = vocab_lse.DX_LAUNCHES = vocab_lse.DW_LAUNCHES = 0
    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        stats = step([batch])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(stats["loss"]), float(stats["loss_ctc"]), float(stats["loss_att"])))
    # every encoder layer trains (the conv stem too), so each takes K1b
    launches = {**k4_counts(), "K1f": flash_train.LAUNCHES, "K1b": flash_train.BWD_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {**WHISPER_CTC_LAUNCHES, "K1f": cfg.whisper.n_audio_layer,
                "K1b": cfg.whisper.n_audio_layer}
    want = {k: v * steps for k, v in per_step.items()}
    check(launches == want, f"whisper CTC train launches {launches} == {want}")
    check(all(np.isfinite(v) for row in losses for v in row)
          and int(stats["grad_nonfinite_total"]) == 0, f"finite whisper CTC losses {losses}")
    state = dict(model.named_parameters())
    check(all(not torch.equal(state[n], p) for n, p in before.items()), "the CTC head changed")
    ms = statistics.median(times) * 1e3
    audio_s = b * TRAIN_S
    w = cfg.whisper
    print(f"phase {phase[0]} whisper CTC train: train_asr_whisper_small.yaml (TMECS full "
          f"fine-tune, no freeze preset; whisper-{size} {w.n_audio_layer} + {w.n_text_layer} "
          f"layers, d {w.n_audio_state}) with ctc_weight {WHISPER_CTC_WEIGHT} (CTC head "
          f"{w.n_audio_state} -> {w.n_vocab}), AdamW, WarmupLR 500, "
          f"clip 1, SpecAug, bf16 / f32 masters, {b} x {TRAIN_S} s a step: {ms:.1f} "
          f"ms/step (median of {[round(t * 1e3, 1) for t in times]}), "
          f"{audio_s / (ms / 1e3):.1f} audio-s/s; peak {peak_gb:.2f} GB; "
          f"{n_params / 1e6:.2f}M parameters, all trained; losses (loss, ctc, att) "
          f"{[tuple(round(v, 3) for v in row) for row in losses]}; launches {launches} "
          f"({per_step} per step); built + warm-up {load_s:.1f} s", flush=True)

    busy, n_events, per_name = device_profile(lambda: step([batch]))

    def dev_ms(*keys):
        return sum(v for name, v in per_name.items() if any(k in name for k in keys))

    k4_ms = {"fwd": dev_ms("vocab_lse_fwd"), "dx": dev_ms("vocab_lse_split_kernel<false"),
             "dx_any": dev_ms("vocab_lse_dx", "vocab_lse_split_kernel<false"),
             "dw": dev_ms("vocab_lse_split_kernel<true")}
    check(k4_ms["dx"] > 0 and k4_ms["dw"] > 0 and k4_ms["dx"] == k4_ms["dx_any"],
          f"the profiled step's K4 backward ran the split kernels: {k4_ms}")
    print(f"phase {phase[1]} whisper CTC train profile: device busy {busy:.1f} ms in "
          f"{n_events} device events; idle {1 - busy / ms:.1%} of {ms:.1f} ms/step; K4 fwd "
          f"{k4_ms['fwd']:.4f} ms, dx {k4_ms['dx']:.4f} ms, dw {k4_ms['dw']:.4f} ms "
          f"({(k4_ms['fwd'] + k4_ms['dx'] + k4_ms['dw']) / busy:.1%} of busy); top: "
          + top_kernels(per_name), flush=True)
    del model, opt, step, before, state, params
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "busy": busy, "k4_ms": k4_ms, "sd": sd,
            "batch": batch, "peak_gb": peak_gb, "per_name": per_name}


def whisper_ctc_micro_step(sd, dev, dtype, one, size: str = "small",
                           layers: int | None = None) -> tuple[dict, dict]:
    """One micro-step of phase 36's model on `dev` (SpecAug off; the recipe
    has no dropout): ({loss, loss_ctc, loss_att}, every gradient in float32
    on the CPU by name)."""
    model, _, cfg, _, _, task = whisper_ctc_model(dev, dtype, sd, specaug=False, size=size,
                                                  layers=layers)
    loss, stats = task.loss_fn(model, cfg, {k: v.to(dev) for k, v in one.items()},
                               generator=torch.Generator().manual_seed(0))
    loss.backward()
    return ({k: float(stats[k].detach()) for k in ("loss", "loss_ctc", "loss_att")},
            {n: p.grad.float().cpu() for n, p in model.named_parameters()})


def whisper_ctc_parity(sd, dev, batch, size: str = "small", layers: int | None = None,
                       phase: int = 38) -> dict:
    """Phase 38: one micro-step on one 15 s utterance, card bf16 (K4) and a
    bf16 control (K4's plain version) against the port on the CPU in
    float32, same weights: loss_ctc and the CTC head's gradient cosine within
    phase 31's bounds, the card within 2x the control (or a tenth of the
    bound); `size` and `layers` as for `whisper_ctc_model` (phase 49)."""
    one = {k: v[:1] for k, v in batch.items()}
    arch = {"size": size, "layers": layers}
    t0 = time.perf_counter()
    ref = whisper_ctc_micro_step(sd, torch.device("cpu"), torch.float32, one, **arch)
    cpu_s = time.perf_counter() - t0
    from agacs_tpu_torch.ops import vocab_lse

    vocab_lse.FWD_LAUNCHES = vocab_lse.DX_LAUNCHES = vocab_lse.DW_LAUNCHES = 0
    run = whisper_ctc_micro_step(sd, dev, torch.bfloat16, one, **arch)
    check(k4_counts() == WHISPER_CTC_LAUNCHES, f"the card micro-step's launches {k4_counts()}")
    with plain_k5_k4():
        control = conformer_parity(whisper_ctc_micro_step(sd, dev, torch.bfloat16, one, **arch),
                                   ref)
    check(k4_counts() == WHISPER_CTC_LAUNCHES, "the bf16 control launched no K4")
    card = conformer_parity(run, ref)
    check(all(np.isfinite(v) for v in run[0].values())
          and all(bool(torch.isfinite(g).all()) for n, g in run[1].items()
                  if n.startswith("ctc.")), "finite card loss and CTC head gradients")
    bounds = hold_parity(card, control, {"loss_ctc": CONF_TRAIN_REL["loss_ctc"],
                                         "cos_ctc": CONF_TRAIN_COS["cos_ctc"]},
                         "whisper CTC parity")
    fmt = lambda r: ", ".join(f"{k} {r[k]:.2e}" if not k.startswith("cos") else f"{k} {r[k]:.6f}"
                              for k in ("loss", "loss_ctc", "loss_att", "grad_norm", "cos_enc",
                                        "cos_dec", "cos_ctc"))
    print(f"phase {phase} whisper CTC parity vs cpu f32 (whisper-{size}"
          + (f", {layers} + {layers} layers" if layers else "") + f", 1 x {TRAIN_S} s; rel "
          f"errors, cosines): "
          f"card bf16 {fmt(card)}; bf16 control (plain K4) {fmt(control)}; bounds on loss_ctc "
          f"and cos_ctc (1 - cos) {bounds}; cpu step {cpu_s:.1f} s", flush=True)
    return {"card": card, "control": control}


# Phases 41-45: the transducer family at the recipe's full width
# (train_asr_transducer.yaml: conformer 12 x 256, LSTM 1 x 320, joint 320,
# vocabulary 51865, ctc_weight 0.3), random weights from torch seed 0, noise
# audio. K4 runs twice each way a step: the joint's V reduction at K 320
# (padded to 384 in the wrapper: the chunked forward and the split dx / dw
# on clusters of 3) and the aux CTC head at K 256.
TRANS_B, TRANS_S, TRANS_U, TRANS_T = 16, 15, 40, 468  # the step; T: encoder frames of 15 s
TRANS_STEPS = 3
TRANS_LAUNCHES = {"K5": 12, "K5 bwd": 12, "K4": 2, "K4 dx": 2, "K4 dw": 2}
# the profiled step's device events by kernel name: the joint's dx and dw
# on the split kernel (K 384), the CTC head's on the K <= 256 kernels
TRANS_EVENTS = {"relpos_flash_fwd": 12, "relpos_dkdv": 12, "vocab_lse_fwd": 2,
                "vocab_lse_split_kernel<false": 1, "vocab_lse_split_kernel<true": 1,
                "vocab_lse_dx_kernel": 1, "vocab_lse_dw_kernel": 1}
K4_JOINT = (4096, 320, 51865)  # held against the plain version
K4_JOINT_SLICE = 32768  # rows timed beside the plain version and cuBLAS + logsumexp
LATTICE_GB = TRANS_B * TRANS_T * (TRANS_U + 1) * 51865 * 4 / 1e9  # the dense f32 lattice
# Phase 43: one micro-step (1 x 6 s, 20 labels; SpecAug and dropout off),
# card bf16 against the port on the CPU in float32, with phase 31's rule
# (`hold_parity`) and a bf16 control on K5's and K4's plain versions.
TRANS_PARITY_S, TRANS_PARITY_U = 6, 20
TRANS_REL = {"loss": 5e-3, "loss_transducer": 5e-3, "loss_ctc": 5e-3}
TRANS_COS = {"cos_enc": 0.995, "cos_lstm": 0.995, "cos_joint": 0.995}
# Phase 44: 8 x 15 s; the per-utterance beams (default, NSC, mAES) on the
# first TRANS_HOST_FRAMES frames of one utterance: their hypotheses are
# ragged on the host, one joint and a host read an expansion.
TRANS_DEC_B, TRANS_BEAM, TRANS_HOST_FRAMES, TRANS_CPU_ROWS = 8, 4, 60, 2


def check_k4_joint(dev, g) -> dict:
    """Phase 41: K4 at the transducer joint's K 320, which the wrapper pads
    to 384 (zero columns of x, zero rows of W): forward, dx and dw at
    K4_JOINT (b and g NaN past their ends) against their plain versions
    with phase 2v's bounds, bit-identical on a second run; then timed on a
    K4_JOINT_SLICE-row slice beside the plain version and cuBLAS +
    logsumexp over the logits (`k4_times`), and alone at the full step's
    N = 16 x 468 x 41 (the logits of which would take 63.7 GB). Bounds come
    from the real K 320. Returns {"fwd", "dx", "dw"}: the slice's results
    with the errors, and "full": each pass at the step's N."""
    from agacs_tpu_torch.ops import vocab_lse

    n, k, v = K4_JOINT
    res = {part: {"err": 0.0} for part in ("fwd", "dx", "dw")}
    x, w, b, gr = k4_inputs(g, dev, n, k, v)
    b, gr = poisoned(b), poisoned(gr)
    lse = poisoned(vocab_lse._launch_fwd(x, w, b))
    dx = vocab_lse._launch_dx(x, w, b, lse, gr)
    dw, db = vocab_lse._launch_dw(x, w, b, lse, gr)
    lse2 = vocab_lse._launch_fwd(x, w, b)
    dx2 = vocab_lse._launch_dx(x, w, b, lse, gr)
    dw2, db2 = vocab_lse._launch_dw(x, w, b, lse, gr)
    lse_p = vocab_lse.lse_plain(x, w, b)
    dx_p, dw_p, db_p = vocab_lse.lse_bwd_plain(x, w, b, lse_p, gr)
    torch.cuda.synchronize()
    errs = k4_errors((("fwd", "lse", lse, lse_p, None), ("dx", "dx", dx, dx_p, KERNEL_RTOL),
                      ("dw", "dW", dw, dw_p, KERNEL_RTOL), ("dw", "db", db, db_p, K4_DB_RTOL)),
                     n, k, v, res)
    check(torch.equal(lse, lse2) and torch.equal(dx, dx2) and torch.equal(dw, dw2)
          and torch.equal(db, db2), f"K4 at the joint's {K4_JOINT}: a second run bit-identical")
    kp = vocab_lse.padded_k(k)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tf = vocab_lse.fwd_tiling(n, kp, v, sms)
    line = (f"phase 41 K4 at the transducer joint ({n}, {k}) x ({k}, {v}), K padded to {kp} "
            f"({(kp - k) / k:.0%} more work than K {k}): max_abs_err "
            + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
            + f" (phase 2v's bounds), all finite, b and g NaN past their ends, bit-identical "
            f"on a second run; forward {tf['route']} (BM {tf['BM']}, C {tf['C']}); "
            + k4_backward_tiling(n, kp, v, sms))
    del x, dx, dw, db, lse2, dx2, dw2, db2, lse_p, dx_p, dw_p, db_p
    torch.cuda.empty_cache()
    times, line = k4_times(g, dev, (K4_JOINT_SLICE, k, v),
                           torch.randn(K4_JOINT_SLICE, generator=g).to(dev), 1,
                           {"fwd": 10, "dx": 5, "dw": 5}, line + f"; at N {K4_JOINT_SLICE}")
    for part in res:
        res[part].update(times[part])
    torch.cuda.empty_cache()
    nf = TRANS_B * TRANS_T * (TRANS_U + 1)
    xf = torch.randn(nf, k, device=dev).to(torch.bfloat16)
    gf = torch.randn(nf, device=dev)
    wp, xp = vocab_lse._rows8(w), vocab_lse._pad_x(xf)
    lsef = vocab_lse._launch_fwd(xf, w, b, wp, xp)
    pad_ms = cuda_ms(lambda: vocab_lse._pad_x(xf), [()], 3)
    io = nf * k * 2 + k * v * 2 + v * 4
    ops = 2 * nf * k * v
    full = {}
    for part, fn, nbytes, nops in (
            ("fwd", lambda: vocab_lse._launch_fwd(xf, w, b, wp, xp), io + nf * 4, ops),
            ("dx", lambda: vocab_lse._launch_dx(xf, w, b, lsef, gf, wp, xp),
             io + 8 * nf + nf * k * 2, 2 * ops),
            ("dw", lambda: vocab_lse._launch_dw(xf, w, b, lsef, gf, wp, xp),
             io + 8 * nf + k * v * 2 + v * 4, 2 * ops)):
        full[part] = {"ms": cuda_ms(fn, [()], 3), **roofline(nbytes, nops, "bf16")}
    res["full"] = full
    print(line + f"; at the step's N {nf}: " + "; ".join(
        f"{p} {r['ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['ms'] / r['bound_ms']:.1f}x)"
        for p, r in full.items()) + f"; x's padded copy {pad_ms:.4f} ms (once a step)",
        flush=True)
    del xf, gf, wp, xp, lsef, w, b
    torch.cuda.empty_cache()
    return res


def trans_counts() -> dict:
    from agacs_tpu_torch.ops import relpos_flash

    return {"K5": relpos_flash.LAUNCHES, "K5 bwd": relpos_flash.BWD_LAUNCHES, **k4_counts()}


def trans_batch(b: int, seconds: int, u: int, dev, seed: int = 0) -> dict:
    """Noise speech at 0.05 and `u` random Whisper ids a row."""
    rng = np.random.RandomState(seed)
    s = seconds * 16000
    return {"speech": torch.from_numpy((rng.randn(b, s) * 0.05).astype(np.float32)).to(dev),
            "speech_lengths": torch.full((b,), s, device=dev),
            "text": torch.from_numpy(rng.randint(100, 50000, (b, u))).to(dev)}


def trans_model(dev, dtype, sd=None, aug: bool = True, param_dtype=torch.float32):
    """The recipe's transducer (identity MVN statistics) on `dev`, compute
    `dtype`, random weights from torch seed 0 unless `sd` is given; `aug`
    False turns SpecAug and dropout off. Returns (model, cfg, sd, raw)."""
    import dataclasses

    from agacs_tpu_torch.models import transducer_asr
    from agacs_tpu_torch.utils.config import load_yaml, task_from_dict

    raw = load_yaml(os.path.join(ROOT, "recipes", "seame", "conf",
                                 "train_asr_transducer.yaml"))
    cfg = task_from_dict(raw, compute_dtype=dtype).cfg
    check(cfg.decoder.joint_space_size == 320 and cfg.decoder.hidden_size == 320
          and cfg.decoder.vocab_size == 51865 and cfg.ctc_weight == 0.3
          and cfg.encoder.num_blocks == 12 and cfg.encoder.output_size == 256,
          f"the recipe's transducer: {cfg.decoder}, ctc {cfg.ctc_weight}")
    if not aug:
        cfg = dataclasses.replace(
            cfg, use_specaug=False,
            encoder=dataclasses.replace(cfg.encoder, dropout_rate=0.0),
            decoder=dataclasses.replace(cfg.decoder, dropout=0.0, dropout_embed=0.0))
    if sd is None:
        sd = transducer_asr.init_transducer_asr_params(torch.Generator().manual_seed(0), cfg)
    model = transducer_asr.TransducerASR.from_state_dict(cfg, sd, device=dev,
                                                         param_dtype=param_dtype)
    return model, cfg, sd, raw


def trans_train_phase(dev) -> dict:
    """Phase 42: the recipe's step at full width (Adam lr 1.5e-3, WarmupLR
    25000, clip 5, SpecAug, dropout 0.1), one 16 x 15 s micro-batch of 40
    labels a row a step: a warm-up, TRANS_STEPS timed steps with exact
    launches, peak memory well under the dense lattice's; then one step
    under the profiler with its device events by kernel checked
    (TRANS_EVENTS) and its busy time, idle share and K4's."""
    from agacs_tpu_torch.models import transducer_asr
    from agacs_tpu_torch.train.optim import build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step
    from agacs_tpu_torch.utils.config import optim_config_from_dict

    t0 = time.perf_counter()
    model, cfg, sd, raw = trans_model(dev, torch.bfloat16)
    ocfg = optim_config_from_dict(raw)
    check(ocfg.optim == "adam" and ocfg.grad_clip == 5, f"the recipe's optimizer {ocfg}")
    opt, sched = build_optimizer(model.parameters(), ocfg)
    step = make_train_step(model, cfg, opt, sched, grad_clip=ocfg.grad_clip,
                           generator=torch.Generator().manual_seed(1),
                           loss_fn=transducer_asr.forward)
    batch = trans_batch(TRANS_B, TRANS_S, TRANS_U, dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("transducer.joint.lin_out", "transducer.layers.0.w_hh"))}
    step([batch])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reset_conformer_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRANS_STEPS):
        t0 = time.perf_counter()
        stats = step([batch])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(tuple(float(stats[k]) for k in ("loss", "loss_transducer", "loss_ctc")))
    launches = trans_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * TRANS_STEPS for k, v in TRANS_LAUNCHES.items()}
    check(launches == want, f"transducer train launches {launches} == {want}")
    check(all(np.isfinite(v) for row in losses for v in row)
          and int(stats["grad_nonfinite_total"]) == 0, f"finite transducer losses {losses}")
    check(peak_gb < LATTICE_GB / 4, f"peak {peak_gb:.2f} GB, well under the dense lattice's "
          f"{LATTICE_GB:.1f} GB: no (B, T, U+1, V) tensor")
    params = dict(model.named_parameters())
    check(all(not torch.equal(params[n], p) for n, p in before.items()),
          "the joint's output layer and the LSTM changed")
    ms = statistics.median(times) * 1e3
    print(f"phase 42 transducer train: train_asr_transducer.yaml (conformer 12 x 256, LSTM 1 x "
          f"320, joint 320, vocabulary 51865, ctc 0.3, Adam, WarmupLR 25000, clip 5, SpecAug, "
          f"dropout 0.1), bf16 / f32 masters, {TRANS_B} x {TRANS_S} s, {TRANS_U} labels a row "
          f"(joint rows {TRANS_B * TRANS_T * (TRANS_U + 1)}) a step: {ms:.1f} ms/step (median "
          f"of {[round(t * 1e3, 1) for t in times]}), "
          f"{TRANS_B * TRANS_S / (ms / 1e3):.1f} audio-s/s; peak {peak_gb:.2f} GB (the dense "
          f"f32 lattice alone: {LATTICE_GB:.1f} GB); "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters; losses (loss, "
          f"transducer, ctc) {[tuple(round(v, 3) for v in row) for row in losses]}; launches "
          f"{launches} ({TRANS_LAUNCHES} per step); built + warm-up {load_s:.1f} s", flush=True)

    busy, n_events, per_name = exact_profile(
        "phase 42's profiled step", lambda: step([batch]), lambda: dict(TRANS_EVENTS))

    def dev_ms(*keys):
        return sum(t for name, t in per_name.items() if any(k in name for k in keys))

    k4_ms = {"joint fwd": dev_ms("vocab_lse_fwd_kernel<64"),
             "joint dx": dev_ms("vocab_lse_split_kernel<false"),
             "joint dw": dev_ms("vocab_lse_split_kernel<true"),
             "ctc": dev_ms("vocab_lse_dx_kernel", "vocab_lse_dw_kernel"),
             "all": dev_ms("vocab_lse")}
    print(f"phase 42 transducer train profile: device busy {busy:.1f} ms in {n_events} device "
          f"events; idle {1 - busy / ms:.1%} of {ms:.1f} ms/step; device events by kernel "
          f"{TRANS_EVENTS} as launched; K4 {k4_ms['all']:.2f} ms ({k4_ms['all'] / busy:.1%} of "
          f"busy): " + ", ".join(f"{k} {t:.2f} ms" for k, t in k4_ms.items() if k != "all")
          + f"; K5 {dev_ms('relpos'):.2f} ms; top: " + top_kernels(per_name), flush=True)
    del model, opt, step, before, params
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "busy": busy, "peak_gb": peak_gb, "k4_ms": k4_ms,
            "sd": sd}


def trans_micro_step(sd, dev, dtype, one) -> tuple[dict, dict]:
    """One micro-step of the recipe's transducer on `dev` (SpecAug and
    dropout off): ({loss, loss_transducer, loss_ctc}, every gradient in
    float32 on the CPU by name)."""
    from agacs_tpu_torch.models import transducer_asr

    model, cfg, _, _ = trans_model(dev, dtype, sd, aug=False)
    loss, stats = transducer_asr.forward(model, cfg, {k: v.to(dev) for k, v in one.items()},
                                         generator=torch.Generator().manual_seed(0))
    loss.backward()
    return ({k: float(stats[k].detach()) for k in ("loss", "loss_transducer", "loss_ctc")},
            {n: p.grad.float().cpu() for n, p in model.named_parameters()})


def trans_parity(run, ref) -> dict:
    (vals, grads), (vals_r, grads_r) = run, ref

    def cos(*prefixes):
        a, b = (torch.cat([x.double().ravel() for n, x in sorted(g.items())
                           if n.startswith(prefixes)]) for g in (grads, grads_r))
        return float(torch.nn.functional.cosine_similarity(a, b, dim=0))

    out = {k: abs(vals[k] / vals_r[k] - 1) for k in vals}
    out.update(cos_enc=cos("encoder."), cos_lstm=cos("transducer.layers.", "transducer.embed"),
               cos_joint=cos("transducer.joint."))
    return out


def trans_train_parity(sd, dev) -> dict:
    """Phase 43: one micro-step, card bf16 (K5, K4 at K 320 and 256) and the
    bf16 control (their plain versions) against the port on the CPU in
    float32, same weights."""
    one = {k: v.cpu() for k, v in trans_batch(1, TRANS_PARITY_S, TRANS_PARITY_U, "cpu",
                                               seed=3).items()}
    t0 = time.perf_counter()
    ref = trans_micro_step(sd, torch.device("cpu"), torch.float32, one)
    cpu_s = time.perf_counter() - t0
    reset_conformer_counts()
    run = trans_micro_step(sd, dev, torch.bfloat16, one)
    check(trans_counts() == TRANS_LAUNCHES, f"the card micro-step's launches {trans_counts()}")
    with plain_k5_k4():
        control = trans_parity(trans_micro_step(sd, dev, torch.bfloat16, one), ref)
    check(trans_counts() == TRANS_LAUNCHES, "the bf16 control launched no K5 or K4")
    card = trans_parity(run, ref)
    check(all(np.isfinite(v) for v in run[0].values())
          and all(bool(torch.isfinite(g).all()) for g in run[1].values()),
          "finite card losses and gradients")
    bounds = hold_parity(card, control, {**TRANS_REL, **TRANS_COS}, "transducer train parity")
    fmt = lambda r: ", ".join(f"{k} {v:.2e}" if not k.startswith("cos") else f"{k} {v:.6f}"
                              for k, v in r.items())
    print(f"phase 43 transducer train parity vs cpu f32 (1 x {TRANS_PARITY_S} s, "
          f"{TRANS_PARITY_U} labels; rel errors, gradient cosines): card bf16 {fmt(card)}; bf16 "
          f"control (plain K5 and K4) {fmt(control)}; bounds (1 - cos for cosines) {bounds}; "
          f"cpu step {cpu_s:.1f} s", flush=True)
    return {"card": card, "control": control}


def token_agreement(a: list[list[int]], b: list[list[int]]) -> str:
    """Rows equal, and the tokens of the common prefixes over all tokens."""
    same = sum(x == y for x, y in zip(a, b))
    prefix = sum(next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
                 for x, y in zip(a, b))
    return (f"{same}/{len(a)} rows equal, common prefixes {prefix} of "
            f"{max(sum(map(len, a)), 1)} tokens")


def trans_decode_phase(sd, dev) -> dict:
    """Phase 44: decoding 8 x 15 s on the card (encoder bf16, transducer
    float32, as `bin.decode` builds it): the batched greedy (K5 12 an
    encode) and TSD / ALSD at beam 4 on the batch, default / NSC / mAES at
    beam 4 on one utterance's first TRANS_HOST_FRAMES frames; ms a batch (or
    an utterance), the greedy request's profile (busy, idle share) and
    agreement with the port on the CPU in float32 on TRANS_CPU_ROWS
    utterances (greedy) and on the capped utterance (default beam)."""
    from agacs_tpu_torch.decode import transducer_nsc, transducer_tsd
    from agacs_tpu_torch.models import transducer as ttr
    from agacs_tpu_torch.models import transducer_asr
    from agacs_tpu_torch.ops import relpos_flash

    model, cfg, _, _ = trans_model(dev, torch.bfloat16, sd, param_dtype=None)
    model.eval()
    batch = trans_batch(TRANS_DEC_B, TRANS_S, 1, dev, seed=5)
    tm = model.transducer
    out, secs = {}, {}

    def timed(name, fn, warm=None):
        if warm is not None:  # the batched searches' first call, on the first 2 utterances'
            warm()            # first frames; the host searches run warm after them
        torch.cuda.synchronize()
        relpos_flash.LAUNCHES = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            r = fn()
        torch.cuda.synchronize()
        secs[name] = (time.perf_counter() - t0) * 1e3
        return r

    def encode():
        return transducer_asr.encode(model, batch["speech"], batch["speech_lengths"])

    def greedy():
        enc, lens = encode()
        return ttr.greedy_search_scan(tm, enc, lens)

    with torch.inference_mode():
        enc, lens = encode()
    short = (enc[:2, :TRANS_HOST_FRAMES], lens[:2].clamp(max=TRANS_HOST_FRAMES))
    toks, n = timed("greedy", greedy, lambda: ttr.greedy_search_scan(tm, *short))
    check(relpos_flash.LAUNCHES == 12, f"greedy: K5 12 launches an encode ({relpos_flash.LAUNCHES})")
    out["greedy"] = [r[:k].tolist() for r, k in zip(toks.cpu(), n.cpu())]
    tsd = timed("tsd", lambda: transducer_tsd.tsd_beam_search(tm, enc, lens, beam=TRANS_BEAM),
                lambda: transducer_tsd.tsd_beam_search(tm, *short, beam=TRANS_BEAM))
    alsd = timed("alsd", lambda: transducer_tsd.alsd_beam_search(tm, enc, lens,
                                                                  beam=TRANS_BEAM),
                 lambda: transducer_tsd.alsd_beam_search(tm, *short, beam=TRANS_BEAM))
    for name, (t, k, s) in (("tsd", tsd), ("alsd", alsd)):
        check(bool(torch.isfinite(s[:, 0]).all()) and t.shape[:2] == (TRANS_DEC_B, TRANS_BEAM),
              f"{name}: a finite best hypothesis for every utterance")
        out[name] = [r[0, :kk[0]].tolist() for r, kk in zip(t.cpu(), k.cpu())]
    e0 = enc[0, :TRANS_HOST_FRAMES]
    for name, fn in (("default", ttr.default_beam_search),
                     ("nsc", transducer_nsc.nsc_beam_search),
                     ("maes", transducer_nsc.maes_beam_search)):
        nbest = timed(name, lambda fn=fn: fn(tm, e0, beam_size=TRANS_BEAM))
        check(len(nbest) >= 1 and all(np.isfinite(s) for s, _ in nbest),
              f"{name}: finite n-best {[s for s, _ in nbest]}")
        out[name] = nbest[0][1]
    ms_greedy = secs["greedy"]
    busy, n_events, per_name = device_profile(greedy)
    # the CPU in float32, same weights: greedy on TRANS_CPU_ROWS utterances,
    # the default beam on the capped utterance
    cpu, _, _, _ = trans_model("cpu", torch.float32, sd)
    cpu.eval()
    with torch.inference_mode():
        c_enc, c_lens = transducer_asr.encode(cpu, batch["speech"][:TRANS_CPU_ROWS].cpu(),
                                              batch["speech_lengths"][:TRANS_CPU_ROWS].cpu())
        c_toks, c_n = ttr.greedy_search_scan(cpu.transducer, c_enc, c_lens)
        c_def = ttr.default_beam_search(cpu.transducer, c_enc[0, :TRANS_HOST_FRAMES],
                                        beam_size=TRANS_BEAM)
    c_greedy = [r[:k].tolist() for r, k in zip(c_toks, c_n)]
    print(f"phase 44 transducer decoding, {TRANS_DEC_B} x {TRANS_S} s (T {enc.shape[1]}), "
          f"encoder bf16, transducer f32: greedy (batched, K5 12 an encode) {ms_greedy:.1f} "
          f"ms/batch, {sum(map(len, out['greedy']))} tokens, device busy {busy:.1f} ms in "
          f"{n_events} events, idle {1 - busy / ms_greedy:.1%}; TSD beam {TRANS_BEAM} "
          f"{secs['tsd']:.1f} ms/batch; ALSD beam {TRANS_BEAM} {secs['alsd']:.1f} ms/batch; on "
          f"one utterance's first {TRANS_HOST_FRAMES} frames at beam {TRANS_BEAM}: default "
          f"{secs['default']:.1f} ms, NSC {secs['nsc']:.1f} ms, mAES {secs['maes']:.1f} ms; "
          f"card bf16 vs cpu f32: greedy ({TRANS_CPU_ROWS} utterances) "
          f"{token_agreement(out['greedy'][:TRANS_CPU_ROWS], c_greedy)}, default beam "
          f"{token_agreement([out['default']], [c_def[0][1]])}; top: " + top_kernels(per_name),
          flush=True)
    del model, cpu
    torch.cuda.empty_cache()
    return {"ms": secs, "busy": busy}


def trans_cli_phase(smi: str) -> dict:
    """Phase 45: the transducer recipe through the port's CLIs on the card,
    on `seame_corpus`'s train and valid splits (flac.ark, under
    build/chip_smoke_transducer/, removed afterwards): `bin.train` for one
    epoch at full width, then `bin.decode --beam_size 1` and
    `--transducer_search tsd --beam_size 4` of the train split (one chunk
    of 5 utterances padded to 3 s: T 93, inside K5's envelope; the 2 s
    valid utterance's 62 frames are below it) on its average, with K5 and
    K4 launches per stage; then the other searches (alsd, default, nsc,
    maes) at beam 4 on the valid utterance."""
    import shutil

    from agacs_tpu_torch.bin import decode, train

    root = os.path.join(ROOT, "build", "chip_smoke_transducer")
    shutil.rmtree(root, ignore_errors=True)
    data = options_data(root)
    exp = os.path.join(root, "exp")
    secs, counts = {}, {}

    def stage(name, fn):
        reset_conformer_counts()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts[name] = {k: v for k, v in trans_counts().items() if v}
        return r

    conf = os.path.join(ROOT, "recipes", "seame", "conf", "train_asr_transducer.yaml")
    out = stage("train", lambda: train.main([
        "--config", conf, "--train_dir", f"{data}/train", "--valid_dir", f"{data}/valid",
        "--exp_dir", exp, "--max_epoch", "1", "--override", "keep_nbest_models=1"]))
    hist = out["history"][1]
    check(np.isfinite(hist["train"]["loss"]) and {"cer", "loss_transducer"} <= set(hist["valid"])
          and all(counts["train"].get(k, 0) > 0 for k in TRANS_LAUNCHES),
          f"the train CLI's epoch: {hist}, launches {counts['train']}")
    common = ["--config", os.path.join(exp, "config.yaml"), "--params", out["ave"],
              "--data_dir", f"{data}/train"]
    for name, flags in (("greedy", ["--beam_size", "1"]),
                        ("tsd", ["--beam_size", str(TRANS_BEAM), "--transducer_search", "tsd"])):
        res = stage(f"decode {name}", lambda flags=flags, name=name: decode.main(
            common + flags + ["--output_dir", os.path.join(exp, f"decode_{name}")]))
        check(len(res["hyps"]) == 5 and counts[f"decode {name}"].get("K5", 0) == 12,
              f"decode {name}: a hypothesis, K5 12: {res['hyps']} {counts[f'decode {name}']}")
    for name in ("alsd", "default", "nsc", "maes"):
        res = stage(f"decode {name}", lambda name=name: decode.main(
            common[:-1] + [f"{data}/valid", "--beam_size", str(TRANS_BEAM),
                           "--transducer_search", name, "--output_dir",
                           os.path.join(exp, f"decode_{name}")]))
        check(len(res["hyps"]) == 1, f"decode {name}: a hypothesis: {res['hyps']}")
    print(f"phase 45 transducer CLIs on {smi}: bin.train (train_asr_transducer.yaml, full width, "
          f"1 epoch over seame_corpus's flac.ark train split), bin.decode greedy and TSD beam "
          f"{TRANS_BEAM} (train split), ALSD, default, NSC, mAES beam {TRANS_BEAM} (valid): " + "; ".join(f"{k} {secs[k]:.1f} s {counts[k]}" for k in secs)
          + f"; train loss {hist['train']['loss']:.3f}, valid cer {hist['valid']['cer']:.3f}",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"seconds": secs, "launches": counts}


# `--splits`: K3's instances at their main-path shapes, (name, rows or
# groups, Tp, d, heads, pos, form).
SPLIT_SWEEP = (("K3 greedy cross", 8, 752, D, H, 749, "bf16"),
               ("K3 greedy self", 8, 112, D, H, 103, "bf16"),
               ("K3@48 side cross", 8, 752, 192, 4, 749, "bf16"),
               ("K3 conformer self", 80, 112, 256, 4, 99, "bf16"),
               ("K3-f32 LM", 80, 112, 512, 8, 103, "f32"),
               ("K3-int8 cross", 8, 768, D, H, 749, "int8"),
               ("K3s beam cross", 8, 752, D, H, 749, "shared"),
               ("K3s-int8 beam cross", 8, 768, D, H, 749, "shared_int8"))


def split_sweep(dev) -> None:
    """`--splits`: each SPLIT_SWEEP shape timed at every S from 1 to
    MAX_SPLITS, each S first held against the plain version (KERNEL_RTOL;
    K3F32_RTOL for float32), beside the S `time_splits` picks."""
    from agacs_tpu_torch.ops import decode_attn as da

    g = torch.Generator().manual_seed(0)
    for name, n, tp, d, h, pos, form in SPLIT_SWEEP:
        shared, quant = form.startswith("shared"), form.endswith("int8")
        nq = n * BEAM if shared else n
        sets = []
        for _ in range(8):
            q, k, v = sharp_qkv(g, dev, (nq, d), (n, tp, d), q_scale=(d // h) ** -0.5)
            if form == "f32":
                q, k, v = q.float(), k.float(), v.float()
            sc = {}
            if quant:
                (k, ks), (v, vs) = quantized(k, dev), quantized(v, dev)
                sc = {"k_scale": ks, "v_scale": vs}
            sets.append((q, k, v, sc))

        def run(q, k, v, sc, splits=None, fn=None):
            if shared:
                fn = fn or da.decode_shared_cache_attention
                return fn(q, k, v, pos, h, BEAM, splits=splits, **sc)
            fn = fn or da.decode_cache_attention
            return fn(q, k, v, pos, h, splits=splits, **sc)

        q, k, v, sc = sets[0]
        plain = da.decode_cache_attention_split_ref(q.float(), k, v, pos, h, 1,
                                                    beam=BEAM if shared else None, **sc)
        rtol = K3F32_RTOL if form == "f32" else KERNEL_RTOL
        times = []
        for splits in range(1, da.MAX_SPLITS + 1):
            out = run(q, k, v, sc, splits)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            check(err <= rtol * plain.float().abs().max().item(),
                  f"{name} S={splits}: max_abs_err {err}")
            times.append(cuda_ms(lambda *a: run(*a, splits=splits), sets, 50))
        blocks = da.SHARED_SPLIT_BLOCKS if shared else da.SPLIT_BLOCKS
        print(f"splits {name} ({nq}, {tp}, {d}) H={h} pos={pos}: time_splits "
              f"{da.time_splits(n, h, tp, blocks)}; ms by S "
              + ", ".join(f"{i + 1}: {t:.4f}" for i, t in enumerate(times)), flush=True)


# Broken copies of the kernels that the checks must catch: name -> (source,
# [(text, replacement)], checks to run). Built outside the checkout by
# `mutants()`.
MUTANTS = {
    "unmutated source": ("int8_gemm.cu", [], ("k8", "k8q", "k2", "p15", "k3", "k3a", "k3s",
                                              "k3f32", "k3w", "k3pe", "k3i8", "k5", "k5b",
                                              "k4", "k6", "k3d48", "k1", "k1b")),
    "K1f without the online rescale": (
        "packed_flash_fwd.cu", [("const float a0 = hop::ex2((m0 - mx0) * C), a1 = hop::ex2((m1 - mx1) * C);",
                                 "const float a0 = 1.f, a1 = 1.f;")], ("k1", "k1b")),
    "K1f with the key tail unmasked (zero keys scoring 0)": (
        "packed_flash_fwd.cu", [("if (k0 + BK > T) {  // the key tail",
                                 "if (false) {  // the key tail")],
        ("k1", "k1b")),
    "K1f lse in log2 units": (
        "packed_flash_fwd.cu", [("(half ? m1 : m0) * SCALE + logf(l)",
                                 "(half ? m1 : m0) * C + log2f(l)")], ("k1b",)),
    "K1b without the D term": (
        "packed_flash_bwd.cu", [("return p * (dp - d);", "return p * dp;")], ("k1b",)),
    "K1b dkdv with the last partial q tile dropped": (
        "packed_flash_bwd.cu", [("const int n_q_tiles = (T + BS - 1) / BS;",
                                 "const int n_q_tiles = T / BS;")], ("k1b",)),
    "K1b dq with the key tail unmasked": (
        "packed_flash_bwd.cu", [("if (k0 + BS > T) {  // the key tail",
                                 "if (false) {  // the key tail")],
        ("k1b",)),
    "K6 with its scale per row (w_s[k])": (
        "w8a16.cu", [("f[r][c] = __fmul_rn(i8f(wv[r], c), sc[c]);",
                      "f[r][c] = __fmul_rn(i8f(wv[r], c), "
                      "w_s[((st0 + j) * KR + 16 * q + 4 * t + r) % N]);")], ("k6",)),
    "K6 with the scale folded after the sum": (
        "w8a16.cu", [("f[r][c] = __fmul_rn(i8f(wv[r], c), sc[c]);", "f[r][c] = i8f(wv[r], c);"),
                     ("o[0] = __floats2bfloat162_rn(v.x, v.y);",
                      "o[0] = __floats2bfloat162_rn(v.x * w_s[n0 + c], v.y * w_s[n0 + c + 1]);"),
                     ("o[1] = __floats2bfloat162_rn(v.z, v.w);",
                      "o[1] = __floats2bfloat162_rn(v.z * w_s[n0 + c + 2], "
                      "v.w * w_s[n0 + c + 3]);")], ("k6",)),
    "K6 with the last column tile dropped": (
        "w8a16.cu", [("(K + KR - 1) / KR, S, (N + BN - 1) / BN,",
                      "(K + KR - 1) / KR, S, (N + BN - 1) / BN - 1,")], ("k6",)),
    "K6 split: rank 0 sums S - 1 partials": (
        "thin_rows.cuh", [("for (int r = 1; r < S; ++r) add4(v, recv4[r * E4 + e]);",
                           "for (int r = 1; r < S - 1; ++r) add4(v, recv4[r * E4 + e]);")],
        ("k6",)),
    "K6 ring: a stage read before its copy arrived (one wait group short)": (
        "w8a16.cu", [("cp_wait<STAGES - 2>();  // stage j has landed",
                      "cp_wait<STAGES - 1>();  // stage j has landed")], ("k6",)),
    "K6 with the neighbouring column's scale": (
        "w8a16.cu", [("f[r][c] = __fmul_rn(i8f(wv[r], c), sc[c]);",
                      "f[r][c] = __fmul_rn(i8f(wv[r], c), sc[(c + 1) & 3]);")], ("k6",)),
    "K3@48 reading 64 channels": (
        "decode_attn.cu", [("const bool act = sub < pieces;",
                            "const bool act = sub < (DW == 48 ? 8 : pieces);")],
        ("k3d48",)),
    "K5 bwd dpe un-shifted one row off": (
        "relpos_flash.cu", [("const int p = p0 + 16 * warp", "const int p = p0 + 1 + 16 * warp")],
        ("k5b",)),
    "K5 bwd dv without 1/l": (
        "relpos_flash.cu",
        [("y[e] = __float2bfloat16(__bfloat162float(x[e]) * li);", "y[e] = x[e];")], ("k5b",)),
    "K5 bwd key mask ignored in ds": (
        "relpos_flash.cu", [("* scale + mask_s[c + e];", "* scale;")], ("k5b",)),
    "K5 bwd m written in log2 units": (
        "relpos_flash.cu", [("row_m[at] = m0;", "row_m[at] = m0 * LOG2E;"),
                            ("row_m[at + 8] = m1;", "row_m[at + 8] = m1 * LOG2E;")], ("k5b",)),
    "K5 bwd dkdv with the last partial query tile dropped": (
        "relpos_flash.cu", [("const int n_q_tiles = (T + BS - 1) / BS;",
                             "const int n_q_tiles = T / BS;")], ("k5b",)),
    "K5 bwd dq with the key tail unmasked": (
        "relpos_flash.cu", [("if (k0 + c + e >= T) x[e] = -INFINITY;", "")], ("k5b",)),
    # The forward's strip gives the columns from V on (zero W columns, so
    # S 0) a bias of 0 instead of -inf: every real logit is below 0 in the
    # check, so they dominate the lse.
    "K4 padded columns unmasked": (
        "vocab_lse.cu", [("strip[p.s * VT + j] = v0 + j < V ? bias[v0 + j] * LOG2E : -INFINITY;",
                          "strip[p.s * VT + j] = v0 + j < V ? bias[v0 + j] * LOG2E : 0.f;")],
        ("k4",)),
    "K4 forward V tail unmasked (b read past V)": (
        "vocab_lse.cu", [("strip[p.s * VT + j] = v0 + j < V ? bias[v0 + j] * LOG2E : -INFINITY;",
                          "strip[p.s * VT + j] = bias[v0 + j] * LOG2E;")], ("k4",)),
    "K4 forward: the running sum not rescaled when m grows": (
        "vocab_lse.cu", [("if (xa > ma) sa *= hop::ex2(ma - xa), ma = xa;",
                          "if (xa > ma) ma = xa;"),
                         ("if (xb > mb) sb *= hop::ex2(mb - xb), mb = xb;",
                          "if (xb > mb) mb = xb;")],
        ("k4",)),
    "K4 forward split: the last rank's pair left out of the merge": (
        "vocab_lse.cu", [("if (src < C) sum += sr[src] * hop::ex2(mr[src] - m);",
                          "if (src < C - 1) sum += sr[src] * hop::ex2(mr[src] - m);")], ("k4",)),
    "K4 dx without g": (
        "vocab_lse.cu", [("const float ga = ra < N ? g[ra] : 0.f, gb = rb < N ? g[rb] : 0.f;",
                          "const float ga = ra < N ? 1.f : 0.f, gb = rb < N ? 1.f : 0.f;")],
        ("k4",)),
    "K4 dw with db dropped": (
        "vocab_lse.cu", [("if (t == 0) db[va] = da, db[vb] = dbb;",
                          "if (t == 0) db[va] = 0.f, db[vb] = 0.f;")], ("k4",)),
    # b is NaN past V in the check: the V tail's zero W columns would hide
    # any finite value there
    "K4 dx V tail unmasked (b read past V)": (
        "vocab_lse.cu", [("strip[s * VT + c] = v0 + c < V ? bias[v0 + c] : -INFINITY;",
                          "strip[s * VT + c] = bias[v0 + c];")], ("k4",)),
    "K4 dx bias from the neighbouring column": (
        "vocab_lse.cu", [("strip[s * VT + c] = v0 + c < V ? bias[v0 + c] : -INFINITY;",
                          "strip[s * VT + c] = v0 + c < V ? bias[v0 + c + 1] : -INFINITY;")],
        ("k4",)),
    # lse and g are NaN past N in the check
    "K4 dw row tail unmasked (lse and g read past N)": (
        "vocab_lse.cu", [("sl[s * VT + c] = row < N ? lse[row] * LOG2E : INFINITY;",
                          "sl[s * VT + c] = lse[row] * LOG2E;"),
                         ("sg[s * VT + c] = row < N ? g[row] : 0.f;", "sg[s * VT + c] = g[row];")],
        ("k4",)),
    "K4 dw without g": (
        "vocab_lse.cu", [("sg[s * VT + c] = row < N ? g[row] : 0.f;",
                          "sg[s * VT + c] = row < N ? 1.f : 0.f;")], ("k4",)),
    "K4 dx split: the last rank's partial dropped": (
        "vocab_lse.cu", [("      if (src < C) {\n        a.x += lo[src].x",
                          "      if (src < C - 1) {\n        a.x += lo[src].x")], ("k4",)),
    # The split kernels above K 256 (dx and dw on clusters of K / 128).
    "K4 split: one rank's S partial left out of the rank-order sum": (
        "vocab_lse.cu", [("      if (r < C) z.x += v[r].x, z.y += v[r].y, z.z += v[r].z, z.w += v[r].w;",
                          "      if (r < C - 1) z.x += v[r].x, z.y += v[r].y, z.z += v[r].z, z.w += v[r].w;")],
        ("k4",)),
    "K4 split dx V tail unmasked at K > 256 (b read past V)": (
        "vocab_lse.cu", [("st0[s * VT + c] = j < V ? bias[j] : -INFINITY;",
                          "st0[s * VT + c] = bias[j];")], ("k4",)),
    "K4 split dw row tail unmasked (lse and g read past N)": (
        "vocab_lse.cu", [("st0[s * VT + c] = j < N ? lse[j] * LOG2E : INFINITY;",
                          "st0[s * VT + c] = lse[j] * LOG2E;"),
                         ("st1[s * VT + c] = j < N ? g[j] : 0.f;", "st1[s * VT + c] = g[j];")],
        ("k4",)),
    # each column's db is summed by the one rank that owns its quad: here
    # every rank writes its sums over rank 0's columns
    "K4 split dw: db written by every rank at rank 0's columns": (
        "vocab_lse.cu", [("      const int quad = q0 + (warp & 3) + 4 * m;\n      if (quad >= q0 + nq) break;",
                          "      const int quad = (warp & 3) + 4 * m;\n      if (quad >= nq) break;")],
        ("k4",)),
    "K4 split: a rank reads the partials one phase early": (
        "vocab_lse.cu", [("hop::mbar_wait_cluster(&sfull[x * NWG + wg], (it >> 1) & 1);",
                          "hop::mbar_wait_cluster(&sfull[x * NWG + wg], ((it >> 1) & 1) ^ 1);")],
        ("k4",)),
    "K5 shift off by one": (
        "relpos_flash.cu", [("return pw[(16 * warp + r) * PL + 15 - r + c];",
                             "return pw[(16 * warp + r) * PL + 16 - r + c];")], ("k5",)),
    "K5 key mask ignored": (
        "relpos_flash.cu", [("* scale + sm.mask[s][8 * (i >> 2) + 2 * t + (i & 1)];", "* scale;")],
        ("k5",)),
    "K5 pe rows read without the offset p0": (
        "relpos_flash.cu", [("&sm.full[s], c, T - 1 - (q0 + KK::BR - 1) + k0);",
                             "&sm.full[s], c, 0);")], ("k5",)),
    "K5 p left unnormalised": (
        "relpos_flash.cu", [("acc, row0, T, D, l0, l1);", "acc, row0, T, D, 1.f, 1.f);")],
        ("k5",)),
    "K5 forward key tail unmasked": (
        "relpos_flash.cu", [("if (k0 + BS > T) {  // the key tail", "if (false) {  // the key tail")],
        ("k5",)),
    # The wide route (heads above 128): the forward's value tile taken from
    # chunk 0 in every output chunk's block; dkdv's chunk order without its
    # own chunk last (its outputs then use another chunk's qu and do / l).
    "K5 wide forward v of chunk 0": (
        "relpos_flash.cu", [("&sm.full[s], col + 128 * cc, k0, b);", "&sm.full[s], col, k0, b);")],
        ("k5",)),
    "K5 wide dkdv own chunk not last": (
        "relpos_flash.cu", [("c = col + 128 * ((cc + 1 + it % NC) % NC);",
                             "c = col + 128 * (it % NC);")], ("k5b",)),
    "K3-PE gate ignored (a fixed 0.5 mix)": (
        "decode_attn.cu", [("const float g = PE ? gate[h] : 0.f;",
                            "const float g = PE ? 0.5f : 0.f;")], ("k3pe",)),
    "K3-PE gate[0] for every head": (
        "decode_attn.cu", [("const float g = PE ? gate[h] : 0.f;",
                            "const float g = PE ? gate[0] : 0.f;")], ("k3pe",)),
    "K3-PE k_cs read from k": (
        "decode_attn.cu", [("(PE && pc >= pieces ? reinterpret_cast<const KT*>(k_cs) : k)",
                            "(PE && pc >= pieces ? k : k)")], ("k3pe",)),
    "K3a-PE k_cs read from the query's own row": (
        "decode_attn.cu", [("const size_t off = ((size_t)r * Tp + c0 + t0 + kk) * D + h * dw;",
                            "const size_t off = ((size_t)(PE && !val && pc >= pieces ? n : r)"
                            " * Tp + c0 + t0 + kk) * D + h * dw;")], ("k3pe",)),
    "K3-int8 / K3s-int8 s_v missing": (
        "decode_attn.cu", [("if (QUANT) s[i] *= v_scale[h * dw + c];", ""),
                           ("if (QUANT) s *= v_scale[h * W + idx % W];", "")], ("k3i8",)),
    "K3-int8 / K3s-int8 s_k applied after the softmax": (
        "decode_attn.cu",
        [("return __bfloat162float(__float2bfloat16(x * k_scale[c]));", "return x;"),
         ("return pack_bf16(f.x * k_scale[ch0 + c], f.y * k_scale[ch0 + c + 1]);",
          "return pack_bf16(f.x, f.y);"),
         ("if (QUANT) s[i] *= v_scale[h * dw + c];",
          "if (QUANT) s[i] *= v_scale[h * dw + c] * k_scale[h * dw + c];"),
         ("if (QUANT) s *= v_scale[h * W + idx % W];",
          "if (QUANT) s *= v_scale[h * W + idx % W] * k_scale[h * W + idx % W];")],
        ("k3i8",)),
    "K3 p left unnormalised": (
        "decode_attn.cu", [("const float w = sc[t] / l;", "const float w = sc[t];")], ("k3",)),
    "K3 one key past pos": (
        "decode_attn.cu", [("const int nk = pos + 1;", "const int nk = min(pos + 2, Tp);")],
        ("k3",)),
    "K3 rows: a lane's second piece left out of the score (d_head past 32 pieces)": (
        "decode_attn.cu", [("if ((pp ? pc < pieces : act) && kk < cnt) {",
                            "if ((pp ? false : act) && kk < cnt) {")], ("k3w",)),
    "K3 rows: the value channels past 64 dropped": (
        "decode_attn.cu", [("        if (c < dw) {\n          const float2 f = load_pair(",
                            "        if (c < dw && i == 0) {\n          const float2 f = load_pair(")],
        ("k3w",)),
    "K3a reading each row's own cache row": (
        "decode_attn.cu", [("rows[t] = base + min(max(an[c0 + t], 0), J - 1);", "rows[t] = n;")],
        ("k3a",)),
    "K3-f32 p rounded to bf16": (
        "decode_attn.cu", [("sc[t] = F32 ? w : __bfloat162float(__float2bfloat16(w));",
                            "sc[t] = __bfloat162float(__float2bfloat16(w));")], ("k3f32",)),
    "K3 split: rank 0 sums S - 1 partials": (
        "decode_attn.cu",
        [("for (int r = 0; r < S; ++r) s[i] += parts[r][c];",
          "for (int r = 0; r < S - 1; ++r) s[i] += parts[r][c];"),
         ("for (int r = 0; r < S; ++r) s += parts[r * J * W + idx];",
          "for (int r = 0; r < S - 1; ++r) s += parts[r * J * W + idx];")],
        ("k3", "k3s")),
    "K3 split: each block's own max and sum": (
        "decode_attn.cu",
        [("for (int r = 0; r < S; ++r) m = fmaxf(m, xm[r]);", "m = mx;"),
         ("for (int r = 0; r < S; ++r) l += xl[r];", "l = sum;"),
         ("for (int r = 0; r < S; ++r) m = fmaxf(m, xm[r * J + i]);", "m = xm[rank * J + i];"),
         ("for (int r = 0; r < S; ++r) l += xl[r * J + i];", "l = xl[rank * J + i];")],
        ("k3", "k3s")),
    "K3 split: a chunk edge one key off": (
        "decode_attn.cu", [("const int c0 = rank * chunk;",
                            "const int c0 = rank * chunk + (rank > 0);")] * 2, ("k3", "k3s")),
    "K3 split: the last chunk reads a key past pos": (
        "decode_attn.cu", [("const int nkb = max(0, min(chunk, nk - c0));",
                            "const int nkb = max(0, min(chunk, min(nk + (S > 1 && rank == S - 1),"
                            " Tp) - c0));")] * 2, ("k3", "k3s")),
    "K3 split: an empty block's sum 1": (
        "decode_attn.cu", [("*cluster.map_shared_rank(&xl[rank], tid) = sum;",
                            "*cluster.map_shared_rank(&xl[rank], tid) = nkb ? sum : 1.f;")],
        ("k3",)),
    "K3 long route without the online rescale (alpha 1)": (
        "decode_attn.cu", [("const float alpha = expf(m_run - m_new);  // 0 on the first pass",
                            "const float alpha = 1.f;")], ("k3long",)),
    "K3 long route: the blocks' partials merged without their maxima's weights": (
        "decode_attn.cu", [("if (tid < S) xe[tid] = expf(xm[tid] - M);",
                            "if (tid < S) xe[tid] = 1.f;")], ("k3long",)),
    "K3 long route: the head's column pieces past the first left out of the scores": (
        "decode_attn.cu", [("const bool on = at < PIECE && ch < dh;",
                            "const bool on = at < PIECE && ch < dh && col == 0;")], ("k3forms",)),
    "K3s at d_head 128-256: every sub-row scored with the first 64 query channels": (
        "decode_attn.cu", [("q_fragments<KT>(qa[m], q, k_scale, row0, J, D, h * W + m * DH);",
                            "q_fragments<KT>(qa[m], q, k_scale, row0, J, D, h * W);")],
        ("k3sw",)),
    "K3s query tiles: every tile's queries from the group's first row": (
        "decode_attn.cu", [("const size_t row0 = (size_t)gi * JG + T * ti;",
                            "const size_t row0 = (size_t)gi * JG;")], ("k3sw",)),
    "K3s split: query i's partial from query i+1": (
        "decode_attn.cu", [("s += parts[r * J * W + idx];",
                            "s += parts[r * J * W + (idx + W < J * W ? idx + W : idx)];")],
        ("k3s",)),
    "K8q: a row's maximum over its first warp only (rows of 2-8 warps)": (
        "int8_gemm.cu", [("for (int w = 0; w < WPR; ++w) m = fmaxf(m, red[w0 + w]);",
                          "m = red[w0];")], ("k8q",)),
    "K8q per-tensor scale (one fixed scale for every row)": (
        "int8_gemm.cu", [("const float sc = i8::quant_scale(m), y = __frcp_rn(sc);",
                          "const float sc = i8::quant_scale(8.0f), y = __frcp_rn(sc);")],
        ("k8q", "k8")),
    "K8g wide: dequant with the tile's first row scale": (
        "int8_gemm.cu", [("sr[h] = row < M ? s_row[row] : 0.f;",
                          "sr[h] = row < M ? s_row[m0] : 0.f;")], ("k8",)),
    "K8g thin: the last split dropped": (
        "int8_gemm.cu", [("nst = max(0, min(n_stages, st0 + per) - st0);",
                          "nst = rank == S - 1 ? 0 : max(0, min(n_stages, st0 + per) - st0);")],
        ("k8",)),
    "K8g thin: row 0's scale for every row": (
        "int8_gemm.cu", [("const float sr = sc[r];", "const float sr = sc[0];")],
        ("k8",)),
    "K8g thin_matmul: each rank its own partial row max (no exchange)": (
        "int8_gemm.cu", [("for (int q = 0; q < S; ++q) m = fmaxf(m, pmax[q][r]);",
                          "m = pmax[rank][r];")], ("k8",)),
    "K8g thin_matmul: the row max over the rank's first stage only": (
        "int8_gemm.cu", [("for (int j = nst - 1; j >= 0; --j) {",
                          "for (int j = 0; j >= 0; --j) {")], ("k8",)),
    "K8g thin: w_q read untransposed": (
        "int8_gemm.cu", [("trans4(lo, wv[0], wv[1], wv[2], wv[3]);",
                          "lo[0] = wv[0], lo[1] = wv[1], lo[2] = wv[2], lo[3] = wv[3];"),
                         ("trans4(hi, wv[4], wv[5], wv[6], wv[7]);",
                          "hi[0] = wv[4], hi[1] = wv[5], hi[2] = wv[6], hi[3] = wv[7];")],
        ("k8",)),
    "K8g thin: the last column tile dropped": (
        "int8_gemm.cu", [("(K + TKR - 1) / TKR, S, (N + BN - 1) / BN, 1,",
                          "(K + TKR - 1) / TKR, S, (N + BN - 1) / BN - 1, 1,")],
        ("k8",)),
    "K8g wide: each B box read at swapped coordinates (w_q untransposed)": (
        "int8_gemm.cu",
        [("hop::tma_load_2d(slot + BM * WBK, &mp.b, &full[s], kb * WBK, n0);",
          "hop::tma_load_2d(slot + BM * WBK, &mp.b, &full[s], n0, kb * WBK);")],
        ("k8", "p15")),
    "K8g wide forward reads w_q instead of w_q^T": (
        "int8_gemm.cu", [("const int8_t* b = dgrad ? w : w_t;", "const int8_t* b = w;")],
        ("k8", "p15")),
    "K8g wide: the last k-block dropped": (
        "int8_gemm.cu", [("const int nkb = (K + WBK - 1) / WBK;",
                          "const int nkb = (K - 1) / WBK;")],
        ("k8", "p15")),
    "K2 x tile: each rank's quantised rows kept in its own tile": (
        "int8_mlp.cu", [("unsigned char* qd = cluster.map_shared_rank(q, dst);",
                         "unsigned char* qd = q;")], ("k2", "p15")),
    "K2 last partial row tile dropped": (
        "int8_mlp.cu", [("const int tiles = (n + BM - 1) / BM;", "const int tiles = n / BM;")],
        ("k2", "p15")),
    "K2 row max: one rank's maximum left out of the exchange": (  # phase 15 passes with it
        "int8_mlp.cu", [("for (int from = 0; from < C; ++from)",
                         "for (int from = 0; from < C - 1; ++from)")], ("k2",)),
    "K2 split: the last rank's int32 partial dropped": (
        "int8_mlp.cu", [("if (src < C) v.x += part[src].x", "if (src < C - 1) v.x += part[src].x")],
        ("k2", "p15")),
    "K2b s1 fold dropped": ("int8_mlp.cu", [("v = __fmul_rn(v, s1[col]);", "")],
                            ("k2", "p15")),
    # One correction already gives the IEEE quotient (y is 1/s correctly
    # rounded), so dropping one of the two changes nothing; RN(v y) alone is
    # off by an ulp near half-integers: one quantisation step on a few
    # elements, which KERNEL_RTOL need not see and the zero-difference
    # check must.
    "K2 quant_by: RN(v / s) without its FMA corrections": (
        "int8_mma.cuh", [("  q = __fmaf_rn(__fmaf_rn(-q, s, v), y, q);\n"
                         "  q = __fmaf_rn(__fmaf_rn(-q, s, v), y, q);\n", "")], ("k2",)),
    "K2 b1 dropped": ("int8_mlp.cu", [("b1[col]);\n        float v;", "0.f);\n        float v;")],
                      ("k2",)),  # phase 15 passes with it
    # Next to last: its stores run past the output's last row, into whatever
    # the allocator placed there, which may end the process's CUDA use.
    "K8g wide: the M tail unmasked": (
        "int8_gemm.cu", [("if (row < M && col < N)", "if (col < N)")], ("k8",)),
    # Last: their kernels break the ring's barrier protocol and trap, and the
    # process's CUDA context is lost with it; `mutants` runs what is left in
    # a new process.
    "K4 ring: dx reads a W slot one phase early": (
        "vocab_lse.cu", [("hop::mbar_wait(&full[s1], ph1);",
                          "hop::mbar_wait(&full[s1], ph1 ^ 1);")],
        ("k4",)),
    "K4 ring: the forward reads a W slot one phase early": (
        "vocab_lse.cu", [("if (more) hop::mbar_wait(&full[q.s], q.ph);",
                          "if (more) hop::mbar_wait(&full[q.s], q.ph ^ 1);")],
        ("k4",)),
    "K4 ring: the split kernels read a slot one phase early": (
        "vocab_lse.cu", [("if (more) hop::mbar_wait(&full[nx.s], nx.ph);",
                          "if (more) hop::mbar_wait(&full[nx.s], nx.ph ^ 1);")],
        ("k4",)),
    "K2 ring: a slot read one phase early": (
        "int8_mlp.cu", [("hop::mbar_wait(&R.full[cur.s], cur.ph);",
                         "hop::mbar_wait(&R.full[cur.s], cur.ph ^ 1);")], ("k2",)),
}


# The kernel checks a mutant can name (each run with timed=False); "p15",
# phase 15's int8 micro-step, is the other.

# ---------------------------------------------------------------------------
# K3 at every shape JAX's decode kernels take: the long route (phase 3L),
# K3s past 16 queries (phase 3s, beams 17-32), the whisper-only forms at
# other widths (phase 3w), and their paths (phases 53-55)
# ---------------------------------------------------------------------------

# Phase 3L's cases (label, form, rows, Tp, d, heads, positions, cache dtype,
# beam, forced keys or None, timed): phase 54's own calls, the conformer
# decoder's bf16 rows and the LM's float32 rows over its caches (65616
# positions: blocks of 8202 and 9374 keys, past the short route's table of
# 8192) at its positions, in passes of PASS_KEYS (two or three a block);
# then, as extra shapes, the same rows over caches of 8256 positions, K3a
# and K3-PE at whisper-small's width, each in tables and passes of 1024
# (`forced_long`: at the default tables a block's keys fit the short route
# there); a 65536-key cache in tables and passes of 4096 (8192 keys a
# block, two passes; the short route's one table timed beside it); K3a-PE in passes of 64, int8 rows at S = 1 and K3s's groups, one query a
# block.
K3L_PHASE54 = ("phase 54's decoder rows", "phase 54's LM rows (K3-f32)")
K3L_CASES = (
    (K3L_PHASE54[0], "rows", 10, 65616, 256, 4, (8185, 8191, 8192, 8200), torch.bfloat16, 1,
     None, True),
    (K3L_PHASE54[1], "rows", 10, 65616, 512, 8, (8200,), torch.float32, 1, None, True),
    ("conformer decoder rows", "rows", 10, 8256, 256, 4, (8191, 8192, 8200), torch.bfloat16,
     1, 1024, True),
    ("LM rows (K3-f32)", "rows", 10, 8256, 512, 8, (8200,), torch.float32, 1, 1024, True),
    ("rows at 65536 keys", "rows", 10, 65536, 256, 4, (65535,), torch.bfloat16, 1, 4096, True),
    ("K3a", "anc", 40, 4608, 768, 12, (4600,), torch.bfloat16, 5, 1024, False),
    ("K3-PE", "pe", 8, 8256, 768, 12, (8200,), torch.bfloat16, 1, 1024, False),
    ("K3a-PE, passes of 64", "anc_pe", 10, 448, 768, 12, (447,), torch.bfloat16, 5, 64, False),
    ("K3-int8, one block", "rows", 8, 1504, 768, 12, (1499,), torch.int8, 1, 1024, False),
    ("K3s, one query a block", "shared", 2, 8256, 768, 12, (8200,), torch.bfloat16, 5, 1024,
     False),
)


def card_inputs(gen, form: str, n: int, tp: int, d: int, h: int, beam: int, dtype, dev) -> dict:
    """Sharp, shifted q, k, v (as `sharp_qkv`) drawn on the card from `gen`,
    with the form's extras: `anc_local` (a beam run's map), q_cs, k_cs and
    a gate (PE), int8 caches and scales (`quantize_kv`); float32 for a
    float32 form. Shared: n groups of `beam` queries."""
    nq = n * beam if form == "shared" else n
    qdt = torch.float32 if dtype == torch.float32 else torch.bfloat16

    def rnd(shape, mean, std, scale=1.0):
        return ((torch.randn(*shape, generator=gen, device=dev) * std + mean) * scale).to(qdt)

    dh = d // h
    out = {"q": rnd((nq, d), -1.0, 1.5, dh ** -0.5), "k": rnd((n, tp, d), 1.0, 1.5),
           "v": rnd((n, tp, d), 0.0, 1.0)}
    if "pe" in form:
        out.update(q_cs=rnd((nq, d), -1.0, 1.5, dh ** -0.5), k_cs=rnd((n, tp, d), 1.0, 1.5),
                   gate=torch.cat([torch.tensor([0.0, 1.0], device=dev),
                                   torch.rand(max(h - 2, 0), generator=gen, device=dev)])[:h])
    if "anc" in form:
        own = torch.arange(n, device=dev)[:, None] % beam
        other = (own + torch.randint(1, beam, (n, tp), generator=gen, device=dev)) % beam
        out["anc_local"] = torch.where(torch.rand(n, tp, generator=gen, device=dev) < 0.2,
                                       own, other).to(torch.int32).contiguous()
    if dtype == torch.int8:
        from agacs_tpu_torch.models.whisper import quantize_kv

        (out["k"], out["k_scale"]), (out["v"], out["v_scale"]) = (
            quantize_kv(out["k"]), quantize_kv(out["v"]))
    return out


def poisoned_inputs(x: dict, form: str, beam: int, pos: int) -> dict:
    """Copies of x's caches with every entry the kernel must not read (past
    pos, and through a map every entry no row of its group selects) set to
    a score far above the rest (k, k_cs 0) and a value of 1e4 (127 in
    int8)."""
    k = x["k"]
    bad = unread(x.get("anc_local"), k.shape[0], k.shape[1], beam, pos, k.device)
    out = dict(x)
    int8 = k.dtype == torch.int8
    for name, val in (("k", 127 if int8 else 0.0), ("k_cs", 0.0), ("v", 127 if int8 else 1e4)):
        if name in x:
            out[name] = x[name].clone()
            out[name][bad] = val
    return out


def k3_call(form: str, beam: int, splits=None):
    """The wrapper call of `form` over an input dict: (q, k, v, pos, h, **x)."""
    from agacs_tpu_torch.ops import decode_attn as da

    def call(x, pos, h):
        kw = {n: t for n, t in x.items() if n not in ("q", "k", "v")}
        if form == "shared":
            return da.decode_shared_cache_attention(x["q"], x["k"], x["v"], pos, h, beam,
                                                    splits=splits, **kw)
        if "anc" in form:
            kw["beam"] = beam
        return da.decode_cache_attention(x["q"], x["k"], x["v"], pos, h, splits=splits, **kw)
    return call


@contextlib.contextmanager
def forced_long(keys, passes: bool = True):
    """The short route's tables (SHORT_KEYS, SHORT_MAP_KEYS) and, with
    `passes`, the long route's PASS_KEYS set to `keys` (None: left as they
    are) inside the block: the long route forced at a short cache."""
    from agacs_tpu_torch.ops import decode_attn as da

    names = ("SHORT_KEYS", "SHORT_MAP_KEYS") + (("PASS_KEYS",) if passes else ())
    kept = {n: getattr(da, n) for n in names}
    for n in names:
        setattr(da, n, keys or kept[n])
    try:
        yield
    finally:
        for n, v in kept.items():
            setattr(da, n, v)


def k3_bound(form: str, n: int, pos: int, d: int, beam: int, dtype) -> dict:
    """K3's bound on the card: the keys and values 0..pos read once (k_cs
    too for PE; the shared form's caches once a group), q (and q_cs) read
    and o written; 4 operations a key channel a query (6 for PE), in bf16
    (int8 widened to bf16) or float32."""
    esz = {torch.bfloat16: 2, torch.int8: 1, torch.float32: 4}[dtype]
    qsz = 4 if dtype == torch.float32 else 2
    nq = n * beam if form == "shared" else n
    caches = 3 if "pe" in form else 2
    nbytes = caches * n * (pos + 1) * d * esz + caches * nq * d * qsz
    ops = (6 if "pe" in form else 4) * nq * (pos + 1) * d
    return roofline(nbytes, ops, "f32" if dtype == torch.float32 else "bf16")


def check_k3_long(dev, g=None, timed=True) -> dict:
    """Phase 3L: K3's long route (`decode_attn_long_fwd`) against its plain
    version `decode_cache_attention_chunked_ref` (computed on the card in
    float32 from the same inputs) at K3L_CASES: every call twice and
    bit-identical, one LONG launch a call, keys past pos (and every entry
    a map leaves unread) poisoned in the kernel's input; KERNEL_RTOL x max
    |plain| (K3F32_RTOL for float32). The timed cases beside the plain
    version, SDPA on the key slice and the bytes bound. Returns
    {label: result} of the timed ones."""
    from agacs_tpu_torch.ops import decode_attn as da

    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for label, form, n, tp, d, h, positions, dtype, beam, pk, timed_case in K3L_CASES:
        x = card_inputs(gen, form, n, tp, d, h, beam, dtype, dev)
        splits = 1 if "one block" in label else None
        call = k3_call(form, beam, splits)
        with forced_long(pk):
            route, s, kc = da.plan(form, n, h, x["k"], beam, splits)
        check(route == "long", f"phase 3L {label}: the long route ({route})")
        rtol = K3F32_RTOL if dtype == torch.float32 else KERNEL_RTOL
        for pos in positions:
            before = da.LONG_LAUNCHES
            with forced_long(pk):
                got = twice(f"K3 long {label}", call, poisoned_inputs(x, form, beam, pos), pos,
                            h)
            check(da.LONG_LAUNCHES == before + 2, f"phase 3L {label}: one launch a call")
            plain = da.decode_cache_attention_chunked_ref(
                x["q"], x["k"], x["v"], pos, h, s, kc, shared=form == "shared",
                **({"beam": beam} if beam > 1 else {}),
                **{k: v for k, v in x.items() if k not in ("q", "k", "v")})
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs().max().item()
            bound = rtol * plain.float().abs().max().item()
            check(got.shape == plain.shape and got.dtype == x["q"].dtype and err <= bound,
                  f"phase 3L {label} pos={pos}: max_abs_err {err} <= {bound}")
            line = (f"phase 3L K3 long route, {label} ({n}, {tp}, {d}) H={h} pos={pos} S={s} "
                    f"passes of {kc}: max_abs_err {err:.3e} (bound {rtol} x max|plain f32|), "
                    f"bit-identical twice, one launch a call")
            if timed and timed_case and pos == positions[-1]:
                sets = [(x, pos, h), (card_inputs(gen, form, n, tp, d, h, beam, dtype, dev),
                                      pos, h)]
                with forced_long(pk):
                    ms = cuda_ms(call, sets, 20)
                res = {"err": err, "ms": ms,
                       "plain_ms": cuda_ms(lambda x_, p, hh: da.decode_cache_attention_chunked_ref(
                           x_["q"], x_["k"], x_["v"], p, hh, s, kc), sets, 3)}
                res["library_ms"], backend = sdpa_ms(lambda x_, p, hh: sdpa_one_query(
                    x_["q"], x_["k"][:, : p + 1], x_["v"][:, : p + 1], p, hh, masked=False),
                    sets, 20)
                res.update(k3_bound(form, n, pos, d, beam, dtype))
                out[label] = res
                line += (f"; kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms sdpa on "
                         f"the key slice ({backend}) {res['library_ms']:.4f} ms bound "
                         f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
                if da.plan(form, n, h, x["k"], beam, splits)[0] != "long":  # the table holds it
                    short = cuda_ms(call, sets, 20)
                    line += f"; the short route at this shape (one table a block) {short:.4f} ms"
                    res["short_ms"] = short
            print(line, flush=True)
        del x
    torch.cuda.empty_cache()
    return out


# Phase 3s past 16 queries: whisper-small's beam cross-attention at beams
# 17, 20 and 32 over 8 utterances' (1504, 768) cross-KV (two query tiles a
# group), and at d_head 128, 192 and 256 (64-channel sub-rows) at beams 5
# and 20; pos 1499 (T_audio - 1), bf16 and int8; timed at beam 20 and (int8)
# at d_head 128, beam 5 (phase 55's cross-attention). And K3a at phase 53's
# self-attention shape, (8 x 20, 448, 768), pos 447. Then K3s at beam 5
# with blocks past 4096 keys (K3S_TABLE: 8 groups over 18016 keys, S 3,
# blocks of 6006; bf16 and int8), within its table of 8192.
K3S_TABLE = (8, 18016, 18000, 5)
K3S_CASES = ((64, 17), (64, 20), (64, 32), (128, 5), (128, 20), (192, 5), (192, 20), (256, 5),
             (256, 20))
K3S_TIMED = {("bf16", 64, 20), ("int8", 64, 20), ("int8", 128, 5)}
K3S_WIDE_TP, K3S_WIDE_POS = 1504, 1499


def check_k3s_wide(dev, g=None, timed=True) -> dict:
    """Phase 3s past 16 queries a group and at wider heads (K3S_CASES):
    K3s and K3s-int8 on the tensor cores in balanced tiles of at most 16
    queries against their plain versions (float32; int8 in the kernel's
    folding), keys past pos poisoned, every call twice and bit-identical,
    one launch a call; K3S_TIMED timed beside SDPA (on the dequantised
    caches for int8) on the key slice and the bound. Then K3a at (160, 448,
    768), beam 20. Returns {(kind, d_head, beam): result} of the timed."""
    from agacs_tpu_torch.ops import decode_attn as da

    gen = torch.Generator(device=dev).manual_seed(32)
    g, tp, pos, out = 8, K3S_WIDE_TP, K3S_WIDE_POS, {}
    for kind, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        counter = "SHARED_I8_LAUNCHES" if kind == "int8" else "SHARED_LAUNCHES"
        for dh, j in K3S_CASES:
            h = D // dh
            x = card_inputs(gen, "shared", g, tp, D, h, j, dtype, dev)
            route, s, _ = da.plan("shared", g, h, x["k"], j)
            check(route == "shared", f"phase 3s d_head {dh} beam {j} {kind}: the tensor cores "
                  f"({route})")
            call = k3_call("shared", j)
            before = getattr(da, counter)
            got = twice(f"K3s d_head {dh} beam {j} {kind}", call,
                        poisoned_inputs(x, "shared", j, pos), pos, h)
            check(getattr(da, counter) == before + 2, f"phase 3s d_head {dh} beam {j}: one "
                  "launch a call")
            plain_fn = ((lambda x_, p, hh: da.decode_shared_cache_attention_int8_ref(
                x_["q"], x_["k"], x_["v"], p, hh, j, x_["k_scale"], x_["v_scale"]))
                if kind == "int8" else (lambda x_, p, hh: da.decode_shared_cache_attention_ref(
                    x_["q"].float(), x_["k"].float(), x_["v"].float(), p, hh, j)))
            err = hold(f"K3s {kind} d_head {dh} beam {j}", got, plain_fn(x, pos, h),
                       (g * j, tp, D))
            line = (f"phase 3s K3s {kind} ({g} x {j}, {tp}, {D}) H={h} d_head {dh} pos={pos} "
                    f"S={s}, query tiles {da.query_tiles(j)} a group: max_abs_err {err:.3e} "
                    f"(bound {KERNEL_RTOL} x max|plain f32|), bit-identical twice")
            if timed and (kind, dh, j) in K3S_TIMED:  # buffers past the L2 together
                sets = [(x, pos, h)] + [(card_inputs(gen, "shared", g, tp, D, h, j, dtype, dev),
                                         pos, h) for _ in range(3 if kind == "int8" else 1)]
                lib_sets = [(x_["q"], *((da.dequantize_kv(x_["k"], x_["k_scale"], torch.bfloat16),
                                         da.dequantize_kv(x_["v"], x_["v_scale"], torch.bfloat16))
                                        if kind == "int8" else (x_["k"], x_["v"])), p, hh, j)
                            for x_, p, hh in sets]
                lib = sdpa_yardsticks(lib_sets, j)
                res = {"err": err, "ms": cuda_ms(call, sets, 50),
                       "plain_ms": cuda_ms(plain_fn, sets, 20), "library_ms": lib["library_ms"],
                       **k3_bound("shared", g, pos, D, j, dtype)}
                out[(kind, dh, j)] = res
                line += (f"; kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms "
                         f"{lib['text']} bound {res['bound_ms']:.4f} ms")
            print(line, flush=True)
    g, tp, pos, j = K3S_TABLE
    for kind, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        x = card_inputs(gen, "shared", g, tp, D, H, j, dtype, dev)
        route, s, _ = da.plan("shared", g, H, x["k"], j)
        check(route == "shared", f"phase 3s {kind} over {tp} keys: the tensor cores ({route})")
        counter = "SHARED_I8_LAUNCHES" if kind == "int8" else "SHARED_LAUNCHES"
        before = getattr(da, counter)
        got = twice(f"K3s {kind} over {tp} keys", k3_call("shared", j),
                    poisoned_inputs(x, "shared", j, pos), pos, H)
        check(getattr(da, counter) == before + 2, f"phase 3s {kind} over {tp}: one launch")
        plain = (da.decode_shared_cache_attention_int8_ref(
            x["q"], x["k"], x["v"], pos, H, j, x["k_scale"], x["v_scale"]) if kind == "int8"
            else da.decode_shared_cache_attention_ref(x["q"].float(), x["k"].float(),
                                                      x["v"].float(), pos, H, j))
        err = hold(f"K3s {kind} over {tp} keys", got, plain, (g * j, tp, D))
        print(f"phase 3s K3s {kind} ({g} x {j}, {tp}, {D}) H={H} pos={pos} S={s}, blocks of "
              f"{-(-tp // s)} keys: max_abs_err {err:.3e} (bound {KERNEL_RTOL} x max|plain "
              "f32|), bit-identical twice", flush=True)
        del x
    n, tp, j, pos = 8 * 20, 448, 20, 447
    x = card_inputs(gen, "anc", n, tp, D, H, j, torch.bfloat16, dev)
    before = da.ANC_LAUNCHES
    got = twice("K3a beam 20", k3_call("anc", j), poisoned_inputs(x, "anc", j, pos), pos, H)
    check(da.ANC_LAUNCHES == before + 2, "phase 3s K3a beam 20: one launch a call")
    err = hold("K3a beam 20", got, da.decode_cache_attention_anc_ref(
        x["q"].float(), x["k"].float(), x["v"].float(), pos, H, x["anc_local"], j), (n, tp, D))
    print(f"phase 3s K3a at phase 53's self-attention ({n}, {tp}, {D}) beam {j} pos={pos} S="
          f"{da.plan('anc', n, H, x['k'], j)[1]}: max_abs_err {err:.3e}, bit-identical twice",
          flush=True)
    return out


# Phase 3w's cases: each whisper-only form at d_head 32, 48, 128 and 256 on
# a beam's self-attention shape (40 rows, 112 keys; int8 128) at
# whisper-small's width (768 in 24, 16, 6 and 3 heads), pos 103, and the
# plain rows at d_head 320 and 512 on (8, 752) pos 749 (the long route,
# heads in 256-wide pieces, bf16 and float32); then widths and forms only
# the long route takes: an odd width (33), K3a at 36, float32 K3a-PE, and
# K3s at d_head 96 (int8) and in float32 (one query a block). d_head 128
# timed, and beside it the long route at the same shape in one pass (the
# short route's tables forced below its keys). Then the short route at the
# edge of its table, one block a (head, row) (K3W_SHORT: form, rows, Tp, d,
# heads, pos, cache dtype, beam, splits, route): K3a at d_head 128 on
# phase 53's self-cache length (10 rows, 448 keys, pos 447), K3a with a
# full table of 4096 keys and rows, K3-PE and K3-f32 with full tables of
# 8192 scores.
K3W_SHORT = (("anc", 10, 448, 768, 6, 447, torch.bfloat16, 5, None, "forms"),
             ("anc", 10, 4096, 768, 6, 4095, torch.bfloat16, 5, 1, "forms"),
             ("pe", 8, 8192, 768, 6, 8191, torch.bfloat16, 1, 1, "forms"),
             ("rows", 8, 8192, 512, 8, 8191, torch.float32, 1, 1, "f32"))
K3W_FORMS = ("anc", "pe", "anc_pe", "int8", "anc_int8")
K3W_WIDTHS = (32, 48, 128, 256)
K3W_LONG = (("rows", 8, 752, 640, 2, 749, torch.bfloat16, 1), ("rows", 8, 752, 640, 2, 749,
                                                                 torch.float32, 1),
            ("rows", 8, 752, 1024, 2, 749, torch.bfloat16, 1),
            ("rows", 8, 752, 1024, 2, 749, torch.float32, 1),
            ("rows", 8, 112, 99, 3, 103, torch.bfloat16, 1),
            ("anc", 40, 112, 144, 4, 103, torch.bfloat16, 5),
            ("anc_pe", 40, 112, 768, 12, 103, torch.float32, 5),
            ("shared", 8, 1504, 768, 8, 1499, torch.int8, 5),
            ("shared", 8, 1504, 768, 12, 1499, torch.float32, 5))


def form_plain(form: str, x: dict, pos: int, h: int, beam: int):
    """The plain version of the short route's kernel for `form` in float32
    (int8 in the kernel's folding)."""
    from agacs_tpu_torch.ops import decode_attn as da

    f = {k: (v.float() if v.is_floating_point() else v) for k, v in x.items()}
    if "int8" in form or x["k"].dtype == torch.int8:
        k, v = x["k"], x["v"]
        if "anc" in form:
            k, v = (da.gather_ancestry(t, x["anc_local"], beam) for t in (k, v))
        return da.decode_cache_attention_int8_ref(x["q"], k, v, pos, h, x["k_scale"],
                                                  x["v_scale"])
    pe = {n: f[n] for n in ("q_cs", "k_cs", "gate") if n in f}
    if "anc" in form:
        return da.decode_cache_attention_anc_ref(f["q"], f["k"], f["v"], pos, h,
                                                 x["anc_local"], beam, **pe)
    return da.decode_cache_attention_ref(f["q"], f["k"], f["v"], pos, h, **pe)


def form_library(form: str, x: dict, pos: int, h: int):
    """The SDPA call on the key slice that computes `form`'s function where
    one does (PE: [q (1-g) | q_cs g] against [k | k_cs]; int8: the
    dequantised caches), and None through a map."""
    from agacs_tpu_torch.ops import decode_attn as da

    if "anc" in form:
        return None
    k, v = x["k"][:, : pos + 1], x["v"][:, : pos + 1]
    if k.dtype == torch.int8:
        k = da.dequantize_kv(k, x["k_scale"], torch.bfloat16)
        v = da.dequantize_kv(v, x["v_scale"], torch.bfloat16)
    n = k.shape[0]
    if "pe" in form:
        g = x["gate"].view(1, h, 1, 1)
        qh = lambda t: t.view(n, 1, h, -1).transpose(1, 2).float()  # noqa: E731
        q2 = torch.cat([(1 - g) * qh(x["q"]), g * qh(x["q_cs"])], -1).to(x["q"].dtype)
        k2 = torch.cat([sdpa_heads(k, h), sdpa_heads(x["k_cs"][:, : pos + 1], h)], -1)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q2, k2, sdpa_heads(v, h), scale=1.0)
    return lambda: sdpa_one_query(x["q"], k, v, pos, h, masked=False)


def check_k3_forms(dev, g=None, timed=True) -> dict:
    """Phase 3w: each whisper-only form (K3W_FORMS) at K3W_WIDTHS on the
    runtime-width forms entry (d_head 64 keeps its fixed instances) against
    its plain version, then the K3W_LONG cases on the long route against
    `decode_cache_attention_chunked_ref`; keys past pos and unread map
    entries poisoned, every call twice and bit-identical, one launch a call
    of its counter; KERNEL_RTOL (float32: K3F32_RTOL). Timed at d_head 128
    beside the plain version, SDPA on the key slice and the bound. Returns
    {form: result at 128}."""
    from agacs_tpu_torch.ops import decode_attn as da

    gen = torch.Generator(device=dev).manual_seed(33)
    out = {}
    for form in K3W_FORMS:
        int8 = "int8" in form
        base = form.replace("_int8", "").replace("int8", "rows")
        counter = DECODE_COUNTERS[{"anc": "K3a", "pe": "K3-PE", "anc_pe": "K3a-PE",
                                   "int8": "K3-int8", "anc_int8": "K3a-int8"}[form]]
        for dh in K3W_WIDTHS:
            n, tp, pos, h, beam = 40, 128 if int8 else 112, 103, D // dh, BEAM
            dtype = torch.int8 if int8 else torch.bfloat16
            x = card_inputs(gen, base, n, tp, D, h, beam, dtype, dev)
            route = da.plan(base, n, h, x["k"], beam if "anc" in form else 1)[0]
            check(route == "forms", f"phase 3w {form} d_head {dh}: the forms entry ({route})")
            call = k3_call(base, beam)
            before = getattr(da, counter)
            got = twice(f"{form} d_head {dh}", call, poisoned_inputs(x, base, beam, pos), pos, h)
            check(getattr(da, counter) == before + 2, f"phase 3w {form} d_head {dh}: one launch")
            err = hold(f"{form} d_head {dh}", got, form_plain(form, x, pos, h, beam), (n, tp, D))
            line = (f"phase 3w {form} d_head {dh} ({n}, {tp}, {D}) H={h} pos={pos}: max_abs_err "
                    f"{err:.3e} (bound {KERNEL_RTOL} x max|plain f32|), bit-identical twice")
            if timed and dh == 128:  # buffers past the L2 together
                sets = [(x, pos, h)] + [(card_inputs(gen, base, n, tp, D, h, beam, dtype, dev),
                                         pos, h) for _ in range(4)]
                lib = [form_library(form, *a) for a in sets]
                res = {"err": err, "ms": cuda_ms(call, sets, 50),
                       "plain_ms": cuda_ms(lambda x_, p, hh: form_plain(form, x_, p, hh, beam),
                                           sets, 20),
                       "library_ms": None if lib[0] is None else cuda_ms(
                           lambda f: f(), [(f,) for f in lib], 50),
                       **k3_bound(base, n, pos, D, 1, dtype)}
                with forced_long(64, passes=False):
                    check(da.plan(base, n, h, x["k"], beam if "anc" in form else 1)[0] == "long",
                          f"phase 3w {form}: the long route forced")
                    res["long_ms"] = cuda_ms(call, sets, 50)
                out[form] = res
                line += (f"; kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms sdpa on "
                         f"the key slice " + ("none (through a map)" if lib[0] is None else
                                              f"{res['library_ms']:.4f} ms")
                         + f" bound {res['bound_ms']:.4f} ms; the long route at this shape "
                         f"(one pass) {res['long_ms']:.4f} ms, "
                         f"{res['long_ms'] / res['ms']:.2f} x the forms entry")
            print(line, flush=True)
    for form, n, tp, d, h, pos, dtype, beam, splits, want in K3W_SHORT:
        x = card_inputs(gen, form, n, tp, d, h, beam, dtype, dev)
        route, s, _ = da.plan(form, n, h, x["k"], beam, splits)
        check(route == want, f"phase 3w {form} ({n}, {tp}, {d}) H={h}: {want} ({route})")
        counter = DECODE_COUNTERS["K3-f32" if dtype == torch.float32 else
                                  {"anc": "K3a", "pe": "K3-PE"}[form]]
        before = getattr(da, counter)
        got = twice(f"{form} ({n}, {tp}, {d}) short", k3_call(form, beam, splits),
                    poisoned_inputs(x, form, beam, pos), pos, h)
        check(getattr(da, counter) == before + 2, f"phase 3w {form} ({n}, {tp}): one launch")
        plain = form_plain(form, x, pos, h, beam)
        torch.cuda.synchronize()
        rtol = K3F32_RTOL if dtype == torch.float32 else KERNEL_RTOL
        err = (got.float() - plain.float()).abs().max().item()
        bound = rtol * plain.float().abs().max().item()
        check(got.shape == plain.shape and err <= bound,
              f"phase 3w short {form} ({n}, {tp}, {d}) H={h} pos={pos}: {err} <= {bound}")
        print(f"phase 3w short route at its table, {form} d_head {d // h} {str(dtype)[6:]} "
              f"({n}, {tp}, {d}) H={h} pos={pos} S={s} ({route}): max_abs_err {err:.3e} (bound "
              f"{rtol} x max|plain f32|), bit-identical twice", flush=True)
        del x
    for form, n, tp, d, h, pos, dtype, beam in K3W_LONG:
        x = card_inputs(gen, form, n, tp, d, h, beam, dtype, dev)
        route, s, kc = da.plan(form, n, h, x["k"], beam)
        check(route == "long", f"phase 3w {form} d_head {d // h}: the long route ({route})")
        before = da.LONG_LAUNCHES
        call = k3_call(form, beam)
        got = twice(f"{form} d_head {d // h} long", call, poisoned_inputs(x, form, beam, pos),
                    pos, h)
        check(da.LONG_LAUNCHES == before + 2, f"phase 3w {form} d_head {d // h}: one launch")
        plain = da.decode_cache_attention_chunked_ref(
            x["q"], x["k"], x["v"], pos, h, s, kc, shared=form == "shared",
            **({"beam": beam} if beam > 1 else {}),
            **{k: v for k, v in x.items() if k not in ("q", "k", "v")})
        torch.cuda.synchronize()
        rtol = K3F32_RTOL if dtype == torch.float32 else KERNEL_RTOL
        err = (got.float() - plain.float()).abs().max().item()
        bound = rtol * plain.float().abs().max().item()
        check(err <= bound, f"phase 3w long {form} d_head {d // h} {dtype}: {err} <= {bound}")
        line = (f"phase 3w long route {form} d_head {d // h} {str(dtype)[6:]} ({n}, {tp}, {d}) "
                f"H={h} pos={pos} S={s}: max_abs_err {err:.3e} (bound {rtol} x max|plain f32|), "
                "bit-identical twice")
        print(line, flush=True)
    return out


# Phase 53: whisper-small's beam-20 serving. The decode YAML's maxlenratio
# 0 gives a 448-position self cache (maxlen = min(frames, 448 - 6) = 442);
# `Speech2Text` sizes the cache from the step cap, so the cap is 442 here.
BEAM20 = 20


def beam20_phase(model, asr_cfg, audio, cpu_model, enc_cpu) -> dict:
    """Phase 53: Speech2Text(beam_size 20, maxlenratio 0, loop scan) on phase
    4's stage-2 whisper-small (full depth and width, bf16) over 8 x 15 s:
    a warm-up of WARM_STEPS, then one timed request whose K3a (160 rows
    through the ancestry map over the 448-position self cache) and K3s (20
    queries a group, two tiles) launches equal 12 a decode step exactly,
    K1f 12, nothing else; one more under the profiler for the device's
    busy and idle shares; the hypotheses' reported scores against their
    teacher-forced rescoring on the card and (utterance 0) on the CPU in
    float32 (phase 12's bounds)."""
    from agacs_tpu_torch.decode import beam as tbeam
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.models.asr_model import encode
    from agacs_tpu_torch.ops.decode_attn import pad_time

    cfg = model.cfg
    s2t = Speech2Text(model, asr_cfg, beam_size=BEAM20, max_steps=None, maxlenratio=0.0,
                      loop="scan")
    warm_up(Speech2Text(model, asr_cfg, beam_size=BEAM20, max_steps=WARM_STEPS, loop="scan"),
            audio)
    real, steps = tbeam.whisper_decode_step, [0]

    def counted(*a, **k):
        steps[0] += 1
        return real(*a, **k)

    tbeam.whisper_decode_step = counted
    try:
        reset_decode_counts()
        t0 = time.perf_counter()
        results = s2t(audio)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        tbeam.whisper_decode_step = real
    launches = {k: v for k, v in decode_counts().items() if v}
    per = cfg.n_text_layer * steps[0]
    want = {"K1f": cfg.n_audio_layer, "K3a": per, "K3s": per}
    check(launches == want, f"phase 53 launches {launches} == {want}")
    limit = min(len(PRIMER) + s2t._maxlen(750), cfg.n_text_ctx) - 1
    check(len(results) == 8 and all(r.tokens[:5] == PRIMER and len(r.tokens) <= limit + 2
                                    and np.isfinite(r.score) for r in results),
          "phase 53: 8 finite beam-20 hypotheses")
    busy, n_events, per_name = device_profile(lambda: s2t(audio))
    k3a = sum(t for name, t in per_name.items() if "decode_attn_kernel<true, false" in name)
    k3s = sum(t for name, t in per_name.items() if "decode_attn_shared_kernel" in name)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        enc, _ = encode(model, asr_cfg, torch.from_numpy(audio).to(dev),
                        torch.full((audio.shape[0],), audio.shape[1], device=dev))
    hyps = [r.tokens for r in results]
    scores = np.array([r.score for r in results])
    card = np.abs(rescore(model, enc, hyps, limit) / scores - 1)
    cpu = abs(rescore(cpu_model, enc_cpu, hyps[:1], limit)[0] / scores[0] - 1)
    print(f"phase 53 beam-20 slice: whisper-small+adapters bf16, 8 x 15 s, beam {BEAM20}, "
          f"maxlenratio 0 (self cache {pad_time(limit + 1)} positions), {steps[0]} decode "
          f"steps, loop scan: {ms:.1f} ms/batch (one request after a warm-up), "
          f"{120.0 / (ms / 1e3):.1f} x realtime; launches {launches}; profile: device busy "
          f"{busy:.1f} ms in {n_events} events, busy {busy / ms:.1%} idle {1 - busy / ms:.1%} of "
          f"the timed request; K3a {k3a:.2f} ms, K3s {k3s:.2f} ms; reported score vs "
          f"teacher-forced rescore (rel, max over 8) card {card.max():.2e}, cpu f32 (utt 0) "
          f"{cpu:.2e} (bounds {RESCORE_REL}); lengths {[len(h) for h in hyps]}; top: "
          + top_kernels(per_name, 6), flush=True)
    check(card.max() <= RESCORE_REL["card"] and cpu <= RESCORE_REL["cpu"],
          f"phase 53 rescore rel card {card.max()} cpu {cpu} within {RESCORE_REL}")
    return {"launches": launches, "ms": ms, "busy_ms": busy, "steps": steps[0]}


# Phase 54: the conformer recipe's decoder (6 blocks, bf16) and LM (16
# blocks, float32) one step at a time at pos 8185-8200 over 10 rows, the
# caches sized as `joint_beam_decode` sizes them for 65600 steps (65601 ->
# 65616 positions: blocks of 8202 and 9374 keys, past the short route's
# table of 8192; 4.0 + 43.0 GB), rows 0-8184 drawn on the card; 2 + 2 blocks
# of each against the CPU in float32 on the same caches, one step at pos
# 8201.
LONG_ROWS, LONG_STEPS, LONG_POS0 = 10, 65600, 8185
LONG_LM_REL_L2 = 1e-4  # float32 on both sides: summation order


def first_blocks(sd: dict, n: int) -> dict:
    """A state dict without the blocks from index n on (every `blocks.i.`)."""
    return {k: v for k, v in sd.items()
            if not (m := re.search(r"(?:^|\.)blocks\.(\d+)\.", k)) or int(m.group(1)) < n}


def long_decode_phase(dev) -> dict:
    """Phase 54: the long route on its path. The recipe's
    `transformer_decode_step` and `lm_score_step_cached` at full depth on
    the card from pos LONG_POS0 for 16 steps: every self-attention takes
    the long route (6 + 16 launches a step exactly, counted by model,
    nothing else), finite
    outputs; then 2 + 2 blocks on the card against the CPU in float32 on
    copies of the same caches (the decoder within CONF_REL_L2, the
    float32 LM within LONG_LM_REL_L2)."""
    from agacs_tpu_torch.models import conformer as tconf, lm as tlm
    from agacs_tpu_torch.ops import decode_attn as da

    model, lm, sd, lsd = conformer_models(dev, torch.bfloat16)
    dec, total = model.decoder, LONG_STEPS + 1
    gen = torch.Generator(device=dev).manual_seed(54)
    kv = tconf.init_decoder_kv_cache(dec.cfg, LONG_ROWS, total, device=dev)
    lkv = tlm.init_lm_kv_cache(lm.cfg, LONG_ROWS, total, device=dev)
    for bufs in (*kv.values(), *lkv.values()):
        for b in bufs:
            b[:, :LONG_POS0] = (torch.randn(b.shape[0], LONG_POS0, b.shape[2], generator=gen,
                                            device=dev) * 0.5).to(b.dtype)
    for bufs, h in ((kv, dec.cfg.attention_heads), (lkv, lm.cfg.attention_heads)):
        route = da.plan("rows", LONG_ROWS, h, bufs["k"][0])
        check(route[0] == "long", f"phase 54: caches of {bufs['k'][0].shape} take the long "
              f"route ({route})")
    mem = (torch.randn(LONG_ROWS, 468, CD, generator=gen, device=dev)).to(torch.bfloat16)
    mlens = torch.full((LONG_ROWS,), 468, device=dev)
    tokens = torch.randint(0, dec.cfg.vocab_size, (LONG_ROWS, 18), generator=gen, device=dev)
    with torch.inference_mode():
        cross = tconf.precompute_decoder_cross_kv(dec, mem)
        by_model = {"decoder": 0, "LM": 0}
        reset_decode_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, pos in enumerate(range(LONG_POS0, LONG_POS0 + 16)):
            before = da.LONG_LAUNCHES
            logits, kv = tconf.transformer_decode_step(dec, tokens[:, i], pos, kv, cross, mlens)
            by_model["decoder"] += da.LONG_LAUNCHES - before
            before = da.LONG_LAUNCHES
            lp, lkv = tlm.lm_score_step_cached(lm, tokens[:, i], pos, lkv)
            by_model["LM"] += da.LONG_LAUNCHES - before
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / 16
    launches = {k: v for k, v in decode_counts().items() if v}
    want = {"K3-long": 16 * (dec.cfg.num_blocks + lm.cfg.num_blocks)}
    check(launches == want and by_model == {"decoder": 16 * dec.cfg.num_blocks,
                                            "LM": 16 * lm.cfg.num_blocks},
          f"phase 54 launches {launches} == {want}, by model {by_model}")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(lp).all()),
          "phase 54: finite logits and LM log-probs")
    # 2 + 2 blocks, card and CPU, on the first two layers' caches as they stand
    raw2 = conformer_raw(enc_num_blocks=1, dec_num_blocks=2)
    sd2 = {k: v for k, v in first_blocks(sd, 2).items() if not k.startswith("encoder.blocks.")
           or k.startswith("encoder.blocks.0.")}
    errs = {}
    tok, pos = tokens[:, 16], LONG_POS0 + 16
    outs = []
    for d in (dev, "cpu"):
        m2, lm2, _, _ = conformer_models(d, torch.bfloat16 if d == dev else torch.float32, sd2,
                                         first_blocks(lsd, 2), lm_blocks=2, raw=raw2)
        f32 = (lambda t: t.float().cpu()) if d == "cpu" else (lambda t: t.clone())
        kv2 = {n: tuple(f32(b) for b in bufs[:2]) for n, bufs in kv.items()}
        lkv2 = {n: tuple(b.clone().to(d) for b in bufs[:2]) for n, bufs in lkv.items()}
        with torch.inference_mode():
            c2 = tconf.precompute_decoder_cross_kv(m2.decoder, mem.to(d))
            lo, _ = tconf.transformer_decode_step(m2.decoder, tok.to(d), pos, kv2, c2,
                                                  mlens.to(d))
            ll, _ = tlm.lm_score_step_cached(lm2, tok.to(d), pos, lkv2)
        outs.append((lo.float().cpu(), ll.float().cpu()))
    (lo_g, ll_g), (lo_c, ll_c) = outs
    errs = {"decoder": rel_l2(lo_g, lo_c), "lm": rel_l2(ll_g, ll_c)}
    print(f"phase 54 long route on the conformer recipe's decode step: decoder 6 x 256 bf16 + "
          f"LM 16 x 512 f32, {LONG_ROWS} rows over caches of {total} -> "
          f"{kv['k'][0].shape[1]} positions, pos {LONG_POS0}-{LONG_POS0 + 15}: "
          f"{ms_step:.2f} ms a step (both models, host clock); launches {launches} "
          f"({by_model}); 2 + 2 "
          f"blocks card vs cpu f32 at pos {pos}: decoder logits rel L2 {errs['decoder']:.3e} "
          f"(bound {CONF_REL_L2}), LM log-probs rel L2 {errs['lm']:.3e} (bound "
          f"{LONG_LM_REL_L2})", flush=True)
    check(errs["decoder"] <= CONF_REL_L2 and errs["lm"] <= LONG_LM_REL_L2,
          f"phase 54 card vs cpu {errs}")
    del model, lm, kv, lkv
    torch.cuda.empty_cache()
    return {"launches": launches, "by_model": by_model, "ms_step": ms_step}


# Phase 55: a whisper decoder at whisper-small's width with 6 heads of 128
# (the one configuration whose decode step takes the whisper-only forms
# at another width): PE on, int8 cross-KV, beam 5 over 2 utterances, 5
# steps; its encoder is cut to one layer (the step reads random encoder
# output).
H128 = dict(n_text_head=6, pe_attention=True, cross_kv_int8=True, n_audio_layer=1)


def heads128_phase(dev) -> dict:
    """Phase 55: whisper_decode_step at beam 5 on the H128 decoder (12
    layers, d 768, random weights from torch seed 55), card bf16 against
    CPU float32 on the same weights, the same int8 cross-KV and scales
    (made on the card) and the same ancestry map, shuffled between steps:
    logits rel L2 within LOGITS_REL_L2 each step; launches K3a-PE (the
    forms entry at d_head 128) and K3s-int8 (the tensor cores at d_head
    128) 12 a step each, nothing else."""
    from agacs_tpu_torch.models import whisper as tw

    b, beam, tp, steps = 2, BEAM, 112, 5
    n = b * beam
    sd = tw.init_whisper_params(torch.Generator().manual_seed(55), tw.make_config("small",
                                                                                  **H128))
    models = {d: tw.Whisper.from_state_dict(tw.make_config("small", compute_dtype=dt, **H128), sd,
                                            device=d)
              for d, dt in ((dev, torch.bfloat16), ("cpu", torch.float32))}
    gen = torch.Generator(device=dev).manual_seed(55)
    enc = torch.randn(b, 1500, D, generator=gen, device=dev).to(torch.bfloat16)
    toks = torch.randint(0, 50257, (n, steps), generator=gen, device=dev)
    perm = torch.tensor([g * beam + (i + 1) % beam for g in range(b) for i in range(beam)])
    with torch.inference_mode():
        cross_g = tw.precompute_cross_kv(models[dev], enc)
    cross_c = {k: (tuple(x.cpu() for x in v) if isinstance(v, (tuple, list)) else v)
               for k, v in cross_g.items()}
    kvs = {d: tw.init_self_kv_cache(models[d].cfg, n, tp, device=d, ancestry=True)
           for d in (dev, "cpu")}
    reset_decode_counts()
    errs = []
    with torch.inference_mode():
        for p in range(steps):
            outs = {}
            for d, cross in ((dev, cross_g), ("cpu", cross_c)):
                outs[d], kvs[d] = tw.whisper_decode_step(models[d], toks[:, p].to(d), p, kvs[d],
                                                         cross, beam_groups=beam)
                kvs[d]["anc"] = kvs[d]["anc"][:, perm.to(d)]
            errs.append(rel_l2(outs[dev].float().cpu(), outs["cpu"]))
    launches = {k: v for k, v in decode_counts().items() if v}
    per = models[dev].cfg.n_text_layer * steps
    check(launches == {"K3a-PE": per, "K3s-int8": per},
          f"phase 55 launches {launches} == K3a-PE and K3s-int8 {per}")
    print(f"phase 55 whisper decoder at d 768 with 6 heads of 128, PE, int8 cross-KV: beam "
          f"{beam} x {b} utterances, {steps} steps, card bf16 vs cpu f32 logits rel L2 "
          f"{[f'{e:.3e}' for e in errs]} (bound {LOGITS_REL_L2}); launches {launches}",
          flush=True)
    check(all(e <= LOGITS_REL_L2 for e in errs), f"phase 55 logits rel L2 {errs}")
    del models
    torch.cuda.empty_cache()
    return {"launches": launches}




KERNEL_CHECKS = {"k1": check_k1, "k1b": check_k1_train, "k2": check_k2, "k3": check_k3,
                 "k3a": check_k3a, "k3s": check_k3s, "k3f32": check_k3f32, "k3pe": check_k3pe,
                 "k3i8": check_k3i8, "k3d48": check_k3_d48, "k4": check_k4, "k5": check_k5,
                 "k5b": check_k5_bwd, "k6": check_k6, "k8": check_k8, "k8q": check_k8q,
                 "k3w": check_k3_widths, "k3long": check_k3_long, "k3sw": check_k3s_wide,
                 "k3forms": check_k3_forms}


def mutants(dev, only=()) -> None:
    """Each MUTANTS entry (those whose name contains a word of `only`, and
    the unmutated source, when it is given): copy csrc/ to a temp dir,
    apply the edit, build there, run its checks (timed=False) and print
    whether each fails."""
    import shutil
    import tempfile
    from pathlib import Path

    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.ops import cuda_lib

    unknown = {c for _, _, cs in MUTANTS.values() for c in cs} - set(KERNEL_CHECKS) - {"p15"}
    if unknown:
        raise ValueError(f"MUTANTS name unknown checks {sorted(unknown)}")
    src, build, state, lost = cuda_lib.CSRC, cuda_lib.BUILD_DIR, {}, False
    chosen = {name for name, (_, edits, _) in MUTANTS.items()
              if not only or any(word in name for word in only)}
    for name, (fname, edits, checks) in MUTANTS.items():
        if not edits and only:  # the unmutated source: the chosen mutants' checks
            checks = sorted({c for m in chosen for c in MUTANTS[m][2]})
        elif name not in chosen:
            continue
        tmp = Path(tempfile.mkdtemp(prefix="agacs_mutant_"))
        for f in [*src.glob("*.cu"), *src.glob("*.cuh")]:
            shutil.copy(f, tmp / f.name)
        text = (tmp / fname).read_text()
        for old, new in edits:
            check(old in text, f"mutant {name!r}: {old!r} is in {fname}")
            text = text.replace(old, new, 1)
        (tmp / fname).write_text(text)
        cuda_lib.CSRC, cuda_lib.BUILD_DIR = tmp, tmp / "build"
        cuda_lib._LIBS.clear()
        cuda_lib._FNS.clear()
        for chk in checks:
            g = torch.Generator().manual_seed(0)
            try:
                if chk == "p15":
                    if not state:
                        cfg = tw.make_config("small", adapter=True, adapter_encoder=True,
                                             adapter_decoder=True)
                        sd = tw.init_whisper_params(torch.Generator().manual_seed(0), cfg)
                        state.update(sd8=int8_state(sd, dev),
                                     batch=make_train_batch(TRAIN_B, TRAIN_S, dev))
                    int8_train_parity(state["sd8"], dev, state["batch"], float("nan"))
                else:
                    KERNEL_CHECKS[chk](dev, g, timed=False)
                print(f"MUTANT [{name}] {chk}: passes", flush=True)
            except RuntimeError as e:
                print(f"MUTANT [{name}] {chk}: FAILS: {str(e)[:300]}", flush=True)
            try:
                torch.cuda.synchronize()
            except RuntimeError:  # a trapped kernel: the process's CUDA context is lost
                print(f"MUTANT [{name}]: the CUDA context is lost; no later check can run "
                      "in this process", flush=True)
                lost = True
                break
        shutil.rmtree(tmp, ignore_errors=True)
        if lost:
            left = [m for m in list(MUTANTS)[list(MUTANTS).index(name) + 1:] if m in chosen]
            if left:  # the chosen mutants after it, in a new process
                subprocess.run([sys.executable, __file__, "--mutants", *left], check=False)
            break
    cuda_lib.CSRC, cuda_lib.BUILD_DIR = src, build
    cuda_lib._LIBS.clear()
    cuda_lib._FNS.clear()


def demangled_kernel(mangled: str) -> str:
    """The identifier of a mangled `..._kernel(...)` name: the part of it
    that a length prefix of the mangling (the digits before it) spans, with
    the bool and int literals of its template arguments when it has them
    (those of a class argument too: K5's K<128, 1>, 2 shows as <128, 1, 2>;
    a kernel's parameter types hold none)."""
    m = re.search(r"\w+?_kernel(?=E|I)", mangled)
    s = m.group(0) if m else mangled
    args = template_args(mangled[m.end():]) if m else None
    if args is None:
        args = [("false", "true")[int(v)] if t == "b" else v
                for t, v in re.findall(r"L([bi])(\d+)E", mangled[m.end():])] if m else []
    tmpl = "<" + ", ".join(args) + ">" if args else ""
    for j in range(1, len(s)):
        if s[j - 1].isdigit() and not s[j].isdigit():
            digits = re.search(r"\d+$", s[:j]).group()
            if any(int(digits[i:]) == len(s) - j for i in range(len(digits))):
                return s[j:] + tmpl
    return s + tmpl


def template_args(s: str) -> list[str] | None:
    """The template arguments of a mangled name from its `I`: bool and int
    literals, and the types bf16, int8 and float (K3's instances differ in
    their cache type); None for anything else (a class argument)."""
    if not s.startswith("I"):
        return []
    out, i = [], 1
    types = {"13__nv_bfloat16": "bf16", "a": "int8", "f": "float"}
    while i < len(s) and s[i] != "E":
        if m := re.match(r"L([bi])(\d+)E", s[i:]):
            out.append(("false", "true")[int(m.group(2))] if m.group(1) == "b" else m.group(2))
        elif m := re.match(r"13__nv_bfloat16|[af](?=[LE]|13)", s[i:]):
            out.append(types[m.group(0)])
        else:
            return None
        i += m.end()
    return out


def ptxas_entries(log: str) -> str:
    """Each kernel of an `nvcc -Xptxas -v` log with its registers and spill
    bytes, or 'cached build' when the log is empty."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = demangled_kernel(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spill {m.group(1)}/{m.group(2)} bytes (stores/loads)"
        elif m := re.search(r"Used (\d+) registers", line):
            out.append(f"{name} {m.group(1)} registers, {spill}")
    return ", ".join(out) or "cached build"


def cli_data(root: str) -> tuple[str, int]:
    """A data dir of 6 utterances of 4-5 s of seeded noise under `root`
    (emptied first): (its path, the utterance count)."""
    import shutil
    import wave

    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    os.makedirs(data)
    rng = np.random.RandomState(3)
    texts = ["我们 go", "hello 你好", "好 ok", "去 shop", "that 是 right", "走 了 bye"]
    with open(os.path.join(data, "wav.scp"), "w") as scp, \
            open(os.path.join(data, "text"), "w") as txt:
        for i, t in enumerate(texts):
            path = os.path.join(data, f"u{i}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((rng.randn(64000 + 4000 * (i % 3)) * 3000).astype(np.int16)
                              .tobytes())
            scp.write(f"u{i} {path}\n")
            txt.write(f"u{i} {t}\n")
    return data, len(texts)


def cli_phase() -> dict:
    """Phase 17: bin.train with freeze_quant=int8, then bin.decode on its
    checkpoint, both on the card, on `cli_data`'s generated data dir under
    build/ (removed afterwards)."""
    import shutil

    from agacs_tpu_torch.bin import decode, train

    root = os.path.join(ROOT, "build", "chip_smoke_cli")
    data, n_utts = cli_data(root)
    exp = os.path.join(root, "exp")
    conf = os.path.join(ROOT, "recipes", "seame", "conf",
                        "train_asr_whisper_small_adapter_csloss_2stage.yaml")
    t0 = time.perf_counter()
    reset_int8_counts()
    out = train.main(["--config", conf, "--train_dir", data, "--valid_dir", data,
                      "--exp_dir", exp, "--max_epoch", "1", "--batch_bins", "150000",
                      "--override", "freeze_quant=int8", "accum_grad=1",
                      "keep_nbest_models=1"])
    train_launches, train_s = int8_counts(), time.perf_counter() - t0
    with np.load(out["ave"]) as ave:
        check(ave["encoder/blocks/mlp/fc1/w_q"].dtype == np.int8
              and ave["decoder/blocks/attn/query/w_s"].dtype == np.float32,
              "the int8 CLI's checkpoint holds int8 w_q and float32 w_s")
    t0 = time.perf_counter()
    reset_int8_counts()
    res = decode.main(["--config", os.path.join(exp, "config.yaml"), "--params", out["ave"],
                       "--data_dir", data, "--output_dir", os.path.join(root, "dec"),
                       "--max_steps", "8"])
    decode_launches, decode_s = int8_counts(), time.perf_counter() - t0
    check(set(res["hyps"]) == {f"u{i}" for i in range(n_utts)}
          and os.path.exists(os.path.join(root, "dec", "hyp.trn")),
          "bin.decode wrote a hypothesis for every utterance")
    check(all(c["K2f"] > 0 and c["K8g"] > 0 for c in (train_launches, decode_launches))
          and train_launches["K2b"] > 0, f"the CLIs ran K2 and K8: {train_launches} "
          f"{decode_launches}")
    loss = out["history"][1]["train"]["loss"]
    check(np.isfinite(loss), f"finite CLI train loss {loss}")
    print(f"phase 17 int8 CLIs on the card: bin.train (whisper-small, freeze_quant=int8, "
          f"1 epoch, 6 utterances) {train_s:.1f} s, loss {loss:.3f}, launches "
          f"{train_launches}; bin.decode {decode_s:.1f} s, launches {decode_launches}; "
          f"hyps {sorted(res['hyps'].items())[:2]}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"train": train_launches, "decode": decode_launches}


def pe_cli_phase() -> dict:
    """Phase 24: bin.train on the TMECS pedecoder_csloss recipe (PE in the
    decoder, preset freeze_decoder_pe: the whole encoder and the decoder's
    query_cs / key_cs train, so K1f and K1b run) for one epoch on
    `cli_data`'s data dir, then bin.decode on its n-best average, greedy
    (K3-PE, K3) and with --cross_kv_int8 (K3-PE, K3-int8), all on the card."""
    import shutil

    from agacs_tpu_torch.bin import decode, train
    from agacs_tpu_torch.ops import flash_train

    root = os.path.join(ROOT, "build", "chip_smoke_cli_pe")
    data, n_utts = cli_data(root)
    exp = os.path.join(root, "exp")
    conf = os.path.join(ROOT, "recipes", "tmecs", "conf",
                        "train_asr_whisper_small_pedecoder_csloss.yaml")
    t0 = time.perf_counter()
    reset_decode_counts()
    flash_train.BWD_LAUNCHES = 0
    out = train.main(["--config", conf, "--train_dir", data, "--valid_dir", data,
                      "--exp_dir", exp, "--max_epoch", "1", "--batch_bins", "150000",
                      "--override", "accum_grad=1", "keep_nbest_models=1"])
    train_s = time.perf_counter() - t0
    train_launches = {"K1f": flash_train.LAUNCHES, "K1b": flash_train.BWD_LAUNCHES}
    with np.load(out["ave"]) as ave:
        check("decoder/blocks/attn/query_cs/w" in ave.files
              and "decoder/blocks/attn/gate" in ave.files
              and "encoder/blocks/attn/query_cs/w" not in ave.files,
              "the PE CLI's checkpoint holds the decoder's PE leaves")
    loss = out["history"][1]["train"]["loss"]
    check(np.isfinite(loss) and out["history"][1]["train"]["loss_cs"] > 0
          and train_launches["K1b"] > 0, f"PE CLI train: loss {loss}, {train_launches}")
    decodes = {}
    for name, flags in (("greedy", []), ("cross_kv_int8", ["--cross_kv_int8"])):
        reset_decode_counts()
        t0 = time.perf_counter()
        res = decode.main(["--config", os.path.join(exp, "config.yaml"), "--params",
                           out["ave"], "--data_dir", data, "--output_dir",
                           os.path.join(root, name), "--max_steps", "8", *flags])
        counts = {k: v for k, v in decode_counts().items() if v}
        decodes[name] = (time.perf_counter() - t0, counts)
        check(set(res["hyps"]) == {f"u{i}" for i in range(n_utts)},
              f"PE bin.decode {name} wrote a hypothesis for every utterance")
        cross = "K3-int8" if flags else "K3"
        check(counts.get("K3-PE", 0) > 0 and counts.get(cross, 0) == counts["K3-PE"]
              and set(counts) == {"K1f", "K3-PE", cross},
              f"PE bin.decode {name} launches {counts}")
    print(f"phase 24 PE CLIs on the card: bin.train (TMECS pedecoder_csloss, "
          f"whisper-small, 1 epoch, {n_utts} utterances) {train_s:.1f} s, loss {loss:.3f}, "
          f"launches {train_launches}; bin.decode "
          + "; ".join(f"{k} {t:.1f} s, launches {c}" for k, (t, c) in decodes.items()),
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"train": train_launches, "decode": {k: c for k, (_, c) in decodes.items()}}


SEAME_ROWS = {  # (audio type, recording): phaseII rows (start ms, end ms, text)
    ("conversation", "NC01FBX_0101"): [(500, 2500, "我们 go to school 了"),
                                       (3000, 5200, "okay 那个 project 很难"),
                                       (5500, 7500, "(ppl) 好 的 thanks")],
    ("conversation", "NC02MAY_0101"): [(200, 2000, "today 我 很 busy"),
                                       (2500, 4400, "没有 problem lah"),
                                       (5000, 7000, "he 说 tomorrow 再 来")],
    ("interview", "NI01MAX_0101"): [(100, 2100, "interview 开始 了"),
                                    (2600, 4600, "my name is 小明"),
                                    (5100, 7100, "谢谢 everyone")],
}
SEAME_DEV = {"train/wav_file.txt": ["data/conversation/NC01FBX_0101/audio.wav",
                                    "data/conversation/NC02MAY_0101/audio.wav"],
             "dev_man/text": ["ni01m-ni01max_0101-00010-00210 interview text",
                              "ni01m-ni01max_0101-00260-00460 more text"],
             "dev_sge/text": ["ni01m-ni01max_0101-00510-00710 third utt"]}
SEAME_SPLITS = ("train", "valid", "devman", "devsge")
PREFETCH_BINS = 100000  # phase 40's batch_bins: batches of 2, 2 and 1 utterances
PREFETCH_PASSES = 2  # passes over those batches a prefetch turn


def seame_corpus(root: str) -> tuple[str, str]:
    """A SEAME-layout corpus under `root` (three 8 s FLAC recordings of a
    tone and seeded noise, phaseII transcripts with ms timestamps) and a
    SEAME-dev-set repo (the train recordings, dev_man and dev_sge ids):
    (corpus dir, repo dir). prepare_seame --num_val 1 splits it 5 train, 1
    valid, 2 devman, 1 devsge."""
    from agacs_tpu_torch.data.flac import write_flac

    corpus, repo = os.path.join(root, "SEAME"), os.path.join(root, "SEAME-dev-set")
    t = np.arange(8 * 16000) / 16000
    for i, ((atp, rec), rows) in enumerate(SEAME_ROWS.items()):
        noise = np.random.RandomState(i).randn(len(t))
        write_flac(os.path.join(corpus, atp, "audio", f"{rec}.flac"),
                   (0.2 * np.sin(2 * np.pi * (220 + 40 * i) * t) + 0.01 * noise)
                   .astype(np.float32))
        tdir = os.path.join(corpus, atp, "transcript", "phaseII")
        os.makedirs(tdir, exist_ok=True)
        with open(os.path.join(tdir, f"{rec}.txt"), "w", encoding="utf-8") as f:
            f.writelines(f"{rec}\t{a}\t{b}\tCS\t{text}\n" for a, b, text in rows)
    for sub, lines in SEAME_DEV.items():
        os.makedirs(os.path.dirname(os.path.join(repo, sub)), exist_ok=True)
        with open(os.path.join(repo, sub), "w") as f:
            f.writelines(line + "\n" for line in lines)
    return corpus, repo


def seame_recipe_phase(smi: str) -> dict:
    """Phase 39: recipes/seame/run.sh stages 0-6 through the port's CLIs on
    the card (`smi`: its nvidia-smi name and power limit), under
    build/chip_smoke_seame/ (removed afterwards)."""
    import shutil

    from agacs_tpu_torch.bin import decode, format_data, pack, prepare_seame, score, train
    from agacs_tpu_torch.data.io import read_scp
    from agacs_tpu_torch.data.kaldi_ark import read_ark_audio
    from agacs_tpu_torch.data.perturb import perturb_data_dir
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.ops import decode_attn, flash_train

    root = os.path.join(ROOT, "build", "chip_smoke_seame")
    shutil.rmtree(root, ignore_errors=True)
    data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
    conf = os.path.join(ROOT, "recipes", "seame", "conf")
    secs, counts = {}, {}

    def stage(name, fn):
        flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = decode_attn.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts[name] = {k: v for k, v in (("K1f", flash_train.LAUNCHES),
                                          ("K1b", flash_train.BWD_LAUNCHES),
                                          ("K3", decode_attn.LAUNCHES)) if v}
        return out

    def prep():
        corpus, repo = seame_corpus(root)
        prepare_seame.main(["--data", corpus, "--repo", repo, "--out", f"{data}/prep",
                            "--num_val", "1"])
        for split in SEAME_SPLITS:
            format_data.main(["--data_dir", f"{data}/prep/{split}", "--outdir",
                              f"{data}/{split}", "--audio_format", "flac.ark"])
        cfg = tw.make_config("small")  # OpenAI's layout: no adapters, float16
        sd = tw.init_whisper_params(torch.Generator().manual_seed(0), cfg)
        torch.save({"dims": {k: getattr(cfg, k) for k in (
            "n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
            "n_vocab", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")},
            "model_state_dict": {k: v.half() for k, v in sd.items()}}, f"{root}/small.pt")
        return len(sd)

    n_pt = stage("stage 0 prep + format flac.ark + .pt", prep)
    entries = {split: read_scp(f"{data}/{split}/wav.scp") for split in SEAME_SPLITS}
    check(all(":" in v for e in entries.values() for v in e.values())
          and [len(entries[s]) for s in SEAME_SPLITS] == [5, 1, 2, 1],
          f"stage 0 wrote flac.ark dirs of 5/1/2/1 utterances: {entries}")
    same = all(np.array_equal(read_ark_audio(v)[0], read_ark_audio(v, native=False)[0])
               for e in entries.values() for v in e.values())
    check(same, "the ark waveforms read by the native codec are bit-identical to the plain "
          "Python FLAC decoder's")
    stage("stage 1 perturb", lambda: perturb_data_dir(f"{data}/train", f"{data}/train_sp"))
    check(len(read_scp(f"{data}/train_sp/wav.scp")) == 15, "train_sp holds 3 x 5 utterances")
    common = ["--train_dir", f"{data}/train_sp", "--valid_dir", f"{data}/valid",
              "--max_epoch", "1", "--override", "accum_grad=1", "keep_nbest_models=1"]
    st1 = stage("stage 2 train (adapter_encoder, --init_param .pt)", lambda: train.main([
        "--config", f"{conf}/train_asr_whisper_small_adapter_encoder.yaml",
        "--exp_dir", f"{exp}/stage1", "--init_param", f"{root}/small.pt", *common]))
    check(len(st1["init_loaded"]) == n_pt, f"the .pt loaded all {n_pt} of its leaves "
          f"({len(st1['init_loaded'])})")
    st2 = stage("stage 4 train (csloss_2stage)", lambda: train.main([
        "--config", f"{conf}/train_asr_whisper_small_adapter_csloss_2stage.yaml",
        "--exp_dir", f"{exp}/stage2", "--init_param", st1["ave"], *common]))
    losses = [st["history"][1]["train"]["loss"] for st in (st1, st2)]
    check(all(np.isfinite(losses)) and st2["history"][1]["train"]["loss_cs"] > 0,
          f"finite losses of both trainings {losses}")
    for name in list(counts):
        if "train" in name:
            check(counts[name].get("K1f", 0) > 0 and counts[name].get("K1b", 0) > 0,
                  f"{name} launched K1f and K1b: {counts[name]}")
    model_file = os.path.join(exp, "stage2", "valid.acc.ave.params.npz")
    config_file = os.path.join(exp, "stage2", "config.yaml")
    for split in ("devman", "devsge"):
        out = os.path.join(exp, "stage2", f"decode_{split}")
        res = stage(f"stage 5 decode {split}", lambda: decode.main([
            "--config", config_file, "--decode_config", f"{conf}/decode_asr_whisper.yaml",
            "--params", model_file, "--data_dir", f"{data}/{split}", "--output_dir", out,
            "--max_steps", "8"]))
        check(set(res["hyps"]) == set(entries[split]) and counts[f"stage 5 decode {split}"]
              .get("K3", 0) > 0, f"{split}: a hypothesis for every utterance, K3 launched: "
              f"{res['hyps']} {counts[f'stage 5 decode {split}']}")
        score.main(["--ref", f"{out}/ref.trn", "--hyp", f"{out}/hyp.trn", "--output_dir",
                    f"{out}/score"])

    def pack_unpack():
        archive = os.path.join(exp, "stage2", "packed_model.tgz")
        pack.main(["pack", "--train_config", config_file, "--model_file", model_file,
                   "--option", os.path.join(exp, "stage2", "train_history.json"),
                   "--outpath", archive])
        return pack.main(["unpack", "--archive", archive, "--outdir", f"{root}/unpacked"])

    unpacked = stage("stage 6 pack + unpack", pack_unpack)
    check(open(unpacked["asr_train_config"], "rb").read() == open(config_file, "rb").read()
          and open(unpacked["asr_model_file"], "rb").read() == open(model_file, "rb").read(),
          f"the unpacked archive names the config and model decode read: {unpacked}")
    print(f"phase 39 SEAME run.sh stages 0-6 through the port's CLIs on {smi} (whisper-small, "
          f"{sum(len(e) for e in entries.values())} flac.ark utterances): "
          + "; ".join(f"{k} {secs[k]:.1f} s {counts[k]}" for k in secs)
          + f"; losses {[round(x, 3) for x in losses]}; .pt leaves loaded "
          f"{len(st1['init_loaded'])}/{n_pt}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"seconds": secs, "launches": counts}


def options_data(root: str) -> str:
    """`seame_corpus`'s train and valid splits as flac.ark data dirs under
    root/data (5 and 1 utterances of 1.8-2.2 s), and one RIR and one noise
    WAV from a seed with their scp files: the data dir's parent."""
    from agacs_tpu_torch.bin import format_data, prepare_seame
    from agacs_tpu_torch.data.io import write_wav

    corpus, repo = seame_corpus(root)
    data = os.path.join(root, "data")
    prepare_seame.main(["--data", corpus, "--repo", repo, "--out", f"{data}/prep",
                        "--num_val", "1"])
    for split in ("train", "valid"):
        format_data.main(["--data_dir", f"{data}/prep/{split}", "--outdir",
                          f"{data}/{split}", "--audio_format", "flac.ark"])
    rng = np.random.RandomState(40)
    write_wav(f"{root}/rir.wav", (np.exp(-np.arange(4000) / 600.0) * rng.randn(4000) * 0.5)
              .astype(np.float32))
    write_wav(f"{root}/noise.wav", (rng.randn(64000) * 0.05).astype(np.float32))
    for kind in ("rir", "noise"):
        with open(f"{root}/{kind}.scp", "w") as f:
            f.write(f"{kind}0 {root}/{kind}.wav\n")
    return data


def train_counts() -> dict:
    from agacs_tpu_torch.ops import flash_train, int8_linear

    return {"K1f": flash_train.LAUNCHES, "K1b": flash_train.BWD_LAUNCHES,
            **int8_counts(), "K8 thin": int8_linear.THIN_LAUNCHES}


def reset_train_counts() -> None:
    from agacs_tpu_torch.ops import flash_train

    flash_train.LAUNCHES = flash_train.BWD_LAUNCHES = 0
    reset_int8_counts()


def prefetch_turns(sd, dev, train_dir: str) -> dict:
    """Phase 40c: the bf16 adapter step over `train_dir`'s batches, built as
    the train CLI builds them, with the prefetch threads on and inline, in
    turns (on, off, on, off), PREFETCH_PASSES passes over the batches a
    turn: wall ms a step (median of the two turns); then one profiled pass
    of each for device busy ms a step and the idle share."""
    from agacs_tpu_torch.bin import train as train_cli
    from agacs_tpu_torch.data.dataset import ASRDataset
    from agacs_tpu_torch.data.prefetch import HostToDevice, prefetch_batches
    from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step
    from agacs_tpu_torch.utils.config import trainer_config_from_dict

    ds = ASRDataset(train_dir)
    sample_epoch, s_pad_of = train_cli.batch_sampler("numel", trainer_config_from_dict({}),
                                                     PREFETCH_BINS)
    ids = sample_epoch(ds, {u: ds.num_samples(u) for u in ds.utt_ids}) * PREFETCH_PASSES
    model, params, asr_cfg = train_model(sd, dev, torch.bfloat16, specaug=True)
    opt, sched = build_optimizer(params, OptimConfig())
    step = make_train_step(model, asr_cfg, opt, sched,
                           generator=torch.Generator().manual_seed(0))
    feeder = HostToDevice(dev)

    def epoch(prefetch: bool) -> None:
        def make(utts):
            return train_cli.make_batch(ds, utts, s_pad_of, feeder)

        made = (prefetch_batches(make, ids, lookahead=train_cli.LOOKAHEAD) if prefetch
                else (make(utts) for utts in ids))
        for m in made:
            stats = step([feeder.ready(m)])
            [float(v) for v in stats.values()]  # the CLI's read of the stats
        torch.cuda.synchronize()

    epoch(True)  # warm-up
    wall = {True: [], False: []}
    for prefetch in (True, False, True, False):
        t0 = time.perf_counter()
        epoch(prefetch)
        wall[prefetch].append((time.perf_counter() - t0) * 1e3 / len(ids))
    out = {}
    for prefetch in (True, False):
        busy = device_profile(lambda: epoch(prefetch))[0] / len(ids)
        ms = statistics.median(wall[prefetch])
        out["on" if prefetch else "off"] = {"wall_ms": ms, "turns": wall[prefetch],
                                            "busy_ms": busy, "idle": 1 - busy / ms}
    del model, opt
    torch.cuda.empty_cache()
    return {"steps": len(ids), "batch_sizes": sorted({len(u) for u in ids}), **out}


def trainer_options_phase(sd, dev, smi: str) -> dict:
    """Phase 40: the train CLI's options on the card at whisper-small's full
    width (stage-2 recipe), under build/chip_smoke_options/ (removed
    afterwards). `sd` is phase 4's whisper-small + adapters state dict (40c)."""
    import shutil

    from agacs_tpu_torch.bin import train
    from agacs_tpu_torch.train.observability import read_event_file

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_options")
    shutil.rmtree(root, ignore_errors=True)
    data = options_data(root)
    conf = os.path.join(ROOT, "recipes", "seame", "conf",
                        "train_asr_whisper_small_adapter_csloss_2stage.yaml")
    secs, counts = {}, {}

    def run(name, exp, epochs, flags=(), overrides=()):
        reset_train_counts()
        t0 = time.perf_counter()
        out = train.main(["--config", conf, "--train_dir", f"{data}/train", "--valid_dir",
                          f"{data}/valid", "--exp_dir", f"{root}/{exp}", "--max_epoch",
                          str(epochs), "--batch_bins", str(PREFETCH_BINS), *flags,
                          "--override", "accum_grad=1", "keep_nbest_models=1", *overrides])
        torch.cuda.synchronize()
        secs[name], counts[name] = time.perf_counter() - t0, train_counts()
        return out

    # (a) resume on the int8 trunk
    print("phase 40a: --resume on the int8 trunk (freeze_quant=int8): 2 epochs against 1 "
          "epoch resumed to 2", flush=True)
    int8 = ["freeze_quant=int8"]
    whole = run("int8 2 epochs", "whole", 2, ["--num_att_plot", "0"], int8)
    run("int8 1 epoch", "cut", 1, ["--num_att_plot", "0"], int8)
    resumed = run("int8 --resume to 2", "cut", 2, ["--resume", "--num_att_plot", "0"], int8)
    for name in ("checkpoint.params.npz", "checkpoint.opt.npz"):
        with np.load(f"{root}/whole/{name}") as a, np.load(f"{root}/cut/{name}") as b:
            diff = [k for k in a.files if a[k].dtype != b[k].dtype
                    or a[k].tobytes() != b[k].tobytes()]
            check(a.files == b.files and not diff,
                  f"40a: {name} of the resumed run bit-identical to the uninterrupted "
                  f"run's ({len(a.files)} leaves; differing {diff[:4]})")
    metas = [json.load(open(f"{root}/{d}/checkpoint_meta.json")) for d in ("whole", "cut")]
    check(metas[0]["step"] == metas[1]["step"] > 0
          and metas[0]["torch_generator"] == metas[1]["torch_generator"],
          f"40a: the meta's step ({metas[0]['step']}, {metas[1]['step']}) and train "
          "generator equal")

    def untimed(h):
        return {e: {ph: {k: v for k, v in d.items() if not k.endswith("_time")}
                    for ph, d in phases.items()} for e, phases in h.items()}

    check(untimed(whole["history"]) == untimed(resumed["history"]),
          f"40a: the history (times apart) equal: {whole['history']} "
          f"{resumed['history']}")
    kernels = ("K1f", "K1b", "K2f", "K2b", "K8g", "K8g dgrad", "K8q")
    halves = counts["int8 1 epoch"], counts["int8 --resume to 2"]
    check(all(counts["int8 2 epochs"][k] == halves[0][k] + halves[1][k] and halves[0][k] ==
              halves[1][k] > 0 for k in kernels),
          f"40a: K1f, K1b, K2f, K2b and K8 launched, the same counts in each epoch and in "
          f"both runs: {counts}")
    steps_per_epoch = metas[0]["step"] // 2

    # (b) one bf16 epoch with every option on, then lid_ce
    print("phase 40b: bf16, --batch_type folded (batch_size 2), RIR + noise augmentation "
          "(one batch thread), decoder_conf.estimate_c, --num_att_plot 1, prefetch", flush=True)
    aug = [f"rir_scp={root}/rir.scp", f"noise_scp={root}/noise.scp", "noise_db_range=5_15",
           "batch_size=2", "decoder_conf.estimate_c=true"]
    every = run("bf16 every option", "every", 1, ["--batch_type", "folded",
                                                   "--num_att_plot", "1"], aug)
    h = every["history"][1]
    check(all(np.isfinite(h["train"].get(k, np.nan)) for k in ("loss", "loss_att", "loss_cs"))
          and np.isfinite(h["valid"].get("loss", np.nan)) and h["train"]["loss_cs"] > 0,
          f"40b: finite losses (the reporter drops a non-finite one) {h}")
    (events,) = [os.path.join(f"{root}/every/tensorboard", f)
                 for f in os.listdir(f"{root}/every/tensorboard")]
    read = read_event_file(events)
    want = {f"{ph}/{k}": float(np.float32(v)) for ph, d in h.items() for k, v in d.items()}
    check(len(read) == 2 and read[1]["step"] == 1 and read[1]["values"] == want,
          f"40b: the event file reads back the history's {len(want)} scalars")
    with np.load(f"{root}/every/checkpoint.params.npz") as p:
        c_val = float(p["estimated_c_val"][0])
    check(np.isfinite(c_val) and np.float32(c_val) != np.float32(0.6),
          f"40b: estimated_c_val moved from 0.6 to {c_val!r}")
    try:
        import matplotlib  # noqa: F401

        plots = os.listdir(f"{root}/every/att_ws")
        check(len(plots) == 1, f"40b: one attention plot {plots}")
    except ImportError:
        plots = "skipped: no matplotlib"
    print("phase 40b: cs_loss_type lid_ce (full decoder maps, lid labels), one bf16 epoch",
          flush=True)
    lid = run("bf16 lid_ce", "lid", 1, ["--num_att_plot", "0"], ["model_conf.cs_loss_type=lid_ce"])
    h_lid = lid["history"][1]
    check(all(np.isfinite(h_lid["train"].get(k, np.nan)) for k in ("loss", "loss_cs"))
          and h_lid["train"]["loss_cs"] > 0, f"40b: lid_ce finite losses {h_lid}")
    for name in ("bf16 every option", "bf16 lid_ce"):
        check(counts[name]["K1f"] > 0 and counts[name]["K1b"] > 0,
              f"40b: {name} launched K1f and K1b: {counts[name]}")

    # (c) the prefetch on and off
    turns = prefetch_turns(sd, dev, f"{data}/train")
    print(f"phase 40 train CLI options on {smi} (whisper-small, stage-2 recipe, "
          f"{PREFETCH_BINS} batch_bins): " + "; ".join(f"{k} {secs[k]:.1f} s {counts[k]}"
                                                    for k in secs)
          + f"; int8 resume bit-identical over {steps_per_epoch} steps an epoch; losses "
          f"every-option {h['train']['loss']:.4f} (loss_cs {h['train']['loss_cs']:.4f}), "
          f"lid_ce {h_lid['train']['loss']:.4f} (loss_cs {h_lid['train']['loss_cs']:.4f}); "
          f"estimated_c_val {c_val!r}; attention plots {plots}; event scalars {len(want)}",
          flush=True)
    print(f"phase 40c prefetch on {smi}: bf16 adapter step, {turns['steps']} steps a turn "
          f"(batch sizes {turns['batch_sizes']}): " + "; ".join(
              f"{k}: {v['wall_ms']:.2f} ms a step (turns {[round(t, 2) for t in v['turns']]}),"
              f" device busy {v['busy_ms']:.2f} ms, idle {v['idle']:.1%}"
              for k, v in turns.items() if k in ("on", "off"))
          + f"; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"seconds": secs, "launches": counts, "prefetch": turns}


# phase 48: (a) one NCCL rank with ZeRO-1, DCP and a resume against the
# plain CLI (relative, every history value but the wall clocks); (b) 2 gloo
# ranks against (a): bf16 row blocks of 1 against batches of 2 (loss
# relative; acc absolute, over the one valid utterance's ~20 tokens)
DIST_SAME_RTOL = 1e-5
DIST_BOUNDS = {"loss": 2e-2, "acc": 0.1}
DIST_PROFILE_ROWS = 2  # rank 0 profiles its first step after the first with 2 rows
DIST_THREADS = 2  # OMP_NUM_THREADS of each torchrun rank (torchrun's own default: 1)
# device events of one K1f / K1b / K2f / K2b / K8g / K8q launch (K1b's first
# kernel; the wide and the thin K8g)
DIST_KERNELS = {"K1f": "packed_flash_fwd", "K1b": "dkdv_kernel", "K2f": "mlp_fwd_kernel",
                "K2b": "mlp_bwd_kernel", "K8g": "gemm_kernel", "K8q": "rowquant_kernel"}


def dist_worker(out: str, argv: list[str], timeout_s: float = 600.0) -> int:
    """One torchrun rank of phase 48: `agacs_tpu_torch.bin.train.main(argv)`
    with each train step's kernel launches counted and one step of rank 0
    profiled (device events by kernel): the first after the first with
    DIST_PROFILE_ROWS rows (at 2 rows of ~2 s the encoder's 300 rows take
    K2, at 1 row not); writes {rank, history, launches a step, the profiled
    step and its events, each step's wall ms, peak GB} to `out` ({rank} in
    it is the rank). `--after FILE` first in `argv`: start the CLI once FILE
    exists (a resume waiting for the run it continues, its process already
    up)."""
    from agacs_tpu_torch.bin import train as train_cli

    if argv[:1] == ["--after"]:
        after, argv = argv[1], argv[2:]
        t0 = time.perf_counter()
        while not os.path.exists(after):
            check(time.perf_counter() - t0 < timeout_s, f"48: {after} never appeared")
            time.sleep(0.2)

    rank = int(os.environ["RANK"])
    steps, events, profiled, wall = [], {}, [], []
    make = train_cli.make_train_step

    def counted_step(*a, **kw):
        step = make(*a, **kw)

        def run(micro_batches):
            reset_train_counts()
            t0 = time.perf_counter()
            if (rank == 0 and steps and not profiled
                    and micro_batches[0]["speech"].shape[0] >= DIST_PROFILE_ROWS):
                profiled.append(len(steps))
                held = {}
                device_profile(lambda: held.update(stats=step(micro_batches)), events)
                stats = held["stats"]
            else:
                stats = step(micro_batches)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            steps.append(train_counts())
            return stats

        return run

    train_cli.make_train_step = counted_step
    torch.cuda.reset_peak_memory_stats()
    res = train_cli.main(argv)
    with open(out.format(rank=rank), "w") as f:
        json.dump({"rank": rank, "history": {str(k): v for k, v in res["history"].items()},
                   "steps": steps, "profiled": profiled, "wall_ms": wall,
                   "events": {k: events_of(events, w) for k, w in DIST_KERNELS.items()},
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}, f)
    return 0


def dist_train_phase(smi: str, between=None) -> tuple[dict, object]:
    """Phase 48: the train CLI under torchrun at whisper-small's full width
    (stage-2 recipe, bf16) on phase 40's kind of data, under
    build/chip_smoke_dist/ (removed afterwards); see the module docstring.
    `between()`, when given, runs once the torchrun launches have started
    (phases 46-47, host-bound serving, overlap their process starts); its
    result is returned beside the phase's."""
    import shutil

    from agacs_tpu_torch.bin import train

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_dist")
    shutil.rmtree(root, ignore_errors=True)
    data = options_data(root)
    conf = os.path.join(ROOT, "recipes", "seame", "conf",
                        "train_asr_whisper_small_adapter_csloss_2stage.yaml")

    def args(exp, epochs, flags=(), overrides=()):
        return ["--config", conf, "--train_dir", f"{data}/train", "--valid_dir",
                f"{data}/valid", "--exp_dir", f"{root}/{exp}", "--max_epoch", str(epochs),
                "--batch_bins", str(PREFETCH_BINS), "--num_att_plot", "0", *flags,
                "--override", "accum_grad=1", "keep_nbest_models=1", *overrides]

    secs, procs = {}, {}

    def start(tag, nproc, cli_args):
        """torchrun of the train CLI (through `dist_worker`), in the
        background; its log under root."""
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), os.path.join(ROOT, "chip_smoke.py"),
               "--dist-worker", f"{root}/{tag}_{{rank}}.json", *cli_args]
        log = open(f"{root}/{tag}.log", "w")
        # five processes start together on the host's 8 cores: 2 threads each
        env = dict(os.environ, OMP_NUM_THREADS=str(DIST_THREADS))
        procs[tag] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                                       env=env), log, nproc, time.perf_counter())

    def finish(tag):
        p, log, nproc, t0 = procs.pop(tag)
        try:
            rc = p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        secs[tag] = time.perf_counter() - t0
        with open(f"{root}/{tag}.log") as f:
            check(rc == 0, f"48 {tag}: torchrun exited {rc}: {f.read()[-6000:]}")
        return [json.load(open(f"{root}/{tag}_{i}.json")) for i in range(nproc)]

    def untimed(h):
        return {e: {ph: {k: v for k, v in d.items() if not k.endswith("_time")}
                    for ph, d in phases.items()} for e, phases in h.items()}

    def worst(h, ref, keys=None):
        """max over the values of ref's history (or `keys`) of |h - ref| / max(1, |ref|)."""
        return max(abs(h[e][ph][k] - v) / max(1.0, abs(v))
                   for e, phases in untimed(ref).items() for ph, d in phases.items()
                   for k, v in d.items() if keys is None or k in keys)

    zero_dcp = ["--optim_state_shard", "--ckpt_backend", "orbax"]
    print("phase 48: (a) torchrun, 1 rank over NCCL, --optim_state_shard --ckpt_backend orbax: "
          "1 epoch, then --resume to 2; (b) torchrun, 2 ranks on the one card over gloo, data "
          "parallel (no --optim_state_shard, no --tensor_parallel: gloo's all_gather takes no "
          "CUDA tensor), --ckpt_backend orbax, 1 epoch; (c) torchrun, 1 rank over NCCL, "
          "freeze_quant=int8, 1 epoch; the plain CLI's 2 epochs in this process; the runs "
          "overlap on the card (a2's CLI after a1's) and with phases 46-47", flush=True)
    try:
        start("a1", 1, args("a", 1, zero_dcp))
        start("b", 2, args("b", 1, ["--device", "cuda:0", "--dist_backend", "gloo",
                                    "--ckpt_backend", "orbax"]))
        start("c", 1, args("c", 1, (), ["freeze_quant=int8"]))
        # a2 starts its process now and its CLI once a1 has written its result
        start("a2", 1, ["--after", f"{root}/a1_0.json",
                        *args("a", 2, zero_dcp + ["--resume"])])
        t0 = time.perf_counter()
        between_out = between() if between is not None else None
        secs["phases between"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = train.main(args("plain", 2))["history"]
        secs["plain 2 epochs"] = time.perf_counter() - t0
        (a1,), b, (c,), (a2,) = finish("a1"), finish("b"), finish("c"), finish("a2")
    finally:
        for p, log, _, _ in procs.values():
            p.kill()
            p.wait()
            log.close()
    plain = {str(k): v for k, v in plain.items()}
    same = untimed(a2["history"]) == untimed(plain)
    d_a = worst(a2["history"], plain)
    check(set(a2["history"]) == {"1", "2"} and d_a <= DIST_SAME_RTOL,
          f"48a: the history against the plain CLI's, max relative {d_a:.3e} (bound "
          f"{DIST_SAME_RTOL}): {a2['history']} {plain}")
    best = [d for d in os.listdir(f"{root}/a") if d.endswith("epoch.params.dcp")]
    for d in ("checkpoint.params.dcp", "checkpoint.opt.dcp", *best):
        check(os.path.exists(f"{root}/a/{d}/.metadata"), f"48a: {d} written")
    check(len(best) == 1, f"48a: the n-best epoch's DCP directory kept alone {best}")
    check(untimed(b[0]["history"]) == untimed(b[1]["history"]),
          f"48b: both ranks' histories equal {b[0]['history']} {b[1]['history']}")
    d_b = {k: max(abs(b[0]["history"]["1"][ph][k] - a1["history"]["1"][ph][k])
                  / (max(1.0, abs(a1["history"]["1"][ph][k])) if k == "loss" else 1.0)
                  for ph in ("train", "valid")) for k in DIST_BOUNDS}
    check(all(d_b[k] <= DIST_BOUNDS[k] for k in DIST_BOUNDS),
          f"48b: loss and acc against (a)'s epoch 1 {d_b} (bounds {DIST_BOUNDS}): "
          f"{b[0]['history']} {a1['history']}")
    h_c = c["history"]["1"]
    check(all(np.isfinite(h_c[ph]["loss"]) for ph in ("train", "valid")),
          f"48c: finite losses {h_c}")

    def per_step(run, keys):
        """The profiled step's launches (K8g: forward and dgrad, one kernel
        name)."""
        check(run["profiled"], f"48d: rank 0 profiled a step of {DIST_PROFILE_ROWS} rows")
        st = run["steps"][run["profiled"][0]]
        return {k: st[k] + (st["K8g dgrad"] if k == "K8g" else 0) for k in keys}

    kinds = {"a": ("K1f", "K1b"), "c": ("K1f", "K1b", "K2f", "K2b", "K8g", "K8q")}
    launches, events = {}, {}
    for tag, run in (("a", a1), ("c", c)):
        launches[tag], events[tag] = per_step(run, kinds[tag]), {
            k: run["events"][k] for k in kinds[tag]}
        check(all(0 < events[tag][k] <= launches[tag][k] for k in kinds[tag]),
              f"48d {tag}: rank 0's profiled step ran the kernels, device events {events[tag]} "
              f"against launches {launches[tag]}")
    for tag, run in (("b", b[0]), ("b rank 1", b[1])):
        check(run["steps"] and all(s["K1f"] > 0 and s["K1b"] > 0 for s in run["steps"]),
              f"48 {tag}: K1f and K1b in every step {run['steps']}")
    ranks = [("a (NCCL, 1 rank)", a1), ("a resumed", a2), ("b rank 0 (gloo)", b[0]),
             ("b rank 1 (gloo)", b[1]), ("c int8 (NCCL)", c)]
    print(f"phase 48 torchrun training on {smi} (whisper-small, stage-2 recipe, bf16, "
          f"{PREFETCH_BINS} batch_bins): (a) history vs the plain CLI "
          f"{'bit-identical' if same else 'not bit-identical'}, max relative {d_a:.3e} "
          f"(bound {DIST_SAME_RTOL}); (b) 2 gloo ranks vs (a) epoch 1 {d_b} (bounds "
          f"{DIST_BOUNDS}); (c) int8 losses train {h_c['train']['loss']:.4f} valid "
          f"{h_c['valid']['loss']:.4f}; (d) rank 0's profiled step (a 2-row batch) device "
          f"events " + "; ".join(f"{t}: {events[t]} (launches {launches[t]})" for t in events)
          + "; (e) the runs overlapping on the card: " + "; ".join(
              f"{name}: peak {r['peak_gb']:.2f} GB, a step "
              f"{[round(t, 1) for t in r['wall_ms']]} ms" for name, r in ranks)
          + "; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"seconds": secs, "launches": launches, "events": events}, between_out


FUSION_SEED = 4
FUSION_BEAM = 5
FUSION_STEPS = 24  # the CTC prefix loop is a host loop over 750 frames a step
FUSION_WEIGHTS = {"ctc_weight": 0.3, "lm_weight": 0.3, "ngram_weight": 0.3}
FUSION_LM_BLOCKS = 2
CTC_INC_RTOL = 1e-4  # the CTC prefix increments, card vs CPU float32, x max |cpu|
FUSION_WORDS = ("我们", "去", "market", "hello", "你好", "the", "shop", "是", "ok", "了",
                "that", "好", "lah", "then", "吃饭", "can", "走", "right", "today", "明天")


def fusion_text(path: str, lines: int = 400) -> None:
    """A Kaldi text file of `lines` code-switched sentences drawn from
    FUSION_WORDS with a seed, the n-gram's training text."""
    rng = np.random.RandomState(FUSION_SEED)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(lines):
            words = rng.choice(FUSION_WORDS, rng.randint(3, 12))
            f.write(f"u{i:04d} {' '.join(words)}\n")


def fusion_models(dev):
    """Whisper-small (bf16) with a CTC head (normal / sqrt(d), zero bias,
    as `init_asr_params`), random weights from torch seed FUSION_SEED, and
    a float32 transformer LM (d 512, 8 heads, FUSION_LM_BLOCKS blocks) from
    seed FUSION_SEED + 1. Returns (model, lm, sd)."""
    from agacs_tpu_torch.models import lm as tlm
    from agacs_tpu_torch.models import whisper as tw

    cfg = tw.make_config("small", compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(FUSION_SEED)
    sd = tw.init_whisper_params(g, cfg)
    sd["ctc.weight"] = torch.randn(cfg.n_vocab, cfg.n_audio_state, generator=g) \
        / np.sqrt(cfg.n_audio_state)
    sd["ctc.bias"] = torch.zeros(cfg.n_vocab)
    lcfg = tlm.TransformerLMConfig(num_blocks=FUSION_LM_BLOCKS)
    lm = tlm.TransformerLM.from_state_dict(
        lcfg, tlm.init_lm_params(torch.Generator().manual_seed(FUSION_SEED + 1), lcfg),
        device=dev)
    return tw.Whisper.from_state_dict(cfg, sd, device=dev), lm, sd


def ctc_increments(logp, lens, rows, cands1, cands2):
    """Two CTC prefix steps from the empty prefix over B*beam rows (`rows`
    maps a row to its utterance): every row keeps its first candidate after
    step 1; returns step 2's increments psi - score (N, C) and its eos
    increments (N,)."""
    from agacs_tpu_torch.decode import ctc_prefix as cp

    s0 = cp.ctc_prefix_init(logp)
    state = cp.CTCPrefixState(r_nb=s0.r_nb[rows], r_b=s0.r_b[rows], last=s0.last[rows],
                              score=s0.score[rows])
    lens_r = lens[rows]
    _, st = cp.ctc_prefix_score(logp, state, cands1, frame_lens=lens_r, rows=rows)
    state = cp.ctc_prefix_select(st, torch.zeros_like(rows))
    psi, _ = cp.ctc_prefix_score(logp, state, cands2, frame_lens=lens_r, rows=rows)
    return psi - state.score[:, None], cp.ctc_eos_score(state, lens_r) - state.score


def whisper_fusion_phase(dev, audio) -> dict:
    """Phase 46: the whisper family's fused beam at full width:
    whisper-small bf16 with a CTC head (`fusion_models`), Speech2Text at
    beam FUSION_BEAM, FUSION_STEPS steps, ctc 0.3, a float32 LM at 0.3 and
    an n-gram trained by `bin.ngram_train` on `fusion_text` at 0.3, on
    phase 4's 8 x 15 s. A warm-up request, two timed ones with launch
    counts (K1f, K3a, K3s, K3-f32 each above zero) and the same tokens; one
    with the CTC prefix scoring timed apart for its share; one under the
    profiler (busy, idle share); one step's n-gram scores over the 40 x
    51865 candidates equal to the CPU's element for element; two CTC
    prefix steps' increments against CPU float32 on the same log-probs
    (CTC_INC_RTOL)."""
    import shutil

    from agacs_tpu_torch.bin import ngram_train
    from agacs_tpu_torch.decode import ctc_prefix
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode
    from agacs_tpu_torch.models.ngram import load_ngram, ngram_score_step

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_fusion")
    shutil.rmtree(root, ignore_errors=True)
    fusion_text(os.path.join(root, "text"))
    npz = os.path.join(root, "ngram.npz")
    n_seqs = ngram_train.main(["--train_text", os.path.join(root, "text"), "--output", npz])
    ng, ng_cpu = load_ngram(npz, device=dev), load_ngram(npz)
    model, lm, _ = fusion_models(dev)
    asr_cfg = ASRModelConfig(whisper=model.cfg)
    s2t = Speech2Text(model, asr_cfg, beam_size=FUSION_BEAM, max_steps=FUSION_STEPS, lm=lm,
                      ngram_lm=ng, **FUSION_WEIGHTS)
    s2t(audio)  # warm-up
    torch.cuda.synchronize()
    reset_decode_counts()
    times, runs = [], []
    for i in range(2):
        t0 = time.perf_counter()
        runs.append(s2t(audio))
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = {k: v for k, v in decode_counts().items() if v}
    ms = statistics.median(times) * 1e3
    check(all(launches.get(k, 0) > 0 for k in ("K1f", "K3a", "K3s", "K3-f32")),
          f"fused beam launched K1f, K3a, K3s and K3-f32: {launches}")
    check([r.tokens for r in runs[0]] == [r.tokens for r in runs[1]],
          "two fused beam requests gave the same tokens")
    check(len(runs[0]) == 8 and all(r.tokens[:5] == PRIMER and np.isfinite(r.score)
                                    and r.score != 0.0 for r in runs[0]),
          "fused beam: 8 finite hypotheses")

    real, ctc_s = ctc_prefix.ctc_prefix_score, []

    def timed_ctc(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        ctc_s.append(time.perf_counter() - t)
        return out

    ctc_prefix.ctc_prefix_score = timed_ctc
    try:
        t0 = time.perf_counter()
        s2t(audio)
        ctc_req = time.perf_counter() - t0
    finally:
        ctc_prefix.ctc_prefix_score = real
    busy, n_events, per_name = device_profile(lambda: s2t(audio))

    # one step's n-gram scores: the returned hypotheses as a (40, total)
    # buffer, half the rows' tokens replaced by the training text's ids
    total = len(PRIMER) + FUSION_STEPS + 1
    rng = np.random.RandomState(FUSION_SEED)
    buf = np.full((8 * FUSION_BEAM, total), 50257, np.int64)
    for i, r in enumerate(runs[0]):
        buf[i * FUSION_BEAM : (i + 1) * FUSION_BEAM, : len(r.tokens)] = r.tokens[:total]
    seen = np.unique(np.asarray(ng_cpu.unigram).argsort()[-200:])
    swap = rng.rand(*buf.shape) < 0.5
    swap[:, : len(PRIMER)] = False
    buf[swap] = rng.choice(seen, int(swap.sum()))
    pos = len(PRIMER) + 8
    ng_card = ngram_score_step(ng, torch.from_numpy(buf).to(dev), pos).cpu()
    ng_ref = ngram_score_step(ng_cpu, torch.from_numpy(buf), pos)
    backed = ng_ref == ng_cpu.unigram[None] + float(np.float32(np.log(ng_cpu.alpha)) * 2)
    check(ng_card.shape == (40, 51865) and torch.equal(ng_card, ng_ref),
          "the card's n-gram scores equal the CPU's element for element")

    # the CTC prefix increments, card vs CPU float32, on the card's log-probs
    speech = torch.from_numpy(audio).to(dev)
    with torch.inference_mode():
        enc, enc_lens = encode(model, asr_cfg, speech,
                               torch.full((8,), audio.shape[1], device=dev))
        logp = s2t.ctc_log_probs(enc)
        rows = torch.arange(8, device=dev).repeat_interleave(FUSION_BEAM)
        cands1 = torch.from_numpy(rng.randint(1, 51865, (40, 8))).to(dev)
        cands1[:, 0] = logp[rows, 5].argmax(-1)
        cands2 = torch.from_numpy(rng.randint(1, 51865, (40, 8))).to(dev)
        cands2[:, 0] = cands1[:, 0]  # a repeat of the last token
        card = ctc_increments(logp, enc_lens, rows, cands1, cands2)
        cpu = ctc_increments(logp.cpu(), enc_lens.cpu(), rows.cpu(), cands1.cpu(),
                             cands2.cpu())
    errs = [float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(card, cpu)]
    check(all(e <= CTC_INC_RTOL for e in errs) and all(bool(torch.isfinite(x).all())
                                                      for x in card),
          f"CTC prefix increments card vs CPU f32 {errs} <= {CTC_INC_RTOL} x max")
    print(f"phase 46 fused whisper beam: whisper-small bf16 + CTC head, LM "
          f"{FUSION_LM_BLOCKS} x 512 f32, n-gram (order 3, {n_seqs['n_seqs']} sentences), "
          f"vocabulary 51865, 8 x 15 s, beam {FUSION_BEAM}, {FUSION_STEPS} steps, "
          f"{FUSION_WEIGHTS}: {ms:.1f} ms/batch (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {120.0 / (ms / 1e3):.1f} x realtime; "
          f"launches {launches}; CTC prefix scoring {sum(ctc_s) * 1e3:.1f} ms of a "
          f"{ctc_req * 1e3:.1f} ms request ({sum(ctc_s) / ctc_req:.1%}, {len(ctc_s)} calls, "
          f"synchronised around each); profile: device busy {busy:.1f} ms in {n_events} "
          f"events, idle {1 - busy / ms:.1%} of {ms:.1f} ms; n-gram scores card == cpu over "
          f"40 x 51865 ({int((~backed).sum())} not the full-backoff unigram); CTC increments "
          f"rel err {errs[0]:.2e}, eos {errs[1]:.2e} (bound {CTC_INC_RTOL}); lengths "
          f"{[len(r.tokens) for r in runs[0]]}; phase {time.perf_counter() - t_phase:.1f} s; "
          f"top: " + top_kernels(per_name, 6), flush=True)
    del model, lm, s2t, logp, enc
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "ctc_share": sum(ctc_s) / ctc_req,
            "busy": busy}


LONG_FORM_SECONDS = 45  # two 30 s windows
LONG_FORM_SEED = 6


def long_form_audio(seconds: int) -> np.ndarray:
    """A 16 kHz signal of `seconds`: seeded noise under gliding tones that
    change every few seconds."""
    rng = np.random.RandomState(LONG_FORM_SEED)
    t = np.arange(seconds * 16000) / 16000.0
    f = 200.0 + 150.0 * np.sin(2 * np.pi * t / 7.0) + 100.0 * (np.floor(t / 3.0) % 4)
    tone = 0.2 * np.sin(2 * np.pi * np.cumsum(f) / 16000.0) * (np.sin(np.pi * t / 1.5) ** 2)
    return (tone + 0.05 * rng.randn(t.size)).astype(np.float32)


def long_form_phase(dev) -> dict:
    """Phase 47: `bin.transcribe --long_form --word_timestamps` on a
    generated LONG_FORM_SECONDS s wav, whisper-small bf16 (random weights,
    seed LONG_FORM_SEED, written as a .params.npz with a config.yaml under
    build/): at least two 30 s windows; every window's tokens obey the
    timestamp rules 1-4 (`timestamp_rule_violations`) and, replayed through
    the cached step on its encoder output, all five
    (`replay_timestamp_rules`: each token allowed, the argmax at
    temperature 0); segment times and each segment's word times never
    decrease; the DTW library built; K1f and K3 launched. Prints ms per
    window and the temperatures taken."""
    import shutil

    import yaml

    from agacs_tpu_torch.bin import transcribe as cli
    from agacs_tpu_torch.data.io import write_wav
    from agacs_tpu_torch.decode import timing
    from agacs_tpu_torch.decode import transcribe as tr
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.checkpoint import numpy_from_params
    from agacs_tpu_torch.ops.logmel import log_mel_spectrogram

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_longform")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = tw.make_config("small", compute_dtype=torch.bfloat16)
    sd = tw.init_whisper_params(torch.Generator().manual_seed(LONG_FORM_SEED), cfg)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump({"encoder": "whisper", "encoder_conf": {"whisper_model": "small"},
                        "decoder_conf": {"whisper_model": "small"}}, f)
    np.savez(os.path.join(root, "p.params.npz"), **numpy_from_params(sd))
    audio = long_form_audio(LONG_FORM_SECONDS)
    write_wav(os.path.join(root, "a.wav"), audio)
    setup_s = time.perf_counter() - t_phase

    reset_decode_counts()
    t0 = time.perf_counter()
    printed = io.StringIO()  # a line a segment and a word: kept off this log
    with contextlib.redirect_stdout(printed):
        out = cli.main([os.path.join(root, "config.yaml"), os.path.join(root, "p.params.npz"),
                        os.path.join(root, "a.wav"), "--long_form", "--word_timestamps",
                        "--device", str(dev)])
    run_s = time.perf_counter() - t0
    check(printed.getvalue().rstrip().endswith(f"# language: {out['language']}"),
          "bin.transcribe printed its segments and the language")
    launches = {k: v for k, v in decode_counts().items() if v}
    windows, segs = out["windows"], out["segments"]
    check(launches.get("K1f", 0) > 0 and launches.get("K3", 0) > 0,
          f"long-form transcription launched K1f and K3: {launches}")
    check(len(windows) >= 2 and not any(w["beam"] for w in windows),
          f"{len(windows)} windows over {LONG_FORM_SECONDS} s")
    bad = [(i, tr.timestamp_rule_violations(w["sampled"])) for i, w in enumerate(windows)]
    check(not any(b for _, b in bad), f"timestamp rules 1-4 hold in every window: {bad}")

    # replay each window on its encoder output (the same weights, the same
    # kernels) for rule 5 and the argmax at temperature 0
    model = tw.Whisper.from_state_dict(cfg, sd, device=dev)
    t0 = time.perf_counter()
    replayed = []
    with torch.inference_mode():
        for w in windows:
            seek = int(round(w["seek"] * tr.SAMPLE_RATE))
            win = np.pad(audio[seek : seek + tr.CHUNK_SAMPLES],
                         (0, max(0, seek + tr.CHUNK_SAMPLES - len(audio))))
            mel, _ = log_mel_spectrogram(torch.from_numpy(win[None]).to(dev),
                                         torch.tensor([tr.CHUNK_SAMPLES], device=dev))
            enc = tw.whisper_encode(model, mel)
            replayed.append(tr.replay_timestamp_rules(model, enc, w["primer"], w["sampled"],
                                                      w["temperature"]))
    replay_s = time.perf_counter() - t0
    check(not any(replayed), f"every window's tokens obey the five rules on replay: "
          f"{[r[:2] for r in replayed]}")
    starts = [s.start for s in segs]
    check(bool(segs) and starts == sorted(starts) and all(s.start <= s.end for s in segs),
          f"{len(segs)} segments, times never decreasing")
    words = [w for s in segs for w in s.words]
    check(bool(words) and all([w.start for w in s.words] == sorted(w.start for w in s.words)
                              and all(w.start <= w.end for w in s.words) for s in segs),
          f"{len(words)} words, times never decreasing within a segment")
    lib = timing.DTW.lib
    check(lib is not None and os.path.exists(lib._name), "the DTW library was built")
    n_tok = sum(len(w["sampled"]) for w in windows)
    print(f"phase 47 long-form transcription: whisper-small bf16, {LONG_FORM_SECONDS} s wav, "
          f"bin.transcribe --long_form --word_timestamps: {run_s:.1f} s, "
          f"{len(windows)} windows ({run_s / len(windows) * 1e3:.0f} ms per window; "
          f"temperatures taken {[w['temperature'] for w in windows]}; {n_tok} tokens kept), "
          f"language {out['language']}, {len(segs)} segments, {len(words)} words "
          f"({', '.join(f'{w.word!r}@{w.start:.2f}' for w in words[:4])} ...); launches "
          f"{launches}; rules 1-4 and the replay (rule 5, argmax at 0) hold, replay "
          f"{replay_s:.1f} s; DTW {os.path.basename(lib._name)}; setup {setup_s:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del model
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "windows": len(windows), "s": run_s}


# Phase 49: whisper-large (OpenAI large-v2's dims, `make_config("large")`:
# d 1280, 20 heads of 64, 32 + 32 layers, h 5120, vocabulary 51865) at full
# width, on random weights made on the card from a torch seed (the host's
# init of whisper-small alone takes ~10 s; large has 6x its parameters).
# (a) K4 above K 1024 (the split backward on a non-portable cluster of K /
# 128): the whisper-large CTC head's (16 x 750, 1280) x (1280, 51865) (a
# cluster of 10, timed), a ragged K 1200 (padded to 1280 by the wrapper)
# and K 1152 (a cluster of 9: 32 quads over 9 ranks) at a small N and V,
# under phase 2v's bounds; K1f / K1b, K3 and K8 at whisper-large's shapes
# under phases 2b's, 3's and 2i's checks: the encoder's (16, 750, 1280) at
# 20 heads; greedy's cross (8, 752) at pos 749 and self (8, 112) at pos
# 103; the int8 step's encoder out (12000, 1280) -> 1280, fused q/k/v ->
# 3840, fc1 -> 5120 and fc2 (12000, 5120) -> 1280, and a greedy step's 8
# rows (`thin_matmul`) -> 1280, -> 5120 and (8, 5120) -> 1280. (b) the
# stage-2 step at 16 x 15 s, bf16 then int8 trunk (the MLP unfused, as in
# JAX); (c) the CTC full fine-tune (AdamW's float32 state on all 1.61B
# parameters, the CTC head's included); (d) greedy serving (decode_asr_whisper.yaml), 8 x 15 s, 100
# steps, bf16 then int8 trunk; (e) the card in bf16 against the CPU in
# float32 on (c)'s weights cut to LARGE_PARITY_LAYERS blocks a stack.
LARGE_SEED = 9
LARGE_D, LARGE_H = 1280, 20
K4_LARGE = (12000, 1280, 51865)
K4_LARGE_SHAPES = (K4_LARGE, (3000, 1200, 51865), (300, 1152, 1001))
K3_LARGE_CASES = ((8, 752, LARGE_D, LARGE_H, 749, True), (8, 112, LARGE_D, LARGE_H, 103, True))
K8_LARGE_SHAPES = ((12000, 1280, 1280), (12000, 1280, 3840), (12000, 1280, 5120),
                   (12000, 5120, 1280), (8, 1280, 1280), (8, 1280, 5120), (8, 5120, 1280))
LARGE_TRAIN_STEPS = 3
LARGE_CTC_B, LARGE_CTC_STEPS = 16, 2
LARGE_PARITY_LAYERS = 2


def check_k4_large(dev, g) -> dict:
    """Phase 49a: `k4_shapes` at K4_LARGE_SHAPES, K4_LARGE profiled and
    timed. Returns {"fwd", "dx", "dw"} results, the largest errors over the
    shapes with K4_LARGE's times."""
    out = k4_shapes(g, dev, K4_LARGE_SHAPES, (K4_LARGE,), "49a", profiled=(K4_LARGE,))
    res = out[K4_LARGE]
    for r in out.values():
        for part in res:
            res[part]["err"] = max(res[part]["err"], r[part]["err"])
    return res


def large_serve_phase(dev, cfg, sd, audio, int8: bool) -> dict:
    """Phase 49d: greedy serving (decode_asr_whisper.yaml: beam 1) of
    whisper-large + adapters on phase 4's 8 x 15 s, 100 steps, from `sd`
    (`int8`: the int8-trunk step's state, its w_q buffers), in bf16:
    `serve` with exact launches (the int8 trunk's encoder MLPs unfused: fc1
    and fc2 on the wide K8g). No profile, for the script's time (~150,000
    device records a request; PERF.md keeps the earlier readings)."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig
    from agacs_tpu_torch.ops import int8_linear, int8_mlp
    from agacs_tpu_torch.utils.config import load_yaml

    dec = load_yaml(os.path.join(ROOT, "recipes", "seame", "conf", "decode_asr_whisper.yaml"))
    check(dec["beam_size"] == 1 and dec["ctc_weight"] == 0.0 and dec["lm_weight"] == 0.0,
          f"decode_asr_whisper.yaml decodes greedily: {dec}")
    t0 = time.perf_counter()
    model = tw.Whisper.from_state_dict(cfg, sd, device=dev)
    load_s = time.perf_counter() - t0
    n_steps = min(len(PRIMER) + 100, cfg.n_text_ctx) - 1
    la, lt = cfg.n_audio_layer, cfg.n_text_layer
    want = {"K1f": la, "K3": 2 * lt * n_steps}
    if int8:
        fused = int8_mlp.supports(cfg.n_audio_state, 4 * cfg.n_audio_state)
        enc = 2 if fused else 4  # fused q/k/v and out, and fc1 and fc2 unless K2 takes them
        want.update(K2f=la if fused else 0, K8g=enc * la + 2 * lt + 8 * lt * n_steps,
                    K8q=enc * la + 2 * lt)
    label = f"phase 49d whisper-large+adapters {'int8 trunk' if int8 else 'bf16'} greedy"
    run = serve(label, model, ASRModelConfig(whisper=cfg), audio, dec["beam_size"], want)
    thin = int8_linear.THIN_LAUNCHES  # of the one timed request
    check(not int8 or thin == 8 * lt * n_steps,
          f"{label}: {thin} thin_matmul launches == 8 x {lt} x {n_steps}")
    ms = run["ms"]
    print(f"{label}: 8 x 15 s, {n_steps} steps: {ms:.1f} ms/batch (one request after a "
          f"warm-up), {120.0 / (ms / 1e3):.1f} x realtime; "
          f"peak {run['peak_gb']:.2f} GB; launches {run['launches']}"
          + (f", of K8g thin_matmul {thin}" if int8 else "")
          + f"; built in {load_s:.1f} s", flush=True)
    out = {"ms": ms, "launches": run["launches"], "thin": thin, "peak_gb": run["peak_gb"]}
    del run, model
    torch.cuda.empty_cache()
    return out


def large_parity(dev, sd4: dict, batch: dict) -> dict:
    """Phase 49e: whisper-large's width cut to LARGE_PARITY_LAYERS blocks a
    stack ((c)'s weights, CTC head at K 1280 included) on one 15 s
    utterance, the card in bf16 against the port on the CPU in float32:
    the encoder output and the first decode step's logits (phase 5's
    bounds), then phase 38's micro-step parity (loss_ctc and the CTC head's
    gradient cosine, beside a control with K4's plain version)."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode

    layers = LARGE_PARITY_LAYERS
    one = {k: v[:1] for k, v in batch.items()}
    outs = []
    with torch.inference_mode():
        for d, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
            cfg = tw.make_config("large", n_audio_layer=layers, n_text_layer=layers,
                                 compute_dtype=dtype)
            m = tw.Whisper.from_state_dict(cfg, sd4, device=d)
            enc, _ = encode(m, ASRModelConfig(whisper=cfg), one["speech"].to(d),
                            one["speech_lengths"].to(d))
            kv = tw.init_self_kv_cache(cfg, 1, 16, device=d)
            logits, _ = tw.whisper_decode_step(m, torch.tensor([PRIMER[0]], device=d), 0, kv,
                                               tw.precompute_cross_kv(m, enc))
            outs.append((enc.float().cpu(), logits.float().cpu()))
            del m
    (enc_g, log_g), (enc_c, log_c) = outs
    e_enc, e_log = rel_l2(enc_g, enc_c), rel_l2(log_g, log_c)
    check(enc_g.shape == (1, 750, LARGE_D) and bool(torch.isfinite(enc_g).all())
          and bool(torch.isfinite(log_g).all()) and e_enc < ENC_REL_L2 and e_log < LOGITS_REL_L2,
          f"whisper-large {layers} + {layers} layers: encoder rel L2 {e_enc} < {ENC_REL_L2}, "
          f"first-step logits {e_log} < {LOGITS_REL_L2}")
    print(f"phase 49e whisper-large width, {layers} + {layers} layers, card bf16 vs cpu f32 on "
          f"1 x {TRAIN_S} s: encoder rel L2 {e_enc:.3e} (bound {ENC_REL_L2}), first-step "
          f"logits rel L2 {e_log:.3e} (bound {LOGITS_REL_L2}); argmax card "
          f"{int(log_g.argmax())} cpu {int(log_c.argmax())}", flush=True)
    res = whisper_ctc_parity(sd4, dev, batch, size="large", layers=layers, phase="49e")
    return {"enc": e_enc, "logits": e_log, **res}


def whisper_large_phase(dev, g, audio) -> dict:
    """Phase 49 (see the module docstring and the constants above)."""
    from agacs_tpu_torch.models import whisper as tw

    t_phase = time.perf_counter()
    k4 = check_k4_large(dev, g)
    k1f, k1b = check_k1_train(dev, g, d=LARGE_D, h=LARGE_H, big=((16, 750),), phase="49a")
    k3 = check_k3(dev, g, cases=K3_LARGE_CASES, phase="49a")
    k8 = check_k8(dev, g, shapes=K8_LARGE_SHAPES, entries=(K8_LARGE_SHAPES[0], K8_LARGE_SHAPES[4]),
                  phase="49a", profiled=False)
    kernels_s = time.perf_counter() - t_phase

    cfg = tw.make_config("large", adapter=True, adapter_encoder=True, adapter_decoder=True,
                         compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    sd = tw.init_whisper_params(torch.Generator(device=dev).manual_seed(LARGE_SEED), cfg)
    torch.cuda.synchronize()
    print(f"phase 49b whisper-large + adapters: {sum(v.numel() for v in sd.values()) / 1e9:.3f}B "
          f"float32 values made on the card from torch seed {LARGE_SEED} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    train = train_phase(sd, dev, size="large", steps=LARGE_TRAIN_STEPS, phase=("49b", "49b"))
    train8 = train_phase(sd, dev, int8=True, bf16=train, size="large", steps=LARGE_TRAIN_STEPS,
                         phase=("49b int8", "49b int8"), keep_state=True)
    del train["batch"], train8["batch"]
    serve16 = large_serve_phase(dev, cfg, sd, audio, int8=False)
    serve8 = large_serve_phase(dev, cfg, train8.pop("state"), audio, int8=True)
    del sd
    torch.cuda.empty_cache()
    ctc = whisper_ctc_phase(dev, size="large", b=LARGE_CTC_B, steps=LARGE_CTC_STEPS,
                            phase=("49c", "49c"))
    blocks = re.compile(r"(encoder|decoder)\.blocks\.(\d+)\.")
    sd4 = {k: v.cpu() for k, v in ctc.pop("sd").items()
           if not (m := blocks.match(k)) or int(m.group(2)) < LARGE_PARITY_LAYERS}
    torch.cuda.empty_cache()
    parity = large_parity(dev, sd4, ctc.pop("batch"))
    print(f"phase 49 whisper-large: kernels {kernels_s:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k4": k4, "k1f": k1f, "k1b": k1b, "k3": k3, "k8": k8, "train": train,
            "train8": train8, "serve16": serve16, "serve8": serve8, "ctc": ctc,
            "parity": parity}


# Phase 50: the conformer at NVIDIA NeMo's XLarge widths
# (examples/asr/conf/conformer/conformer_ctc_bpe.yaml: d_model 1024, 8 heads,
# 24 layers, ff 4096) on the recipe's train_asr_conformer.yaml, everything
# else as the recipe has it, the decoder at 8 heads too: heads of 128
# throughout, so K5 runs its 128 instance, the decoder's self-attention K3's
# rows at d_head 128, and the CTC head K4 at K 1024. The 24 encoder blocks
# cut to 12 for the script's time (phase 52 runs the deeper, wider model).
# Random weights from torch seed XL_SEED, drawn on the card; the LM the
# recipe's (16 x 512).
XL_WIDTHS = {"enc_output_size": 1024, "enc_attention_heads": 8, "enc_linear_units": 4096,
             "dec_attention_heads": 8}
XL_BLOCKS = (12, 6)
XL_PARITY_BLOCKS = (2, 2)
XL_SEED = 10
XL_TRAIN_STEPS = 3
# Phase 51: the recipe's conformer at its own full width (d 256, units 2048,
# 12 + 6 blocks, cnn_module_kernel 15, ctc 0.3) with one key changed,
# encoder_conf.attention_heads 4 -> 1: one head of 256, so K5 runs its wide
# route (2 chunks of 128); the decoder keeps 4 heads of 64 (K3), the CTC
# head K4 at K 256. No public conformer preset has heads above 128; JAX's
# kernel takes any d_head % 8 == 0. Random weights from torch seed H1_SEED, drawn on the card.
H1_WIDTHS = {"enc_attention_heads": 1}
H1_BLOCKS = (12, 6)
H1_PARITY_BLOCKS = (2, 1)
H1_SEED = 11
H1_TRAIN_STEPS = 3
# Phase 52: the conformer at Google USM's 2B widths (Zhang et al. 2023,
# "Google USM: Scaling Automatic Speech Recognition Beyond 100 Languages",
# arXiv:2303.01037: model dimension 1536, 16 heads, 32 blocks) on the
# recipe's train_asr_conformer.yaml: encoder_conf output_size 1536,
# attention_heads 16 (d_head 96), linear_units 6144 (4 x 1536), decoder_conf
# attention_heads 16, everything else as the recipe has it (cnn_module_kernel
# 15, ctc 0.3, the 6-block decoder, the whisper vocabulary, the LM). So the
# CTC head runs K4 at K 1536 (KS-256 slices on clusters of 6), K5 its 128
# instance on heads of 96 zero-padded, and the decoder's self-attention K3's
# rows at d_head 96. The paper's 32 encoder blocks cut to USM_BLOCKS[0], the
# deepest of 32, 24 and 16 whose 16 x 15 s step (no activation
# checkpointing, as JAX's conformer has none) fits the card with ~10%
# headroom. Random weights from torch seed USM_SEED, drawn on the card.
USM_WIDTHS = {"enc_output_size": 1536, "enc_attention_heads": 16, "enc_linear_units": 6144,
              "dec_attention_heads": 16}
USM_BLOCKS = (24, 6)
USM_PARITY_BLOCKS = (2, 1)
USM_SEED = 12
USM_TRAIN_STEPS = 3


def width_raw(widths: dict, enc_blocks: int, dec_blocks: int) -> dict:
    return conformer_raw(**widths, enc_num_blocks=enc_blocks, dec_num_blocks=dec_blocks)


def width_step_launches(enc_blocks: int) -> dict:
    """Kernel launches of one conformer micro-batch: K5 forward and backward
    once an encoder block, K4's three passes once."""
    return {"K5": enc_blocks, "K5 bwd": enc_blocks, "K4": 1, "K4 dx": 1, "K4 dw": 1}


def width_phase(dev, audio, phase: str, label: str, widths: dict, blocks: tuple,
                parity_blocks: tuple, seed: int, steps: int) -> dict:
    """Phases 50 and 51: the conformer on train_asr_conformer.yaml with the
    encoder_conf / decoder_conf `widths` (enc_* / dec_* keys) at `blocks`
    (encoder, decoder), random weights from torch seed `seed`: (a) the
    train step at 16 x 15 s (Adam, WarmupLR, clip 5, SpecAug, dropout 0.1
    as the recipe): a warm-up, then `steps` timed steps with exact launches
    (K5 forward and backward once an encoder block a step, K4 1 + 1 + 1),
    finite losses and no non-finite gradient, ms a step, peak memory, one
    more step under the profiler for the device's busy and idle share; (b)
    a joint CTC/attention beam-10 request (ctc 0.4, LM 0.2, CONF_S steps,
    the recipe's LM) on phase 4's 8 x 15 s through `decode_conformer_batch`,
    one timed after a warm-up, exact launches (K5 once an encoder block an
    encode, K3 once a decoder block a step, K3-f32 16 a step), 8 finite
    hypotheses, ms per batch; (c) at `parity_blocks` blocks of the same
    widths, the card in bf16 against the CPU in float32: a train micro-step
    within phase 31's rule and bounds, and the encoder output and the first
    joint step within phase 27's (CONF_REL_L2)."""
    from agacs_tpu_torch.decode.joint_beam import decode_conformer_batch
    from agacs_tpu_torch.models import conformer_asr
    from agacs_tpu_torch.train.optim import build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step
    from agacs_tpu_torch.utils.config import optim_config_from_dict

    t_phase = time.perf_counter()
    enc_blocks, dec_blocks = blocks
    raw = width_raw(widths, enc_blocks, dec_blocks)
    model, cfg, sd, raw = conformer_train_model(dev, torch.bfloat16, raw=raw, seed=seed)
    torch.cuda.empty_cache()
    d, h = cfg.encoder.output_size, cfg.encoder.attention_heads
    dd, dh = cfg.decoder.d_model, cfg.decoder.attention_heads
    shape = (f"encoder d {d}, {h} head{'s' if h > 1 else ''} of {d // h}, units "
             f"{cfg.encoder.linear_units}, {enc_blocks} blocks; decoder {dec_blocks} x {dh} "
             f"heads of {dd // dh}")
    n_params = sum(p.numel() for p in model.parameters())
    ocfg = optim_config_from_dict(raw)
    opt, sched = build_optimizer(model.parameters(), ocfg)
    step = make_train_step(model, cfg, opt, sched, grad_clip=ocfg.grad_clip,
                           generator=torch.Generator().manual_seed(1),
                           loss_fn=conformer_asr.forward)
    batch = make_train_batch(TRAIN_B, TRAIN_S, dev)
    step([batch])  # warm-up
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t_phase
    reset_conformer_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        stats = step([batch])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(stats["loss"]), float(stats["loss_ctc"]), float(stats["loss_att"])))
    train_launches = conformer_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    want = {k: v * steps for k, v in width_step_launches(enc_blocks).items()}
    check(train_launches == want, f"{label} train launches {train_launches} == {want}")
    check(all(np.isfinite(v) for row in losses for v in row)
          and int(stats["grad_nonfinite_total"]) == 0, f"finite {label} losses {losses}")
    ms = statistics.median(times) * 1e3
    busy, n_events, per_name = device_profile(lambda: step([batch]))

    def share(*keys):
        t = sum(v for name, v in per_name.items() if any(k in name for k in keys))
        return f"{t:.2f} ms ({t / busy:.1%})"

    t_enc = ((TRAIN_S * 16000 // 128 + 1 - 1) // 2 - 1) // 2
    print(f"phase {phase}a {label} train: train_asr_conformer.yaml, {shape}, "
          f"{n_params / 1e9:.3f}B parameters, bf16 / f32 masters, Adam, {TRAIN_B} x {TRAIN_S} s "
          f"(T {t_enc}) a step: {ms:.1f} ms/step (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {TRAIN_B * TRAIN_S / (ms / 1e3):.1f} "
          f"audio-s/s; peak {peak_gb:.2f} GB ({peak_gb / card_gb:.1%} of the card's "
          f"{card_gb:.1f} GB); launches {train_launches} "
          f"({width_step_launches(enc_blocks)} a step); losses "
          f"{[tuple(round(v, 3) for v in row) for row in losses]}; profile: device busy "
          f"{busy:.1f} ms in {n_events} events, idle {1 - busy / ms:.1%}; K5 fwd "
          f"{share('relpos_flash_fwd', 'relpos_wide_fwd')}, K5 bwd "
          f"{share('relpos_dkdv', 'relpos_dq', 'relpos_rowdot', 'relpos_wide_d')}, K4 "
          f"{share('vocab_lse')}; built + warm-up {load_s:.1f} s; top: "
          + top_kernels(per_name, 6), flush=True)
    del model, opt, step
    torch.cuda.empty_cache()

    t_serve = time.perf_counter()
    smodel, lm, _, _ = conformer_models(dev, torch.bfloat16, sd=sd, raw=raw)
    del sd
    speech = torch.from_numpy(audio).to(dev)
    lens = torch.full((audio.shape[0],), audio.shape[1], device=dev)

    def request(steps=CONF_S):
        out = decode_conformer_batch(smodel, lm, speech, lens, beam_size=CONF_BEAM,
                                     ctc_weight=CONF_CTC, lm_weight=CONF_LM, max_steps=steps,
                                     loop="scan")
        torch.cuda.synchronize()
        return out

    request(10)  # warm-up
    reset_decode_counts()
    t0 = time.perf_counter()
    rows, scores = request()
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve_launches = {k: v for k, v in decode_counts().items() if v}
    want = {"K5": enc_blocks, "K3": dec_blocks * CONF_S, "K3-f32": lm.cfg.num_blocks * CONF_S}
    check(serve_launches == want, f"{label} serving launches {serve_launches} == {want}")
    check(len(rows) == audio.shape[0] and bool(torch.isfinite(scores).all()),
          f"{label} serving: {audio.shape[0]} finite hypotheses")
    print(f"phase {phase}b {label} serving: bf16 {shape}, LM {lm.cfg.num_blocks} x "
          f"{lm.cfg.d_model} f32, 8 x 15 s, beam {CONF_BEAM}, ctc {CONF_CTC}, lm {CONF_LM}, "
          f"{CONF_S} steps: {serve_ms:.1f} ms/batch (one request after a warm-up), "
          f"{120.0 / (serve_ms / 1e3):.1f} x realtime; launches {serve_launches}; lengths "
          f"{[len(r) for r in rows]}; phase {time.perf_counter() - t_serve:.1f} s", flush=True)
    del smodel, lm
    torch.cuda.empty_cache()

    t_par = time.perf_counter()
    raw2 = width_raw(widths, *parity_blocks)
    sd2 = conformer_train_model(dev, torch.float32, raw=raw2, seed=seed)[2]
    train_par = conformer_train_parity(sd2, dev, batch, raw=raw2, phase=f"{phase}c",
                                       launches=width_step_launches(parity_blocks[0]))
    card_m, card_lm, _, lsd2 = conformer_models(dev, torch.bfloat16, sd2, lm_blocks=2,
                                                raw=raw2)
    cpu_m, cpu_lm, _, _ = conformer_models("cpu", torch.float32, sd2, lsd2, lm_blocks=2,
                                           raw=raw2)
    j_cpu, cands, enc_cpu = first_step_joint(cpu_m, cpu_lm, audio[:1])
    j_card, _, enc_card = first_step_joint(card_m, card_lm, audio[:1], cands)
    e_enc, e_joint = rel_l2(enc_card, enc_cpu), rel_l2(j_card, j_cpu)
    check(enc_card.shape == (1, 468, d) and bool(torch.isfinite(enc_card).all())
          and e_enc <= CONF_REL_L2, f"{label} encoder rel L2 {e_enc} <= {CONF_REL_L2}")
    check(bool(torch.isfinite(j_card).all()) and e_joint <= CONF_REL_L2,
          f"{label} first-step joint scores rel L2 {e_joint} <= {CONF_REL_L2}")
    print(f"phase {phase}c {label} widths at {parity_blocks[0]} + {parity_blocks[1]} blocks, "
          f"card bf16 vs cpu f32: serving encoder rel L2 {e_enc:.3e}, first-step joint scores "
          f"rel L2 {e_joint:.3e} (phase 27's bound {CONF_REL_L2}); the train micro-step above "
          f"(phase 31's rule); phase {time.perf_counter() - t_par:.1f} s; phase {phase} "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del card_m, card_lm, cpu_m, cpu_lm
    torch.cuda.empty_cache()
    return {"train": {"launches": train_launches, "ms": ms, "busy": busy, "peak_gb": peak_gb,
                      "card_gb": card_gb,
                      "k4_shape": (TRAIN_B * t_enc, d, cfg.decoder.vocab_size)},
            "serve": {"launches": serve_launches, "ms": serve_ms},
            "parity": {"train": train_par, "enc": e_enc, "joint": e_joint}}



def k3_routes(dev) -> None:
    """`--k3-routes`: decode_attn.cu built (its registers and spills by
    instance), then phases 3L, 3s past 16 queries, 3w, 53 (on phase 4's
    model, with phase 5's CPU model and encoder output), 54 and 55, each as
    the full run makes it, with the seconds each took."""
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode
    from agacs_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.build("decode_attn")
    print(f"k3-routes: decode_attn built in {time.perf_counter() - t0:.1f} s; ptxas: "
          + ptxas_entries(cuda_lib.BUILD_LOG.get("decode_attn", "")), flush=True)
    laps = []
    for name, fn in (("3L", check_k3_long), ("3s", check_k3s_wide), ("3w", check_k3_forms)):
        t0 = time.perf_counter()
        fn(dev)
        laps.append((name, time.perf_counter() - t0))
    t0 = time.perf_counter()
    flags = dict(adapter=True, adapter_encoder=True, adapter_decoder=True)
    sd = tw.init_whisper_params(torch.Generator(device="cpu").manual_seed(0),
                                tw.make_config("small", **flags))
    model = tw.Whisper.from_state_dict(tw.make_config("small", compute_dtype=torch.bfloat16,
                                                      **flags), sd, device=dev)
    cpu_cfg = tw.make_config("small", compute_dtype=torch.float32, **flags)
    cpu_model = tw.Whisper.from_state_dict(cpu_cfg, sd, device="cpu")
    audio = (np.random.RandomState(0).randn(8, 15 * 16000) * 0.1).astype(np.float32)
    with torch.inference_mode():
        enc_c, _ = encode(cpu_model, ASRModelConfig(whisper=cpu_cfg),
                          torch.from_numpy(audio[:1]), torch.tensor([audio.shape[1]]))
    beam20_phase(model, ASRModelConfig(whisper=model.cfg), audio, cpu_model, enc_c)
    laps.append(("53", time.perf_counter() - t0))
    del model, cpu_model
    for name, fn in (("54", long_decode_phase), ("55", heads128_phase)):
        t0 = time.perf_counter()
        fn(dev)
        laps.append((name, time.perf_counter() - t0))
    print("k3-routes: seconds by phase " + ", ".join(f"{n} {t:.1f}" for n, t in laps),
          flush=True)

def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "agacs_tpu_torch")):
        sys.exit("chip_smoke: agacs_tpu_torch/ is not beside this script; "
                 "run it from a checkout of the repository")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs a CUDA card")
    if sys.argv[1:2] == ["--k3k5-turn"] and len(sys.argv) == 3:
        return k3k5_turn(os.path.abspath(sys.argv[2]))
    if sys.argv[1:2] == ["--warm-turn"] and len(sys.argv) == 3:
        return warm_turn(int(sys.argv[2]))
    sys.path.insert(0, ROOT)
    from agacs_tpu_torch.decode.speech2text import Speech2Text
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.asr_model import ASRModelConfig, encode
    from agacs_tpu_torch.ops import cuda_lib, decode_attn, flash_train
    from agacs_tpu_torch.utils import native

    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker(sys.argv[2], sys.argv[3:])
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    laps = [("start", t_start)]

    def lap(name: str) -> None:  # the seconds of each group of phases, printed at the end
        laps.append((name, time.perf_counter()))

    if sys.argv[1:2] == ["--mutants"]:
        mutants(dev, sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--splits"]:
        split_sweep(dev)
        return 0
    if sys.argv[1:2] == ["--k4-turns"] and len(sys.argv) == 3:
        k4_turns(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--k8q-turns"] and len(sys.argv) == 3:
        k8q_turns(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--k3k5-turns"] and len(sys.argv) == 3:
        k3k5_turns(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--warm-turns"]:
        warm_turns()
        return 0
    if sys.argv[1:2] == ["--k4-ablate"]:
        k4_ablate(dev)
        return 0
    if sys.argv[1:2] == ["--k3-routes"]:
        k3_routes(dev)
        return 0

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:  # one nvcc per source
        libs = [pool.submit(native.build_shared, native.SRC_DIR / f"{name}.cpp",
                            native.BUILD_DIR, os.environ.get("CXX", "g++"))
                for name in ("flac", "dtw", "align")]  # and g++ per host library
        list(pool.map(cuda_lib.build, ("packed_flash_fwd", "packed_flash_bwd",
                                       "decode_attn", "int8_gemm", "int8_mlp",
                                       "relpos_flash", "vocab_lse", "w8a16")))
        libs = [f.result().name for f in libs]
    build_s = time.perf_counter() - t0
    ptxas = "; ".join(
        f"{name}: {line.split(':', 1)[1].strip()}"
        for name, log in cuda_lib.BUILD_LOG.items()
        for line in log.splitlines() if "Used" in line and "registers" in line)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | kernels and host libraries "
          f"({', '.join(libs)}) built in {build_s:.2f} s | ptxas {ptxas or 'cached build'}",
          flush=True)
    print("phase 1 K1, K5, K2, K4, K8 and K3 ptxas: " + "; ".join(
        ptxas_entries(cuda_lib.BUILD_LOG.get(name, ""))
        for name in ("packed_flash_fwd", "packed_flash_bwd", "relpos_flash", "int8_mlp",
                     "vocab_lse", "int8_gemm", "decode_attn")), flush=True)
    lap("1")

    # 2-3s. each kernel against its plain version
    g = torch.Generator(device="cpu").manual_seed(0)
    check_k1(dev, g)
    k1f, k1b = check_k1_train(dev, g)
    k3 = check_k3(dev, g)
    k3a = check_k3a(dev, g)
    k3s = check_k3s(dev, g)
    k3pe = check_k3pe(dev, g)
    k3i8 = check_k3i8(dev, g)
    k8 = check_k8(dev, g)
    k8q = check_k8q(dev, g)
    k2 = check_k2(dev, g)
    lap("2-3s before K5")
    k5 = check_k5(dev, g)
    k5b = check_k5_bwd(dev, g)
    lap("2r-2s")
    k4 = check_k4(dev, g)
    k3f32 = check_k3f32(dev, g)
    k3w = check_k3_widths(dev, g)
    k6 = check_k6(dev, g)
    k3d48 = check_k3_d48(dev, g)
    lap("2v-3d")
    # 3L, 3s past 16 queries, 3w: K3 at every shape JAX's decode kernels take
    k3long = check_k3_long(dev)
    k3sw = check_k3s_wide(dev)
    k3forms = check_k3_forms(dev)
    lap("3L-3w")

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
    lap("4")

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
    lap("5")

    # 6. where the device time of one request goes
    profile_request(s2t, audio, ms_batch, n_steps)
    lap("6")

    # 10-12. the beam request, its profile, and its end-to-end checks
    beam = beam_phase(model, asr_cfg, audio)
    beam_e2e(model, asr_cfg, audio, beam, cpu_model, enc_c)
    lap("10-12")

    # 53. the beam-20 slice: K3a over 160 rows, K3s at 20 queries a group
    b20 = beam20_phase(model, asr_cfg, audio, cpu_model, enc_c)
    lap("53")

    # 18. int8 cross-KV serving on the same model
    cross8 = int8_cross_phase(model, sd, asr_cfg, audio, {"s2t": s2t, "results": results},
                              beam)
    del s2t, model, cpu_model, beam["s2t"]
    torch.cuda.empty_cache()
    lap("18")

    # 7-9. the training path
    train = train_phase(sd, dev)
    bf16_loss = train_parity(sd, dev, train["batch"])
    lap("7-9")

    # 13-16. the int8 frozen trunk: training, its profile, parity, serving
    train8 = train_phase(sd, dev, int8=True, bf16=train)
    sd8 = int8_state(sd, dev)
    int8_train_parity(sd8, dev, train["batch"], bf16_loss)
    serve8 = int8_serve_phase(sd8, dev, audio)
    lap("13-16")

    # 32-33. K6: the int8 trunk under AGACS_W8A16, then a serving-quantised
    # model (int8 trunk, token table and logits head)
    w8 = w8a16_serve_phase(sd8, dev, audio, serve8)
    del sd8, serve8["results"]
    serving_quant_phase(sd, dev, audio)
    cli_phase()
    lap("32-33")

    # 19-24. PE attention: serving a PE decoder, training the cs_loss_pe
    # recipe, and the CLIs on a PE recipe
    pe_serve = pe_serve_phase(dev, audio)
    pe_train_phase(dev)
    pe_cli_phase()
    lap("19-24")

    # 34-35. the ladder side network: serving and `sidenetwork` training
    side = side_serve_phase(dev, audio)
    side_train = side_train_phase(dev)
    lap("34-35")

    # 25-28. the conformer recipe's serving (stage 4) and its CLIs (4, 5)
    conf = conformer_serve_phase(dev, audio)
    conformer_cli_phase(conf.pop("sd"))
    lap("25-28")

    # 29-31. the conformer recipe's training (stage 3) at full width
    conf_train = conformer_train_phase(dev)
    conformer_train_parity(conf_train.pop("sd"), dev, conf_train.pop("batch"))
    lap("29-31")

    # 36-38. the TMECS full fine-tune with a CTC head: K4 above K 256
    wctc = whisper_ctc_phase(dev)
    whisper_ctc_parity(wctc.pop("sd"), dev, wctc.pop("batch"))
    lap("36-38")

    # 39. recipes/seame/run.sh stages 0-6 through the port's CLIs
    seame_recipe_phase(smi)
    lap("39")

    # 40. the train CLI's options: resume, batch types, augmentation, prefetch
    trainer_options_phase(sd, dev, smi)
    lap("40")

    # 41-45. the transducer family: K4 at the joint's K 320, the recipe's
    # step, its parity with the CPU, decoding, and the CLIs
    k4j = check_k4_joint(dev, g)
    trans_train = trans_train_phase(dev)
    trans_train_parity(trans_train["sd"], dev)
    trans_decode_phase(trans_train.pop("sd"), dev)
    trans_cli_phase(smi)
    lap("41-45")

    # 48. multi-GPU training through torchrun: NCCL at one rank (ZeRO-1, DCP,
    # resume), 2 gloo ranks on the one card, the int8 trunk; while its
    # processes start and train, 46-47: the whisper family's fused beam (CTC,
    # LM, n-gram) and long-form transcription with word timestamps
    dist_train_phase(smi, lambda: (whisper_fusion_phase(dev, audio), long_form_phase(dev)))
    lap("48")

    # 49. whisper-large at full width: K4 above K 1024, the kernels at its
    # shapes, the stage-2 step (bf16, int8 trunk), the CTC full fine-tune,
    # greedy serving (bf16, int8 trunk), card against CPU
    large = whisper_large_phase(dev, g, audio)
    lap("49")

    # 50. the conformer at XLarge widths (d 1024, heads of 128): training,
    # beam serving with the LM, and card against CPU at 2 + 2 blocks
    xl = width_phase(dev, audio, "50", "XLarge conformer", XL_WIDTHS, XL_BLOCKS,
                     XL_PARITY_BLOCKS, XL_SEED, XL_TRAIN_STEPS)
    lap("50")

    # 51. the recipe's conformer with one encoder head of 256 (K5's wide
    # route): training, beam serving with the LM, and card against CPU at
    # 2 + 1 blocks
    h1 = width_phase(dev, audio, "51", "one-head conformer", H1_WIDTHS, H1_BLOCKS,
                     H1_PARITY_BLOCKS, H1_SEED, H1_TRAIN_STEPS)
    lap("51")

    # 52. the conformer at USM-2B's width (d 1536, 16 heads of 96): K4 at K
    # 1536 on the CTC head, training, beam serving with the LM, and card
    # against CPU at 2 + 1 blocks
    usm = width_phase(dev, audio, "52", "USM-2B-width conformer", USM_WIDTHS, USM_BLOCKS,
                      USM_PARITY_BLOCKS, USM_SEED, USM_TRAIN_STEPS)
    check(usm["train"]["peak_gb"] <= 0.9 * usm["train"]["card_gb"],
          f"phase 52's step leaves ~10% of the card free: peak {usm['train']['peak_gb']:.2f} GB")
    check(usm["train"]["k4_shape"] == K4_USM,
          f"phase 2v held and timed K4 at phase 52's CTC head: {usm['train']['k4_shape']}")
    lap("52")

    # 54. the long route on the conformer recipe's decoder and LM past 8192
    # steps; 55. the whisper-only forms at d_head 128 on a whisper decoder
    longp = long_decode_phase(dev)
    lap("54")
    h128 = heads128_phase(dev)
    lap("55")

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "agacs_tpu") for m in sys.modules),
          "no jax, jaxlib or agacs_tpu module was imported")

    def entry(name, source, replaces, launches, res):
        return {"name": name, "route": "cuda", "source": "agacs_tpu_torch/csrc/" + source,
                "replaces": replaces, "launches": launches, "max_abs_err": res["err"],
                **{k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}}

    kernels = [
        entry("packed_flash_fwd (K1f, encoder self-attention forward)",
              "packed_flash_fwd.cu", "agacs_tpu/ops/flash_train.py:155",
              train["launches"]["K1f"], k1f),
        entry("packed_flash_bwd (K1b, encoder self-attention backward)",
              "packed_flash_bwd.cu", "agacs_tpu/ops/flash_train.py:177",
              train["launches"]["K1b"], k1b),
        entry("decode_attn_fwd (K3, decode-step cache attention)", "decode_attn.cu",
              "agacs_tpu/ops/decode_attn.py:140", launches["K3"], k3),
        entry("decode_attn_anc_fwd (K3a, beam self-attention through the ancestry map)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140",
              beam["launches"]["K3a"], k3a),
        entry("decode_attn_shared_fwd (K3s, beam cross-attention, shared cross-KV)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:830",
              beam["launches"]["K3s"], k3s),
        entry("decode_attn_fwd PE (K3-PE, a PE decoder's greedy self-attention)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140",
              pe_serve["greedy"]["K3-PE"], k3pe["pe"]),
        entry("decode_attn_fwd PE + ancestry (K3a-PE, a PE decoder's beam self-attention)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140",
              pe_serve["beam"]["K3a-PE"], k3pe["anc_pe"]),
        entry("decode_attn_fwd int8 (K3-int8, greedy cross-attention, int8 cross-KV)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140",
              cross8["greedy"]["K3-int8"], k3i8["rows"]),
        entry("decode_attn_shared_fwd int8 (K3s-int8, beam cross-attention, int8 "
              "cross-KV)", "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:830",
              cross8["beam"]["K3s-int8"], k3i8["shared"]),
        entry("decode_attn_fwd int8 + ancestry (K3a-int8; no decode step launches it)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140", 0, k3i8["anc"]),
        entry("int8_mlp_fwd (K2f, fused W8A8 MLP forward)", "int8_mlp.cu",
              "agacs_tpu/ops/int8_mlp.py:112", train8["launches"]["K2f"], k2["fwd"]),
        entry("int8_mlp_bwd (K2b, fused W8A8 MLP dx)", "int8_mlp.cu",
              "agacs_tpu/ops/int8_mlp.py:126", train8["launches"]["K2b"], k2["bwd"]),
        entry("int8_rowquant (K8q, per-row int8 quantisation ahead of the wide K8g; "
              "(12000, 768))", "int8_gemm.cu", "agacs_tpu/ops/int8_linear.py:65",
              train8["launches"]["K8q"], k8q[0]),
        entry("int8_gemm (K8g, W8A8 linear forward, wide: s8 wgmma fed by TMA)",
              "int8_gemm.cu", "agacs_tpu/ops/int8_linear.py:83", train8["launches"]["K8g"],
              k8["fwd"]),
        entry("int8_gemm dgrad (K8g, W8A8 linear dx against w_q^T, wide)", "int8_gemm.cu",
              "agacs_tpu/ops/int8_linear.py:108", train8["launches"]["K8g dgrad"],
              k8["dgrad"]),
        entry("int8_thin_matmul (K8q folded into the thin K8g: the int8-trunk decode "
              "step's products, 64 rows or fewer, one launch)", "int8_gemm.cu",
              "agacs_tpu/ops/int8_linear.py:83", serve8["thin"], k8["thin"]),
        entry("relpos_flash_fwd (K5, the conformer encoder's rel-pos self-attention)",
              "relpos_flash.cu", "agacs_tpu/ops/relpos_flash.py:298",
              conf["launches"]["K5"], k5),
        entry("decode_attn_f32_fwd (K3-f32, the transformer LM's float32 cache attention)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140",
              conf["launches"]["K3-f32"], k3f32),
        entry("relpos_flash_bwd (K5 backward, the conformer encoder's rel-pos attention "
              "gradients)", "relpos_flash.cu", "agacs_tpu/ops/relpos_flash.py:320",
              conf_train["launches"]["K5 bwd"], k5b),
        entry("vocab_lse_fwd (K4, the CTC head's streaming log-sum-exp)", "vocab_lse.cu",
              "agacs_tpu/ops/vocab_lse.py:169", conf_train["launches"]["K4"], k4["fwd"]),
        entry("vocab_lse_dx (K4 dx, its gradient in the encoder output)", "vocab_lse.cu",
              "agacs_tpu/ops/vocab_lse.py:207", conf_train["launches"]["K4 dx"], k4["dx"]),
        entry("vocab_lse_dw (K4 dw, its gradient in the head's weight and bias)",
              "vocab_lse.cu", "agacs_tpu/ops/vocab_lse.py:224", conf_train["launches"]["K4 dw"],
              k4["dw"]),
        entry("vocab_lse_fwd at K > 256 (K4, the whisper CTC head: 64 x 64 W chunks)",
              "vocab_lse.cu", "agacs_tpu/ops/vocab_lse.py:169", wctc["launches"]["K4"],
              k4["wide"]["fwd"]),
        entry("vocab_lse_dx at K > 256 (K4 dx, the whisper CTC head: the K-wide accumulator "
              "split over a cluster)", "vocab_lse.cu", "agacs_tpu/ops/vocab_lse.py:207",
              wctc["launches"]["K4 dx"], k4["wide"]["dx"]),
        entry("vocab_lse_dw at K > 256 (K4 dw, the whisper CTC head: the K-wide accumulator "
              "split over a cluster)", "vocab_lse.cu", "agacs_tpu/ops/vocab_lse.py:224",
              wctc["launches"]["K4 dw"], k4["wide"]["dw"]),
    ]
    # the joint's launches: half of the step's K4 launches, the other half the
    # CTC head's (phase 42's profile tells them apart by kernel)
    joint = [entry(f"vocab_lse_{part} at the transducer joint's K 320 (K4 {part}, K padded to "
                   f"384 in the wrapper; timed at N {K4_JOINT_SLICE}, step_* at the step's N)",
                   "vocab_lse.cu", f"agacs_tpu/ops/vocab_lse.py:{line}",
                   trans_train["launches"][key] // 2, k4j[part])
             for part, line, key in (("fwd", 169, "K4"), ("dx", 207, "K4 dx"),
                                     ("dw", 224, "K4 dw"))]
    for row, part in zip(joint, ("fwd", "dx", "dw")):
        row.update(step_n=TRANS_B * TRANS_T * (TRANS_U + 1), step_ms=k4j["full"][part]["ms"],
                   step_bound_ms=k4j["full"][part]["bound_ms"])
    kernels += joint
    # whisper-large (phase 49): K4 above K 1024 on its CTC head, and the
    # other kernels of its paths timed at its shapes
    lg = large
    kernels += [
        entry(f"vocab_lse_{part} at K {K4_LARGE[1]} (K4 {part}, the whisper-large CTC head"
              + ("" if part == "fwd" else ": the split kernel on a non-portable cluster of 10")
              + ")", "vocab_lse.cu", f"agacs_tpu/ops/vocab_lse.py:{line}",
              lg["ctc"]["launches"][key], lg["k4"][part])
        for part, line, key in (("fwd", 169, "K4"), ("dx", 207, "K4 dx"), ("dw", 224, "K4 dw"))]
    kernels += [
        entry("packed_flash_fwd at whisper-large (K1f, (16, 750, 1280), 20 heads)",
              "packed_flash_fwd.cu", "agacs_tpu/ops/flash_train.py:155",
              lg["train"]["launches"]["K1f"], lg["k1f"]),
        entry("packed_flash_bwd at whisper-large (K1b, (16, 750, 1280), 20 heads)",
              "packed_flash_bwd.cu", "agacs_tpu/ops/flash_train.py:177",
              lg["train"]["launches"]["K1b"], lg["k1b"]),
        entry("decode_attn_fwd at whisper-large (K3, greedy cross (8, 752, 1280), 20 heads)",
              "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140",
              lg["serve16"]["launches"]["K3"], lg["k3"]),
        entry("int8_rowquant at whisper-large (K8q, (12000, 1280))", "int8_gemm.cu",
              "agacs_tpu/ops/int8_linear.py:65", lg["train8"]["launches"]["K8q"],
              k8q[1]),
        entry("int8_rowquant at whisper-large's fc2 input (K8q, (12000, 5120); launches: "
              "the large int8 step's, every width)", "int8_gemm.cu",
              "agacs_tpu/ops/int8_linear.py:65", lg["train8"]["launches"]["K8q"],
              k8q[2]),
        entry("int8_rowquant with the dgrad's column scale (K8q, (12000, 5120) x w_s, "
              "whisper-large's fc1 dgrad; launches: the large int8 step's, every width)",
              "int8_gemm.cu", "agacs_tpu/ops/int8_linear.py:65", lg["train8"]["launches"]["K8q"],
              k8q[3]),
        entry("int8_gemm at whisper-large (K8g wide, (12000, 1280) -> 1280)", "int8_gemm.cu",
              "agacs_tpu/ops/int8_linear.py:83", lg["train8"]["launches"]["K8g"], lg["k8"]["fwd"]),
        entry("int8_gemm dgrad at whisper-large (K8g wide, (12000, 1280) -> 1280)",
              "int8_gemm.cu", "agacs_tpu/ops/int8_linear.py:108",
              lg["train8"]["launches"]["K8g dgrad"], lg["k8"]["dgrad"]),
        entry("int8_thin_matmul at whisper-large (K8q folded into the thin K8g, (8, 1280) -> "
              "1280)", "int8_gemm.cu", "agacs_tpu/ops/int8_linear.py:83", lg["serve8"]["thin"],
              lg["k8"]["thin"]),
    ]
    kernels += [
        entry("w8a16_matmul (K6, the W8A16 thin-row matmul: 8-row decode products under "
              "AGACS_W8A16 and the int8 logits head)", "w8a16.cu",
              "agacs_tpu/ops/int8_serve.py:80", w8["launches"]["K6"], k6),
        entry("decode_attn_d48_fwd (K3 at d_head 48, the side ladder's self- and "
              "cross-attention)", "decode_attn.cu", "agacs_tpu/ops/decode_attn.py:140",
              side["greedy"]["K3@48"], k3d48),
    ]
    kernels += [
        entry("relpos_flash_fwd at d_head 128 (K5's 128 instance: the XLarge conformer, "
              "(8, 468, 1024), 8 heads; padded d_head 96 runs it too)", "relpos_flash.cu",
              "agacs_tpu/ops/relpos_flash.py:298", xl["train"]["launches"]["K5"], k5["w128"]),
        entry("relpos_flash_bwd at d_head 128 (K5 backward's 128 instance, (8, 468, 1024))",
              "relpos_flash.cu", "agacs_tpu/ops/relpos_flash.py:320",
              xl["train"]["launches"]["K5 bwd"], k5b["w128"]),
        entry("relpos_flash_fwd at d_head 32 (K5's 32 instance, d 256 / 8 heads; no main path "
              "runs a d_head-32 model: checked in phase 2r)", "relpos_flash.cu",
              "agacs_tpu/ops/relpos_flash.py:298", 0, k5["w32"]),
        entry("relpos_flash_bwd at d_head 32 (no main path runs a d_head-32 model: checked "
              "in phase 2s)", "relpos_flash.cu", "agacs_tpu/ops/relpos_flash.py:320", 0,
              k5b["w32"]),
        entry("relpos_wide_fwd (K5 above d_head 128: heads padded to a multiple of 128, "
              "streamed in 128-wide chunks, a grid axis over the output's chunks; (8, 468, "
              "1024), 4 heads of 256; launches: phase 51's)", "relpos_flash.cu",
              "agacs_tpu/ops/relpos_flash.py:298", h1["train"]["launches"]["K5"], k5["wide"]),
        entry("relpos_wide_bwd (K5 backward above d_head 128: rowdot, dkdv and dq on the "
              "chunks; (8, 468, 1024), 4 heads of 256; launches: phase 51's)",
              "relpos_flash.cu", "agacs_tpu/ops/relpos_flash.py:320",
              h1["train"]["launches"]["K5 bwd"], k5b["wide"]),
        entry("relpos_wide_fwd at phase 51's width ((16, 468, 256), 1 head of 256)",
              "relpos_flash.cu", "agacs_tpu/ops/relpos_flash.py:298",
              h1["train"]["launches"]["K5"], k5["wide1"]),
        entry("relpos_wide_bwd at phase 51's width ((16, 468, 256), 1 head of 256)",
              "relpos_flash.cu", "agacs_tpu/ops/relpos_flash.py:320",
              h1["train"]["launches"]["K5 bwd"], k5b["wide1"]),
        entry("decode_attn_rows_fwd (K3's plain rows at d_head 128: the XLarge conformer "
              "decoder's self-attention, (80, 112, 1024), 8 heads)", "decode_attn.cu",
              "agacs_tpu/ops/decode_attn.py:140", xl["serve"]["launches"]["K3"], k3w["bf16"]),
        entry("decode_attn_rows_fwd float32 (K3-f32 at d_head 128; no main path runs an LM "
              "of that width: checked in phase 3f)", "decode_attn.cu",
              "agacs_tpu/ops/decode_attn.py:140", 0, k3w["f32"]),
    ]
    # above K 1280 (phase 2v): phase 52's CTC head at K 1536, and K 2048 and
    # 4224 (the stream forward, a cluster of 8; two groups of 9) on no path
    for kk, launches, what in (
            (1536, usm["train"]["launches"], "phase 52's CTC head at USM-2B's width: KS-256 "
             "slices on clusters of 6"),
            (2048, None, "a cluster of 8, the forward streaming x"),
            (4224, None, "K padded to 4608, 2 groups of 9 ranks each recomputing S")):
        kernels += [
            entry(f"vocab_lse_{part} at K {kk} (K4 {part}, {what}"
                  + ("" if launches else "; no main path runs this K: checked in phase 2v")
                  + ")", "vocab_lse.cu", f"agacs_tpu/ops/vocab_lse.py:{line}",
                  launches[key] if launches else 0, k4["any"][kk][part])
            for part, line, key in (("fwd", 169, "K4"), ("dx", 207, "K4 dx"),
                                    ("dw", 224, "K4 dw"))]
    # K3 at every shape JAX's decode kernels take (phases 3L, 3s, 3w, 53-55)
    k3_src, k3_chunked, k3_shared = ("decode_attn.cu", "agacs_tpu/ops/decode_attn.py:341",
                                     "agacs_tpu/ops/decode_attn.py:830")
    kernels += [
        entry("decode_attn_long_fwd (K3's long route, the counterpart of _call_chunked: a "
              "block's keys in passes with the online-softmax carry; phase 54's conformer "
              "decoder rows, bf16 (10, 65616, 256), 4 heads, pos 8200, three passes of 4096 in "
              "a block of 8202 keys; launches: phase 54's decoder)", k3_src, k3_chunked,
              longp["by_model"]["decoder"], k3long[K3L_PHASE54[0]]),
        entry("decode_attn_long_fwd float32 (phase 54's LM rows, (10, 65616, 512), 8 heads, "
              "pos 8200, three passes of 4096 in a block of 9374 keys; launches: phase 54's "
              "LM)", k3_src, k3_chunked, longp["by_model"]["LM"], k3long[K3L_PHASE54[1]]),
    ] + [entry(f"decode_attn_long_fwd {what}; no main path runs this shape: checked in phase "
               "3L)", k3_src, k3_chunked, 0, k3long[label])
         for label, what in (
             ("rows at 65536 keys", "(bf16 rows at (10, 65536, 256), 4 heads, pos 65535, in "
              "tables and passes of 4096: two passes a block of 8192 keys"),
             ("conformer decoder rows", "in passes of 1024 (bf16 rows at (10, 8256, 256), 4 "
              "heads, pos 8200"),
             ("LM rows (K3-f32)", "float32 in passes of 1024 (rows at (10, 8256, 512), 8 "
              "heads, pos 8200"))] + [
        entry("decode_attn_shared_fwd past 16 beams (K3s at beam 20 in two query tiles, (8 x "
              "20, 1504, 768); launches: phase 53's)", k3_src, k3_shared,
              b20["launches"]["K3s"], k3sw[("bf16", 64, 20)]),
        entry("decode_attn_shared_fwd int8 past 16 beams (K3s-int8 at beam 20; no main path "
              "runs int8 cross-KV at beam 20: checked in phase 3s)", k3_src, k3_shared, 0,
              k3sw[("int8", 64, 20)]),
        entry("decode_attn_forms_fwd (K3a-PE at d_head 128, (40, 112, 768), 6 heads: phase "
              "55's whisper decoder)", k3_src, "agacs_tpu/ops/decode_attn.py:140",
              h128["launches"]["K3a-PE"], k3forms["anc_pe"]),
        entry("decode_attn_shared_fwd int8 at d_head 128 (K3s-int8 on two 64-channel sub-rows, "
              "(8 x 5, 1504, 768), 6 heads: phase 55's cross-attention)", k3_src, k3_shared,
              h128["launches"]["K3s-int8"], k3sw[("int8", 128, 5)]),
    ] + [entry(f"decode_attn_forms_fwd ({name} at d_head 128, (40, 112 or 128, 768), 6 heads; "
               "no main path runs it: checked in phase 3w)", k3_src,
               "agacs_tpu/ops/decode_attn.py:140", 0, k3forms[form])
         for form, name in (("anc", "K3a"), ("pe", "K3-PE"), ("int8", "K3-int8"),
                            ("anc_int8", "K3a-int8"))]
    check(serve8["launches"]["K2f"] > 0 and serve8["launches"]["K8g"] > 0,
          "int8 serving launched K2f and K8g")
    check(side_train["launches"]["K1b"] == 0 and all(
        k["launches"] > 0 for k in kernels
        if "no decode step" not in k["name"] and "no main path" not in k["name"]),
          "every kernel of the paths launched on its path, K1b none in side training")
    print(f"cuda_ms: {CUDA_MS['timings']} timings, {len(CUDA_MS['retaken'])} retaken call "
          f"by call {sorted(set(CUDA_MS['retaken']))}, {len(CUDA_MS['not_held'])} calls whose "
          f"hold ran out before they were enqueued {sorted(set(CUDA_MS['not_held']))}; the "
          f"largest host time to enqueue a held call {CUDA_MS['enqueue_ms']:.3f} ms "
          f"({CUDA_MS['enqueue_by']})", flush=True)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s; seconds "
          "by group of phases: " + ", ".join(f"{name} {t - laps[i][1]:.1f}"
                                             for i, (name, t) in enumerate(laps[1:])),
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
