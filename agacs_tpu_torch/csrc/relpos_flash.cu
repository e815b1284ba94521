// K5: Transformer-XL relative-position multi-head attention, forward and
// backward (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// agacs_tpu/ops/relpos_flash.py (`relpos_mha` -> `_fwd_pallas`, and its
// custom VJP -> `_bwd_pallas`), the conformer encoder's rel-pos
// self-attention. Same function: per head h, with qu = q + pos_bias_u and
// qv = q + pos_bias_v given,
//
//   s[q, j] = (qu[q] . k[j] + qv[q] . pe[T-1-q+j]) * d_head^-0.5 + mask[j]
//
// with bf16 inputs and float32 accumulation, the additive mask (0 or -1e30
// per key), a float32 softmax, the UN-normalized p cast to bf16 for the
// value product with float32 accumulation, and the division by the row sum
// at the end. pe holds the projected positions T-1 .. -(T-1) in rows
// 0 .. 2T-2; rows from 2T-1 on (the JAX padding to a multiple of 128) are
// never read. Under autograd the forward also writes each row's float32
// max m (in the units of s) and sum l, (B, H, T), which the backward reads.
//
// What bounds it here: at the recipe's serving shape (B=8, T=468, 4 heads
// of 64) the forward is 3 products of 2*B*H*T*T*64 (2.7 GFLOP) against
// ~10 MB of qu/qv/k/v/pe/mask/o, and the backward at the training shape
// (B=16) 8 such products (14.4 GFLOP) against ~40 MB: the tensor cores
// bound both, not HBM.
//
// The TPU kernel held a head's whole (T, T) content scores and (T, Wp)
// position scores in VMEM and realigned the position scores with a strided
// lane rotate, because Mosaic has no per-row gather. A Hopper SM has 227 KB
// of shared memory, so these kernels stream 64-key (or 64-query) tiles with
// an online softmax and turn the shift into an index:
//
// The position block. For the 64 query rows qa.. of a warpgroup and the
// 64 keys k0.. of a tile, every pe row a (q, j) pair reads lies in the
// 128-row window from T-1-(qa+63)+k0, so Pw = Qv . window^T is a 64 x 128
// wgmma product (two m64n64 halves), and bd[q, j] = Pw[r, 63-r+c] with
// r = q-qa, c = j-k0. The shift moves values between threads, so each
// warp stages the 80 columns of Pw its own 16 rows read (48-16w .. 127-16w)
// in float32 in shared memory, row stride PL = 88 floats (float2 stores
// without bank conflicts), and reads them back at the shifted column. bd
// stays float32 as JAX adds it.
//
// The pe tensor map is 2D over (H*64 columns, 2T-1 rows): its row extent
// ends at 2T-1, not at pe's own rows, so the JAX padding rows read as
// zeros whatever they hold, and a box that starts at a negative row (the
// last query tile's window) is zero-filled before row 0. Only padded
// queries or keys ever read such rows.
//
// Forward: one block per (128 query rows, head, batch row): two consumer
// warpgroups of 64 rows each and a producer warp. The producer loads the
// block's qu and qv once and streams 64-key k and v tiles, the 192-row pe
// tile that holds both warpgroups' windows, and the tile's mask strip,
// through a 2-stage ring (TMA, full/empty mbarriers). A warpgroup computes
// and stages the position block, then S = Qu K^T, adds the shifted block,
// masks, and runs the online softmax on the accumulator
// registers (quad shuffles, ex2 with log2 e folded in), packs p to bf16 as
// the register A operand of O += P V (v read MN-major). Keys past T (TMA
// zero-fills them, which would score bd * 0.125 + 0) get -inf by index
// before the max.
//
// Registers: three warpgroups leave 168 a thread; the producer warpgroup
// hands registers to the consumers at the start (setmaxnreg: 56 a producer
// thread, 224 a consumer thread). ptxas still reports 168 for every kernel
// here, and the dq pass spills (chip_smoke.py's phase 1 prints both).

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;                 // head width
constexpr int BR = 128;                // rows a block owns (queries, or keys in dkdv)
constexpr int BS = 64;                 // rows per streamed tile (keys, or queries in dkdv)
constexpr int PR = 192;                // pe rows a tile reads: both warpgroups' windows
constexpr int THREADS = 3 * 128;       // two consumer warpgroups, a producer warpgroup
constexpr int PL = 88;                 // f32 row stride of a staged position block
constexpr int OWN = BR * DH * 2;       // bytes of a 128-row tile
constexpr int STR = BS * DH * 2;       // bytes of a 64-row tile
constexpr int PEB = PR * DH * 2;       // bytes of a pe tile
constexpr float SCALE = 0.125f;        // 64^-0.5
constexpr float LOG2E = 1.4426950408889634f;

// Stage the columns [48-16w, 128-16w) of one 64 x 64 half (columns c0 ..
// c0+63) of a warpgroup's position block: row r of warp w at
// pw[r * PL + col - (48 - 16w)]. The test on the 8-column block is the
// same for the whole warp.
__device__ __forceinline__ void stage_half(float* pw, const float (&a)[32], int c0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int x = c0 + 8 * (i >> 2) - 48 + 16 * warp;
    if (x >= 0 && x < 80) {
      const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
      *reinterpret_cast<float2*>(pw + r * PL + x + 2 * t) = make_float2(a[i], a[i + 1]);
    }
  }
}

// Both halves of the position block Pw = Qv . window^T (qv: the
// warpgroup's 64 rows, K-major; window: 128 pe rows, K-major) into the
// staging buffer. Issued and waited here, so only 32 accumulators live.
__device__ __forceinline__ void position_block(float* pw, uint64_t qvd, uint64_t wd) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float a[32];
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hop::wgmma_ss_n64(a, qvd + 2 * kc, wd + half * (64 * 128 >> 4) + 2 * kc, kc);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(a);
    stage_half(pw, a, 64 * half);
  }
}

// The shifted position score of accumulator element i of this thread (row
// r = 16w + g (+8), key column c): Pw[r, 63-r+c] from the staging buffer.
__device__ __forceinline__ float shifted(const float* pw, int i) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r = (lane >> 2) + 8 * ((i >> 1) & 1);  // the row within the warp's 16
  const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
  return pw[(16 * warp + r) * PL + 15 - r + c];
}

// The 3D tile maps and the pe map of the forward and the dq pass: the
// block's own 128 query rows, the streamed 64-key tiles and the pe tile.
struct QMaps {
  CUtensorMap own[3];  // fwd: qu, qv; dq: qu, qv, do
  CUtensorMap k, v, pe;
};

struct SmemF {
  alignas(1024) bf16 qu[BR * DH];
  alignas(1024) bf16 qv[BR * DH];
  alignas(1024) bf16 k[3][BS * DH];
  alignas(1024) bf16 v[3][BS * DH];
  alignas(1024) bf16 pe[3][PR * DH];
  float pw[2][64 * PL];  // each warpgroup's staged position block
  float mask[3][BS];     // the key tile's mask strip
  uint64_t own_full, full[3], empty[3];
  static constexpr bool kTma = false;
};

// The producer of the forward and the dq pass (one warp): the block's own
// tiles, then for every 64-key tile its k, v, pe tile (from row
// T-1-(q0+127)+k0) and mask strip (lane 0 issues the copies, every lane
// stores two mask values and arrives).
template <int ST, class S>
__device__ __forceinline__ void produce_keys(S& sm, const QMaps& mp, bf16* const* own,
                                             int n_own, const float* mask, int T) {
  const int lane = threadIdx.x & 31, c = blockIdx.y * DH, b = blockIdx.z;
  const int q0 = blockIdx.x * BR, n_tiles = (T + BS - 1) / BS;
  if (lane == 0) {
    hop::mbar_expect_tx(&sm.own_full, n_own * OWN);
    for (int i = 0; i < n_own; ++i) hop::tma_load(own[i], &mp.own[i], &sm.own_full, c, q0, b);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, k0 = it * BS;
    hop::mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
    for (int i = lane; i < BS; i += 32)
      sm.mask[s][i] = k0 + i < T ? mask[(size_t)b * T + k0 + i] : 0.f;
    if (lane == 0) {
      hop::mbar_expect_tx(&sm.full[s], 2 * STR + PEB);
      hop::tma_load(sm.k[s], &mp.k, &sm.full[s], c, k0, b);
      hop::tma_load(sm.v[s], &mp.v, &sm.full[s], c, k0, b);
      hop::tma_load_2d(sm.pe[s], &mp.pe, &sm.full[s], c, T - 1 - (q0 + BR - 1) + k0);
    } else {
      hop::mbar_arrive(&sm.full[s]);
    }
  }
}

// The 1024-byte aligned shared storage, its barriers initialised (`tma`,
// where a kernel has it: the streamed copies, which its producer waits for).
template <class S, int ST>
__device__ __forceinline__ S& setup(unsigned char* raw) {
  S& sm = *reinterpret_cast<S*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    hop::mbar_init(&sm.own_full, 1);
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      hop::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
      if constexpr (S::kTma) hop::mbar_init(&sm.tma[s], 1);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// Store rows row0 and row0 + 8 (if < T) of a warp's accumulator, each
// divided by its own value of `div` (1 for none).
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[32], int row0,
                                           int T, int D, float div0, float div1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const float dv = half ? div1 : div0;
    if (row < T) {
      bf16* out = dst + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] / dv, acc[4 * j + 2 * half + 1] / dv);
    }
  }
}

constexpr int FST = 2;  // the forward's ring depth

__global__ void __launch_bounds__(THREADS, 1)
relpos_flash_fwd_kernel(const __grid_constant__ QMaps mp, const float* __restrict__ mask,
                        bf16* __restrict__ o, float* __restrict__ row_m,
                        float* __restrict__ row_l, int T, int H) {
  extern __shared__ unsigned char smem_raw[];
  SmemF& sm = setup<SmemF, FST>(smem_raw);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T + BS - 1) / BS;
  if (tid >= 256) {
    hop::reg_dealloc<56>();
    if (tid < 256 + 32) {
      bf16* own[2] = {sm.qu, sm.qv};
      produce_keys<FST>(sm, mp, own, 2, mask, T);
    }
    return;
  }
  hop::reg_alloc<224>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const uint64_t qud = hop::desc(sm.qu, wg * 64 * 128), qvd = hop::desc(sm.qv, wg * 64 * 128);
  float* pw = sm.pw[wg];
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // rows g and g + 8 of the warp's 16: running max of s, this lane's share of the sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  hop::mbar_wait(&sm.own_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % FST, k0 = it * BS;
    hop::mbar_wait(&sm.full[s], (it / FST) & 1);

    // The position block's halves (against the warpgroup's pe window, the
    // tile's rows from 64 (1 - wg)) and S = qu k^T, issued together; each
    // half is staged while the later products are in flight.
    const uint64_t wd = hop::desc(sm.pe[s], (1 - wg) * 64 * 128);
    float plo[32], phi[32], sc[32];
    __syncwarp();
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) hop::wgmma_ss_n64(plo, qvd + 2 * kc, wd + 2 * kc, kc);
    hop::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hop::wgmma_ss_n64(phi, qvd + 2 * kc, wd + (64 * 128 >> 4) + 2 * kc, kc);
    hop::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hop::wgmma_ss_n64(sc, qud + 2 * kc, hop::desc(sm.k[s]) + 2 * kc, kc);
    hop::wgmma_commit();
    hop::wgmma_wait_n<2>();
    hop::fence_regs(plo);
    stage_half(pw, plo, 0);
    hop::wgmma_wait_n<1>();
    hop::fence_regs(phi);
    stage_half(pw, phi, 64);
    hop::wgmma_wait();
    hop::fence_regs(sc);
    __syncwarp();

#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = (sc[i] + shifted(pw, i)) * SCALE + sm.mask[s][8 * (i >> 2) + 2 * t + (i & 1)];
    if (k0 + BS > T) {  // the key tail: zero-filled keys must not score bd * 0.125
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= T) sc[i] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // finite: key 0 is in the first tile. The rescale is 0 on that tile.
    const float a0 = hop::ex2((m0 - mx0) * LOG2E), a1 = hop::ex2((m1 - mx1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? a1 : a0;

    // p = exp(s - m) into the bf16 A fragments of P.V
    const float mc0 = m0 * LOG2E, mc1 = m1 * LOG2E;
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float mc = (i & 2) ? mc1 : mc0;
      const float p0 = hop::ex2(fmaf(sc[i], LOG2E, -mc));
      const float p1 = hop::ex2(fmaf(sc[i + 1], LOG2E, -mc));
      if (i & 2) l1 += p0 + p1;
      else l0 += p0 + p1;
      pa[i >> 1] = hop::pack_bf16(p0, p1);
    }

    // acc (64 x 64) += p (bf16) v
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk)
      hop::wgmma_rs_n64_t(acc, &pa[4 * kk], hop::desc(sm.v[s], kk * 16 * 128));
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int D = H * DH, row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  store_rows(o + (size_t)b * T * D + (size_t)h * DH, acc, row0, T, D, l0, l1);
  if (row_m != nullptr && t == 0) {
    const size_t at = ((size_t)b * H + h) * T + row0;
    if (row0 < T) {
      row_m[at] = m0;
      row_l[at] = l0;
    }
    if (row0 + 8 < T) {
      row_m[at + 8] = m1;
      row_l[at + 8] = l1;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
//
// Same arithmetic as JAX's `_bwd_kernel` (relpos_flash.py:178-246), per
// head, with s recomputed as the forward computes it and the forward's row
// max m and row sum l read back:
//
//   p   = exp(s - m)                     unnormalised, f32
//   dd  = rowsum(do * o)                 f32
//   dv  = bf16(p)^T . bf16(do / l)
//   dp  = do . v^T
//   ds  = bf16(p (dp - dd) / l * d_head^-0.5)
//   dqu = ds . k          dk = ds^T . qu
//   dqv[q] = sum_j ds[q, j] pe[T-1-q+j]
//   dpe[p] = sum_(b, q) ds[q, p-(T-1-q)] qv[q]    (float32 over the batch)
//
// The TPU kernel held a head's whole score blocks in VMEM and un-shifted
// the position-score gradient with a row reversal and a strided lane
// rotate. Here the un-shift is an index, as the forward's shift is, and
// the work splits into three passes with nothing carried between blocks:
//   (a) rowdot: dd (B, H, T), eight threads a (row, head), 16-byte loads;
//   (b) dkdv: one block per (128 keys, head, batch row), two consumer
//       warpgroups of 64 keys each, looping over 64-row query tiles with
//       keys as wgmma's M: S^T = K Qu^T and dP^T = V dO^T. The position
//       scores are the forward's block Pw for the query tile and the
//       warpgroup's keys, staged whole and read transposed (a barrier of
//       the warpgroup's four warps on each side, since a warp reads every
//       staged row). The producer warp stages the tile's m (log2 units,
//       +inf past T), 1/l and dd rows in shared memory and builds
//       don = bf16(do / l) in shared memory from the do tile (the plain
//       version rounds it per element), in the swizzled layout wgmma
//       reads. dV += P^T don and dK += dS^T Qu take P^T and dS^T as
//       register A operands, don and Qu MN-major.
//   (c) dq: one block per (128 query rows, head, batch row), looping over
//       64-key tiles: Pw, S and dP, then dS; dQu += dS K (register A);
//       dS is also written shifted, dSh[r, 63-r+c] = dS[r, c], into a
//       64 x 128 bf16 tile (two swizzled 64-column halves, zeroed once:
//       the band a row writes is the same on every tile), so that
//       dQv += dSh . window (window MN-major) and dpe's share of the
//       window, dSh^T . Qv (both MN-major), are wgmma products.
//       Consecutive key tiles' windows overlap by 64 rows, so the share of
//       the lower 64 rows is added to the upper half of the previous tile
//       in the accumulator registers and then added into the (Wp, D)
//       float32 dpe with global float32 atomics (every batch row and query
//       tile adds into the same rows); the caller zeroes dpe and casts it.
// Both passes recompute s, the position block and dp: 15 products of
// T^2 * 64 a head where the bound counts 8. dqu, dqv, dk and dv are
// bit-identical from run to run; dpe's atomics sum in a varying order.
// Keys past T get p = 0 in (c) by index; query rows past T get p = 0 in
// (b) through m = +inf; rows past T are never stored.

// acc += a (the 64 x 64 bf16 A fragments) b, b a 64-row tile read MN-major:
// issued, not committed.
__device__ __forceinline__ void issue_ab(float (&acc)[32], const uint32_t (&a)[16],
                                         const bf16* b) {
#pragma unroll
  for (int kc = 0; kc < BS / 16; ++kc)
    hop::wgmma_rs_n64_t(acc, &a[4 * kc], hop::desc(b, kc * 16 * 128));
}

// (a) dd[b, h, t] = sum over the head's 64 columns of do * o, in f32.
__global__ void relpos_rowdot_kernel(const bf16* __restrict__ dout,
                                     const bf16* __restrict__ o, float* __restrict__ dd,
                                     int B, int T, int H) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t w = i >> 3;  // the (row, head): b * T * H + t * H + h
  const bool live = w < (size_t)B * T * H;
  float sum = 0.f;
  if (live) {
    const uint4 x = *reinterpret_cast<const uint4*>(dout + i * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(o + i * 8);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(xa[j]), c = __bfloat1622float2(ya[j]);
      sum += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (live && (i & 7) == 0) {
    const int h = (int)(w % H);
    const size_t bt = w / H;  // b * T + t
    dd[((bt / T) * H + h) * T + bt % T] = sum;
  }
}

constexpr int BST = 2;  // the backward passes' ring depth

struct KVMaps {
  CUtensorMap k, v;            // the block's own 128 keys
  CUtensorMap qu, qv, dout;    // 64-row query tiles
  CUtensorMap pe;
};

struct SmemKV {
  alignas(1024) bf16 k[BR * DH];
  alignas(1024) bf16 v[BR * DH];
  alignas(1024) bf16 qu[BST][BS * DH];
  alignas(1024) bf16 qv[BST][BS * DH];
  alignas(1024) bf16 dout[BST][BS * DH];
  alignas(1024) bf16 don[BST][BS * DH];  // bf16(do / l), built by the producer
  alignas(1024) bf16 pe[BST][PR * DH];
  float pw[2][64 * PL];
  float ml[BST][BS], linv[BST][BS], dd[BST][BS];  // the query tile's rows
  uint64_t own_full, full[BST], empty[BST], tma[BST];
  static constexpr bool kTma = true;
};

// (b) dk, dv of one (128 keys, head, batch row).
__global__ void __launch_bounds__(THREADS, 1)
relpos_dkdv_kernel(const __grid_constant__ KVMaps mp, const float* __restrict__ mask,
                   const float* __restrict__ row_m, const float* __restrict__ row_l,
                   const float* __restrict__ dd, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int T, int H) {
  extern __shared__ unsigned char smem_raw[];
  SmemKV& sm = setup<SmemKV, BST>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z, c = h * DH;
  const int n_q_tiles = (T + BS - 1) / BS;
  const size_t bh = ((size_t)b * H + h) * T;
  if (tid >= 256) {
    hop::reg_dealloc<56>();
    if (tid >= 256 + 32) return;
    // The producer warp: the block's keys, then each query tile's rows,
    // statistics and don.
    if (lane == 0) {
      hop::mbar_expect_tx(&sm.own_full, 2 * OWN);
      hop::tma_load(sm.k, &mp.k, &sm.own_full, c, k0, b);
      hop::tma_load(sm.v, &mp.v, &sm.own_full, c, k0, b);
    }
    for (int it = 0; it < n_q_tiles; ++it) {
      const int s = it % BST, q0 = it * BS;
      hop::mbar_wait(&sm.empty[s], ((it / BST) & 1) ^ 1);
      for (int i = lane; i < BS; i += 32) {
        const int q = q0 + i;
        sm.ml[s][i] = q < T ? row_m[bh + q] * LOG2E : INFINITY;
        sm.linv[s][i] = q < T ? 1.f / row_l[bh + q] : 0.f;
        sm.dd[s][i] = q < T ? dd[bh + q] : 0.f;
      }
      if (lane == 0) {
        hop::mbar_expect_tx(&sm.tma[s], 3 * STR + PEB);
        hop::tma_load(sm.qu[s], &mp.qu, &sm.tma[s], c, q0, b);
        hop::tma_load(sm.qv[s], &mp.qv, &sm.tma[s], c, q0, b);
        hop::tma_load(sm.dout[s], &mp.dout, &sm.tma[s], c, q0, b);
        hop::tma_load_2d(sm.pe[s], &mp.pe, &sm.tma[s], c, T - 1 - (q0 + BS - 1) + k0);
      }
      hop::mbar_wait(&sm.tma[s], (it / BST) & 1);
      __syncwarp();
      // don: a 16-byte chunk lies in one row (the swizzle moves chunks
      // within their row), row = chunk / 8
      const uint4* src = reinterpret_cast<const uint4*>(sm.dout[s]);
      uint4* dst = reinterpret_cast<uint4*>(sm.don[s]);
      for (int i = lane; i < BS * DH / 8; i += 32) {
        const float li = sm.linv[s][i >> 3];
        uint4 xv = src[i], yv;
        const bf16* x = reinterpret_cast<const bf16*>(&xv);
        bf16* y = reinterpret_cast<bf16*>(&yv);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = __float2bfloat16(__bfloat162float(x[e]) * li);
        dst[i] = yv;
      }
      hop::fence_proxy_async();
      hop::mbar_arrive(&sm.full[s]);
    }
    return;
  }
  hop::reg_alloc<224>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, t = lane & 3;
  const int row0 = k0 + wg * 64 + warp * 16 + (lane >> 2);  // this thread's keys: row0, row0 + 8
  const float km0 = row0 < T ? mask[(size_t)b * T + row0] : 0.f;
  const float km1 = row0 + 8 < T ? mask[(size_t)b * T + row0 + 8] : 0.f;
  const uint64_t kd = hop::desc(sm.k, wg * 64 * 128), vd = hop::desc(sm.v, wg * 64 * 128);
  float* pw = sm.pw[wg];
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  hop::mbar_wait(&sm.own_full, 0);

  for (int it = 0; it < n_q_tiles; ++it) {
    const int s = it % BST;
    hop::mbar_wait(&sm.full[s], (it / BST) & 1);

    // the query tile's position block against the warpgroup's window (the
    // pe tile's rows from 64 wg), staged whole: a warp reads every row
    hop::bar_sync(1 + wg, 128);
    position_block(pw, hop::desc(sm.qv[s]), hop::desc(sm.pe[s], wg * 64 * 128));
    hop::bar_sync(1 + wg, 128);

    // S^T (64 keys x 64 q) = K Qu^T and dP^T = V dO^T
    float st[32], dpt[32];
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) hop::wgmma_ss_n64(st, kd + 2 * kc, hop::desc(sm.qu[s]) + 2 * kc, kc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hop::wgmma_ss_n64(dpt, vd + 2 * kc, hop::desc(sm.dout[s]) + 2 * kc, kc);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    // P^T = exp(s - m), dS^T = P^T (dP^T - dd) / l * 0.125: bf16 A fragments.
    // Key row j, query column q reads Pw[q, 63-q+j] at column 15-(q%16)+j.
    uint32_t pa[16], dsa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int qc = 8 * (i >> 2) + 2 * t, jr = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const float km = (i & 2) ? km1 : km0;
      const float* pr = pw + qc * PL + 15 - (qc & 15) + jr;
      const float x0 = (st[i] + pr[0]) * SCALE + km;
      const float x1 = (st[i + 1] + pr[PL - 1]) * SCALE + km;
      const float p0 = hop::ex2(fmaf(x0, LOG2E, -sm.ml[s][qc]));
      const float p1 = hop::ex2(fmaf(x1, LOG2E, -sm.ml[s][qc + 1]));
      pa[i >> 1] = hop::pack_bf16(p0, p1);
      dsa[i >> 1] = hop::pack_bf16(p0 * (dpt[i] - sm.dd[s][qc]) * (sm.linv[s][qc] * SCALE),
                                   p1 * (dpt[i + 1] - sm.dd[s][qc + 1]) *
                                       (sm.linv[s][qc + 1] * SCALE));
    }

    // dV += P^T don, dK += dS^T Qu (don and Qu read MN-major)
    hop::wgmma_fence();
    issue_ab(dv_acc, pa, sm.don[s]);
    issue_ab(dk_acc, dsa, sm.qu[s]);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(dv_acc);
    hop::fence_regs(dk_acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }

  const int D = H * DH;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;
  store_rows(dk + base, dk_acc, row0, T, D, 1.f, 1.f);
  store_rows(dv + base, dv_acc, row0, T, D, 1.f, 1.f);
}

struct SmemQ {
  alignas(1024) bf16 qu[BR * DH];
  alignas(1024) bf16 qv[BR * DH];
  alignas(1024) bf16 dout[BR * DH];
  alignas(1024) bf16 k[BST][BS * DH];
  alignas(1024) bf16 v[BST][BS * DH];
  alignas(1024) bf16 pe[BST][PR * DH];
  alignas(1024) bf16 dsh[2][2][64 * DH];  // each warpgroup's shifted dS, two 64-column halves
  float pw[2][64 * PL];
  float mask[BST][BS];
  uint64_t own_full, full[BST], empty[BST];
  static constexpr bool kTma = false;
};

// Add a warpgroup's 64 x 64 share of dpe (rows p0 .. p0+63 of pe) into
// dpe; rows outside 0 .. 2T-2 get nothing.
__device__ __forceinline__ void flush_dpe(float* dpe, const float (&a)[32], int p0, int n_real,
                                          int D, int h) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int p = p0 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    if (p >= 0 && p < n_real) {
      float* at = dpe + (size_t)p * D + h * DH + 8 * (i >> 2) + 2 * (lane & 3);
      atomicAdd(at, a[i]);
      atomicAdd(at + 1, a[i + 1]);
    }
  }
}

// (c) dqu, dqv of one (128 query rows, head, batch row), and its share of dpe.
__global__ void __launch_bounds__(THREADS, 1)
relpos_dq_kernel(const __grid_constant__ QMaps mp, const float* __restrict__ mask,
                 const float* __restrict__ row_m, const float* __restrict__ row_l,
                 const float* __restrict__ dd, bf16* __restrict__ dqu, bf16* __restrict__ dqv,
                 float* __restrict__ dpe, int T, int H) {
  extern __shared__ unsigned char smem_raw[];
  SmemQ& sm = setup<SmemQ, BST>(smem_raw);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int n_k_tiles = (T + BS - 1) / BS;
  if (tid >= 256) {
    hop::reg_dealloc<56>();
    if (tid < 256 + 32) {
      bf16* own[3] = {sm.qu, sm.qv, sm.dout};
      produce_keys<BST>(sm, mp, own, 3, mask, T);
    }
    return;
  }
  hop::reg_alloc<224>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);  // and row0 + 8
  const size_t bh = ((size_t)b * H + h) * T;
  // the rows' m in log2 units (+inf past T: p = 0), 1/l * 0.125 and dd
  const float ml0 = row0 < T ? row_m[bh + row0] * LOG2E : INFINITY;
  const float ml1 = row0 + 8 < T ? row_m[bh + row0 + 8] * LOG2E : INFINITY;
  const float li0 = row0 < T ? SCALE / row_l[bh + row0] : 0.f;
  const float li1 = row0 + 8 < T ? SCALE / row_l[bh + row0 + 8] : 0.f;
  const float dr0 = row0 < T ? dd[bh + row0] : 0.f;
  const float dr1 = row0 + 8 < T ? dd[bh + row0 + 8] : 0.f;
  const uint64_t qud = hop::desc(sm.qu, wg * 64 * 128), qvd = hop::desc(sm.qv, wg * 64 * 128);
  const uint64_t dod = hop::desc(sm.dout, wg * 64 * 128);
  float* pw = sm.pw[wg];
  bf16* dsh = sm.dsh[wg][0];
  {  // zero dSh once: the band a row writes is the same on every key tile
    uint4* z = reinterpret_cast<uint4*>(dsh);
    for (int i = tid & 127; i < 2 * 64 * DH / 8; i += 128) z[i] = make_uint4(0u, 0u, 0u, 0u);
    hop::fence_proxy_async();
    hop::bar_sync(1 + wg, 128);
  }
  float dqu_acc[32], dqv_acc[32], dpe_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqu_acc[i] = dqv_acc[i] = dpe_acc[i] = 0.f;
  const int D = H * DH, n_real = 2 * T - 1;
  // the warpgroup's pe window on key tile 0: rows from T-1-(qa+63)
  const int pw0 = T - 1 - (q0 + wg * 64 + 63);
  hop::mbar_wait(&sm.own_full, 0);

  for (int it = 0; it < n_k_tiles; ++it) {
    const int s = it % BST, k0 = it * BS;
    hop::mbar_wait(&sm.full[s], (it / BST) & 1);
    const int win = (1 - wg) * 64 * 128;  // the window's byte offset in the pe tile

    __syncwarp();
    position_block(pw, qvd, hop::desc(sm.pe[s], win));
    float sc[32], dp[32];  // S = Qu K^T, dP = dO V^T
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hop::wgmma_ss_n64(sc, qud + 2 * kc, hop::desc(sm.k[s]) + 2 * kc, kc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hop::wgmma_ss_n64(dp, dod + 2 * kc, hop::desc(sm.v[s]) + 2 * kc, kc);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    __syncwarp();

    // dS = P (dP - dd) / l * 0.125, P = exp(s - m): bf16 A fragments, and
    // written shifted into dSh (row r, column 63 - r + c)
    uint32_t dsa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = 8 * (i >> 2) + 2 * t, hi = (i >> 1) & 1;
      const float ml = hi ? ml1 : ml0, li = hi ? li1 : li0, dr = hi ? dr1 : dr0;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[e] = (sc[i + e] + shifted(pw, i + e)) * SCALE + sm.mask[s][c + e];
        if (k0 + c + e >= T) x[e] = -INFINITY;  // the key tail: p = 0 past T
        x[e] = hop::ex2(fmaf(x[e], LOG2E, -ml)) * (dp[i + e] - dr) * li;
      }
      dsa[i >> 1] = hop::pack_bf16(x[0], x[1]);
      const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&dsa[i >> 1]);
      const int r = warp * 16 + (lane >> 2) + 8 * hi;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 63 - r + c + e, cc = col & 63;
        dsh[(col >> 6) * 64 * DH + r * DH + (((cc >> 3) ^ (r & 7)) << 3) + (cc & 7)] =
            e ? pair.y : pair.x;
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(1 + wg, 128);  // every warp's dSh rows are written

    // dQu += dS K (K MN-major); dQv += dSh . window (dSh K-major, two
    // 64-column halves; the window MN-major)
    hop::wgmma_fence();
    issue_ab(dqu_acc, dsa, sm.k[s]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      hop::wgmma_ss_n64_tb(dqv_acc, hop::desc(dsh + (kk >> 2) * 64 * DH) + 2 * (kk & 3),
                           hop::desc(sm.pe[s], win + kk * 16 * 128), 1);
    // dpe of the window's lower 64 rows, onto the previous tile's upper 64
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_ss_n64_tab(dpe_acc, hop::desc(dsh, kk * 16 * 128),
                            hop::desc(sm.qv, wg * 64 * 128 + kk * 16 * 128), kk > 0 || it > 0);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(dqu_acc);
    hop::fence_regs(dqv_acc);
    hop::fence_regs(dpe_acc);
    flush_dpe(dpe, dpe_acc, pw0 + k0, n_real, D, h);
    // the upper 64 rows start the next tile's lower half
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_ss_n64_tab(dpe_acc, hop::desc(dsh + 64 * DH, kk * 16 * 128),
                            hop::desc(sm.qv, wg * 64 * 128 + kk * 16 * 128), kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(dpe_acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }
  flush_dpe(dpe, dpe_acc, pw0 + n_k_tiles * BS, n_real, D, h);

  const size_t base = (size_t)b * T * D + (size_t)h * DH;
  store_rows(dqu + base, dqu_acc, row0, T, D, 1.f, 1.f);
  store_rows(dqv + base, dqv_acc, row0, T, D, 1.f, 1.f);
}

}  // namespace

// qu, qv, k, v, o: (B, T, H*64) bf16; pe: (n_pe >= 2T-1, H*64) bf16 (rows
// 0 .. 2T-2 read); mask: (B, T) f32 additive; all contiguous and 16-byte
// aligned. row_m, row_l: (B, H, T) f32 outputs (the row max and sum the
// backward reads), or both null. Returns cudaGetLastError() after the
// launch, or a negative code if a tensor map could not be encoded.
extern "C" int relpos_flash_fwd(const void* qu, const void* qv, const void* k,
                                const void* v, const void* pe, const void* mask, void* o,
                                void* row_m, void* row_l, int B, int T, int H,
                                void* stream) {
  QMaps mp = {};
  int rc;
  if ((rc = hop_host::encode(&mp.own[0], qu, B, T, H, BR)) ||
      (rc = hop_host::encode(&mp.own[1], qv, B, T, H, BR)) ||
      (rc = hop_host::encode(&mp.k, k, B, T, H, BS)) ||
      (rc = hop_host::encode(&mp.v, v, B, T, H, BS)) ||
      (rc = hop_host::encode_2d(&mp.pe, pe, 2 * T - 1, H, PR)))
    return rc;
  const int smem = (int)sizeof(SmemF) + 1024;  // + the 1024-byte alignment
  // Set on every launch: the attribute is per device, and it is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      relpos_flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + BR - 1) / BR, H, B);
  relpos_flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      mp, (const float*)mask, (bf16*)o, (float*)row_m, (float*)row_l, T, H);
  return (int)cudaGetLastError();
}

// The backward of relpos_flash_fwd. Inputs as there, plus o and dout
// (B, T, H*64) bf16 and the forward's row_m, row_l (B, H, T) f32; dd:
// (B, H, T) f32 scratch; outputs dqu, dqv, dk, dv (B, T, H*64) bf16 and dpe
// (n_pe, H*64) f32, which the caller zeroes (rows from 2T-1 on stay 0).
// Launches (a), (b), (c) on `stream`; returns the first cudaGetLastError()
// that is not cudaSuccess, a negative code if a tensor map could not be
// encoded, or cudaSuccess.
extern "C" int relpos_flash_bwd(const void* qu, const void* qv, const void* k,
                                const void* v, const void* pe, const void* mask,
                                const void* o, const void* dout, const void* row_m,
                                const void* row_l, void* dd, void* dqu, void* dqv, void* dk,
                                void* dv, void* dpe, int B, int T, int H, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  KVMaps kv = {};
  QMaps qm = {};
  int rc;
  if ((rc = hop_host::encode(&kv.k, k, B, T, H, BR)) ||
      (rc = hop_host::encode(&kv.v, v, B, T, H, BR)) ||
      (rc = hop_host::encode(&kv.qu, qu, B, T, H, BS)) ||
      (rc = hop_host::encode(&kv.qv, qv, B, T, H, BS)) ||
      (rc = hop_host::encode(&kv.dout, dout, B, T, H, BS)) ||
      (rc = hop_host::encode_2d(&kv.pe, pe, 2 * T - 1, H, PR)) ||
      (rc = hop_host::encode(&qm.own[0], qu, B, T, H, BR)) ||
      (rc = hop_host::encode(&qm.own[1], qv, B, T, H, BR)) ||
      (rc = hop_host::encode(&qm.own[2], dout, B, T, H, BR)) ||
      (rc = hop_host::encode(&qm.k, k, B, T, H, BS)) ||
      (rc = hop_host::encode(&qm.v, v, B, T, H, BS)))
    return rc;
  qm.pe = kv.pe;
  const int smem_kv = (int)sizeof(SmemKV) + 1024, smem_q = (int)sizeof(SmemQ) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      relpos_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(relpos_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;

  const size_t threads = (size_t)B * T * H * 8;
  relpos_rowdot_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)o, (float*)dd, B, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 grid((T + BR - 1) / BR, H, B);
  relpos_dkdv_kernel<<<grid, THREADS, smem_kv, st>>>(
      kv, (const float*)mask, (const float*)row_m, (const float*)row_l, (const float*)dd,
      (bf16*)dk, (bf16*)dv, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  relpos_dq_kernel<<<grid, THREADS, smem_q, st>>>(
      qm, (const float*)mask, (const float*)row_m, (const float*)row_l, (const float*)dd,
      (bf16*)dqu, (bf16*)dqv, (float*)dpe, T, H);
  return (int)cudaGetLastError();
}
