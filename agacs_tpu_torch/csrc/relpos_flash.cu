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
// with bf16 inputs and float32 accumulation, d_head^-0.5 the head's real
// width's, the additive mask (0 or -1e30
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
// Head widths. Every kernel is a template over the instance's head width
// DH (32, 64 or 128; the wrapper zero-pads a head of another width up to
// the next instance, and the zero columns add exact zeros to both score
// products) and over its consumer warpgroups NWG and ring depth, picked per
// instance (`Inst`) to fit 227 KB. A tile of R rows is stored as DH / CW
// column blocks of R rows x CW columns, each one TMA box and one swizzle
// row: CW 64 (128-byte swizzle) at DH 64 and 128, CW 32 (64-byte swizzle,
// hop::desc64) at DH 32. A product over the head's channels takes DH / 16
// k16 steps across the blocks; a product with the head's channels as N runs
// one m64nCW wgmma per block into its own accumulators. The scale d_head^-0.5
// (the real width, not the instance's) is an argument, applied where JAX's
// `_fwd_kernel` applies it: (ac + shift) * isd + mask in float32. A head
// wider than 128 is padded to a multiple of 128 and runs the wide route
// (the section "Heads wider than 128" at the end): the 128 instance's tiles,
// its channels streamed in 128-wide chunks, a grid axis over the output's
// chunks.
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
// thread, 224 a consumer thread). ptxas still reports 168 for every such
// kernel, and the dq pass spills (chip_smoke.py's phase 1 prints both). The
// one-consumer instances (DH 128) have 255 a thread and no handover.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BS = 64;                 // rows per streamed tile (keys, or queries in dkdv)
constexpr int PL = 88;                 // f32 row stride of a staged position block
constexpr float LOG2E = 1.4426950408889634f;

// An instance's geometry: head width DH, NWG consumer warpgroups of 64 rows
// (the block owns BR = 64 NWG queries, or keys in dkdv), and the tiles'
// column blocks (see the header).
template <int DH_, int NWG_>
struct K {
  static constexpr int DH = DH_;
  static constexpr int NWG = NWG_;
  static constexpr int CW = DH < 64 ? DH : 64;  // columns of a column block
  static constexpr int CB = DH / CW;            // column blocks of a tile
  static constexpr int RB = 2 * CW;             // bytes of a column block's row
  static constexpr int KC = DH / 16;            // k16 steps over the head's channels
  static constexpr int NACC = CW / 2;           // accumulators of a 64 x CW product
  static constexpr int BR = 64 * NWG;           // rows a block owns
  static constexpr int PR = BR + BS;            // pe rows a tile reads: every window
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
  static_assert(DH % CW == 0 && (CW == 64 || CW == 32), "DH 32, 64 or 128");

  // The descriptor at byte `off` of a tile of this instance's swizzle.
  static __device__ __forceinline__ uint64_t desc(const void* tile, uint32_t off) {
    if constexpr (CW == 64)
      return hop::desc(tile, off);
    else
      return hop::desc64(tile, off);
  }
  // K-major: rows from r0 of an R-row tile, the head's channels 16 kc ..
  template <int R>
  static __device__ __forceinline__ uint64_t kmaj(const void* tile, int r0, int kc) {
    return desc(tile, (kc * 16 / CW) * R * RB + r0 * RB + (kc * 16 % CW) * 2);
  }
  // MN-major: rows r0 + 16 kk .. (the k) of column block cb of an R-row tile
  template <int R>
  static __device__ __forceinline__ uint64_t mn(const void* tile, int r0, int kk, int cb) {
    return desc(tile, cb * R * RB + (r0 + 16 * kk) * RB);
  }
  // d (64 x CW) += a (registers) . b (MN-major)
  static __device__ __forceinline__ void rs(float (&d)[NACC], const uint32_t* a, uint64_t b) {
    if constexpr (CW == 64)
      hop::wgmma_rs_n64_t(d, a, b);
    else
      hop::wgmma_rs_n32_t(d, a, b);
  }
  // d (64 x CW) += a (K-major) . b (MN-major)
  static __device__ __forceinline__ void ss_tb(float (&d)[NACC], uint64_t a, uint64_t b,
                                               int scale_d) {
    if constexpr (CW == 64)
      hop::wgmma_ss_n64_tb(d, a, b, scale_d);
    else
      hop::wgmma_ss_n32<0, 1>(d, a, b, scale_d);
  }
  // d (64 x CW) += a (MN-major) . b (MN-major)
  static __device__ __forceinline__ void ss_tab(float (&d)[NACC], uint64_t a, uint64_t b,
                                                int scale_d) {
    if constexpr (CW == 64)
      hop::wgmma_ss_n64_tab(d, a, b, scale_d);
    else
      hop::wgmma_ss_n32<1, 1>(d, a, b, scale_d);
  }
  // TMA loads of an R-row tile at (column c, row, batch b) / (column c, row)
  template <int R>
  static __device__ __forceinline__ void load(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c, int row, int b) {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) hop::tma_load(dst + cb * R * CW, map, bar, c + cb * CW, row, b);
  }
  template <int R>
  static __device__ __forceinline__ void load_2d(bf16* dst, const CUtensorMap* map,
                                                 uint64_t* bar, int c, int row) {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) hop::tma_load_2d(dst + cb * R * CW, map, bar, c + cb * CW, row);
  }
};

// The kernels' instances: the forward's, dkdv's and dq's geometry and ring
// depth at each head width (DH 128: one consumer warpgroup, and dkdv one
// stage, to fit the tiles in 227 KB).
template <int DH>
struct Inst {
  typedef K<DH, 2> F;
  typedef K<DH, 2> KV;
  typedef K<DH, 2> Q;
  static constexpr int FST = 2, KVST = 2, QST = 2;
};
template <>
struct Inst<128> {
  typedef K<128, 1> F;
  typedef K<128, 1> KV;
  typedef K<128, 1> Q;
  static constexpr int FST = 2, KVST = 1, QST = 2;
};

// Stage the columns [48-16w, 128-16w) of one 64 x 64 half (columns c0 ..
// c0+63) of a warpgroup's position block: row r of warp w at
// pw[r * PL + col - (48 - 16w)], or with ADD added to what is staged
// there (each thread reads and writes only its own elements). The test on
// the 8-column block is the same for the whole warp.
template <bool ADD = false>
__device__ __forceinline__ void stage_half(float* pw, const float (&a)[32], int c0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int x = c0 + 8 * (i >> 2) - 48 + 16 * warp;
    if (x >= 0 && x < 80) {
      const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
      float2* at = reinterpret_cast<float2*>(pw + r * PL + x + 2 * t);
      float2 val = make_float2(a[i], a[i + 1]);
      if constexpr (ADD) {
        const float2 was = *at;
        val.x += was.x;
        val.y += was.y;
      }
      *at = val;
    }
  }
}

// Both halves of the position block Pw = Qv . window^T (qv: the
// warpgroup's 64 rows from qr0 of an RQ-row tile; window: 128 pe rows from
// w0 of the pe tile, both K-major) into the staging buffer, or with `add`
// added to it. Issued and waited here, so only 32 accumulators live.
template <class KK, int RQ>
__device__ __forceinline__ void position_block(float* pw, const bf16* qv, int qr0,
                                               const bf16* pe, int w0, bool add = false) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float a[32];
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(a, KK::template kmaj<RQ>(qv, qr0, kc),
                        KK::template kmaj<KK::PR>(pe, w0 + 64 * half, kc), kc);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(a);
    if (add)
      stage_half<true>(pw, a, 64 * half);
    else
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
// block's own BR query rows, the streamed 64-key tiles and the pe tile.
struct QMaps {
  CUtensorMap own[3];  // fwd: qu, qv; dq: qu, qv, do
  CUtensorMap k, v, pe;
};

template <class KK, int ST>
struct SmemF {
  alignas(1024) bf16 qu[KK::BR * KK::DH];
  alignas(1024) bf16 qv[KK::BR * KK::DH];
  alignas(1024) bf16 k[ST][BS * KK::DH];
  alignas(1024) bf16 v[ST][BS * KK::DH];
  alignas(1024) bf16 pe[ST][KK::PR * KK::DH];
  float pw[KK::NWG][64 * PL];  // each warpgroup's staged position block
  float mask[ST][BS];          // the key tile's mask strip
  uint64_t own_full, full[ST], empty[ST];
  static constexpr bool kTma = false;
};

// The producer of the forward and the dq pass (one warp): the block's own
// tiles, then for every 64-key tile its k, v, pe tile (from row
// T-1-(q0+BR-1)+k0) and mask strip (lane 0 issues the copies, every lane
// stores two mask values and arrives).
template <class KK, int ST, class S>
__device__ __forceinline__ void produce_keys(S& sm, const QMaps& mp, bf16* const* own,
                                             int n_own, const float* mask, int T) {
  const int lane = threadIdx.x & 31, c = blockIdx.y * KK::DH, b = blockIdx.z;
  const int q0 = blockIdx.x * KK::BR, n_tiles = (T + BS - 1) / BS;
  if (lane == 0) {
    hop::mbar_expect_tx(&sm.own_full, n_own * KK::BR * KK::DH * 2);
    for (int i = 0; i < n_own; ++i)
      KK::template load<KK::BR>(own[i], &mp.own[i], &sm.own_full, c, q0, b);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, k0 = it * BS;
    hop::mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
    for (int i = lane; i < BS; i += 32)
      sm.mask[s][i] = k0 + i < T ? mask[(size_t)b * T + k0 + i] : 0.f;
    if (lane == 0) {
      hop::mbar_expect_tx(&sm.full[s], (2 * BS + KK::PR) * KK::DH * 2);
      KK::template load<BS>(sm.k[s], &mp.k, &sm.full[s], c, k0, b);
      KK::template load<BS>(sm.v[s], &mp.v, &sm.full[s], c, k0, b);
      KK::template load_2d<KK::PR>(sm.pe[s], &mp.pe, &sm.full[s], c, T - 1 - (q0 + KK::BR - 1) + k0);
    } else {
      hop::mbar_arrive(&sm.full[s]);
    }
  }
}

// The 1024-byte aligned shared storage, its barriers initialised (`tma`,
// where a kernel has it: the streamed copies, which its producer waits for).
template <class S, int ST, int NWG>
__device__ __forceinline__ S& setup(unsigned char* raw) {
  S& sm = *reinterpret_cast<S*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    hop::mbar_init(&sm.own_full, 1);
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(&sm.full[s], 32);        // the producer warp's lanes
      hop::mbar_init(&sm.empty[s], 4 * NWG);  // one arrival per consumer warp
      if constexpr (S::kTma) hop::mbar_init(&sm.tma[s], 1);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// The consumers take their registers (three warpgroups: 224 a consumer
// thread from the producer's 56; two have 255 a thread already).
template <int NWG>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NWG == 2) hop::reg_alloc<224>();
}
template <int NWG>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NWG == 2) hop::reg_dealloc<56>();
}

// Store rows row0 and row0 + 8 (if < T) of a warp's accumulators (the
// head's DH columns in CB blocks), each divided by its own value of `div`
// (1 for none).
template <class KK>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[KK::CB][KK::NACC],
                                           int row0, int T, int D, float div0, float div1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const float dv = half ? div1 : div0;
    if (row < T) {
      bf16* out = dst + (size_t)row * D + 2 * t;
#pragma unroll
      for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
        for (int j = 0; j < KK::NACC / 4; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + cb * KK::CW + 8 * j) = __floats2bfloat162_rn(
              acc[cb][4 * j + 2 * half] / dv, acc[cb][4 * j + 2 * half + 1] / dv);
    }
  }
}

// acc += a (the 64 x 64 bf16 A fragments) b, b a 64-row tile read MN-major
// (every column block): issued, not committed.
template <class KK>
__device__ __forceinline__ void issue_ab(float (&acc)[KK::CB][KK::NACC],
                                         const uint32_t (&a)[16], const bf16* b) {
#pragma unroll
  for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
    for (int kc = 0; kc < BS / 16; ++kc) KK::rs(acc[cb], &a[4 * kc], KK::template mn<BS>(b, 0, kc, cb));
}

template <class KK>
__device__ __forceinline__ void zero(float (&acc)[KK::CB][KK::NACC]) {
#pragma unroll
  for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
    for (int i = 0; i < KK::NACC; ++i) acc[cb][i] = 0.f;
}

template <class KK>
__device__ __forceinline__ void fence_all(float (&acc)[KK::CB][KK::NACC]) {
#pragma unroll
  for (int cb = 0; cb < KK::CB; ++cb) hop::fence_regs(acc[cb]);
}

template <class KK, int ST>
__global__ void __launch_bounds__(KK::THREADS, 1)
relpos_flash_fwd_kernel(const __grid_constant__ QMaps mp, const float* __restrict__ mask,
                        bf16* __restrict__ o, float* __restrict__ row_m,
                        float* __restrict__ row_l, int T, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  typedef SmemF<KK, ST> Sm;
  Sm& sm = setup<Sm, ST, KK::NWG>(smem_raw);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * KK::BR, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T + BS - 1) / BS;
  if (tid >= KK::CONSUMERS) {
    producer_regs<KK::NWG>();
    if (tid < KK::CONSUMERS + 32) {
      bf16* own[2] = {sm.qu, sm.qv};
      produce_keys<KK, ST>(sm, mp, own, 2, mask, T);
    }
    return;
  }
  consumer_regs<KK::NWG>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const int w0 = (KK::NWG - 1 - wg) * 64;  // the warpgroup's window in the pe tile
  float* pw = sm.pw[wg];
  float acc[KK::CB][KK::NACC];
  zero<KK>(acc);
  // rows g and g + 8 of the warp's 16: running max of s, this lane's share of the sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  hop::mbar_wait(&sm.own_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, k0 = it * BS;
    hop::mbar_wait(&sm.full[s], (it / ST) & 1);

    // The position block's halves (against the warpgroup's pe window) and
    // S = qu k^T, issued together; each half is staged while the later
    // products are in flight.
    float plo[32], phi[32], sc[32];
    __syncwarp();
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(plo, KK::template kmaj<KK::BR>(sm.qv, wg * 64, kc),
                        KK::template kmaj<KK::PR>(sm.pe[s], w0, kc), kc);
    hop::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(phi, KK::template kmaj<KK::BR>(sm.qv, wg * 64, kc),
                        KK::template kmaj<KK::PR>(sm.pe[s], w0 + 64, kc), kc);
    hop::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(sc, KK::template kmaj<KK::BR>(sm.qu, wg * 64, kc),
                        KK::template kmaj<BS>(sm.k[s], 0, kc), kc);
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
      sc[i] = (sc[i] + shifted(pw, i)) * scale + sm.mask[s][8 * (i >> 2) + 2 * t + (i & 1)];
    if (k0 + BS > T) {  // the key tail: zero-filled keys must not score bd * scale
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
    for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
      for (int i = 0; i < KK::NACC; ++i) acc[cb][i] *= (i & 2) ? a1 : a0;

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

    // acc (64 x DH) += p (bf16) v
    hop::wgmma_fence();
    issue_ab<KK>(acc, pa, sm.v[s]);
    hop::wgmma_commit();
    hop::wgmma_wait();
    fence_all<KK>(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int D = H * KK::DH, row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  store_rows<KK>(o + (size_t)b * T * D + (size_t)h * KK::DH, acc, row0, T, D, l0, l1);
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
//   ds  = bf16(p (dp - dd) / l * d_head^-0.5)   (the real width's)
//   dqu = ds . k          dk = ds^T . qu
//   dqv[q] = sum_j ds[q, j] pe[T-1-q+j]
//   dpe[p] = sum_(b, q) ds[q, p-(T-1-q)] qv[q]    (float32 over the batch)
//
// The TPU kernel held a head's whole score blocks in VMEM and un-shifted
// the position-score gradient with a row reversal and a strided lane
// rotate. Here the un-shift is an index, as the forward's shift is, and
// the work splits into three passes with nothing carried between blocks:
//   (a) rowdot: dd (B, H, T), eight threads a 64-column slice of a (row,
//       head), 16-byte loads, the head's slices summed in order;
//   (b) dkdv: one block per (BR keys, head, batch row), NWG consumer
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
//   (c) dq: one block per (BR query rows, head, batch row), looping over
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
//       With more than one column block (DH 128) the upper half is not
//       carried: each tile adds both halves (twice the atomics), which keeps
//       a third DH-wide accumulator out of the registers across tiles.
// Both passes recompute s, the position block and dp: 15 products of
// T^2 * DH a head where the bound counts 8. dqu, dqv, dk and dv are
// bit-identical from run to run; dpe's atomics sum in a varying order.
// Keys past T get p = 0 in (c) by index; query rows past T get p = 0 in
// (b) through m = +inf; rows past T are never stored.

// (a) dd[b, h, t] = sum over the head's DH columns of do * o, in f32: eight
// threads (16-byte loads) a 64-column slice, the DH / 64 slices (or one
// 32-column slice, four threads) added in order.
template <int DH>
__global__ void relpos_rowdot_kernel(const bf16* __restrict__ dout,
                                     const bf16* __restrict__ o, float* __restrict__ dd,
                                     int B, int T, int H) {
  constexpr int TPH = DH / 8;  // threads a (row, head)
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t w = i / TPH;  // the (row, head): b * T * H + t * H + h
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
  constexpr int LANES = TPH < 8 ? TPH : 8;  // a slice's threads (the shuffle's width)
#pragma unroll
  for (int m = LANES / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if constexpr (TPH > 8) {  // the slices of a 128-wide head: lanes 0 and 8 of 16
    const float hi = __shfl_down_sync(0xffffffffu, sum, 8);
    if ((i & 15) == 0) sum += hi;
  }
  if (live && (i % TPH) == 0) {
    const int h = (int)(w % H);
    const size_t bt = w / H;  // b * T + t
    dd[((bt / T) * H + h) * T + bt % T] = sum;
  }
}

struct KVMaps {
  CUtensorMap k, v;            // the block's own BR keys
  CUtensorMap qu, qv, dout;    // 64-row query tiles
  CUtensorMap pe;
};

// dkdv's producer: a 64-row query tile's rows from q0 (ml: m in log2
// units, +inf past T, so p = 0 there; linv: 1/l; dd), the statistics given
// at the (b, h) row.
__device__ __forceinline__ void row_stats(float* ml, float* linv, float* dd_s,
                                          const float* row_m, const float* row_l,
                                          const float* dd, int q0, int T) {
  for (int i = threadIdx.x & 31; i < BS; i += 32) {
    const int q = q0 + i;
    ml[i] = q < T ? row_m[q] * LOG2E : INFINITY;
    linv[i] = q < T ? 1.f / row_l[q] : 0.f;
    dd_s[i] = q < T ? dd[q] : 0.f;
  }
}

// dkdv's producer warp: don = bf16(do / l) from the 64-row do tile, in the
// swizzled layout wgmma reads (a 16-byte chunk lies in one row of its
// column block; the swizzle moves chunks within their row).
template <class KK>
__device__ __forceinline__ void build_don(bf16* don, const bf16* dout, const float* linv) {
  const uint4* src = reinterpret_cast<const uint4*>(dout);
  uint4* dst = reinterpret_cast<uint4*>(don);
  for (int i = threadIdx.x & 31; i < BS * KK::DH / 8; i += 32) {
    const float li = linv[(i % (BS * KK::CW / 8)) / (KK::CW / 8)];
    uint4 xv = src[i], yv;
    const bf16* x = reinterpret_cast<const bf16*>(&xv);
    bf16* y = reinterpret_cast<bf16*>(&yv);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __float2bfloat16(__bfloat162float(x[e]) * li);
    dst[i] = yv;
  }
}

// dkdv's P^T = exp(s - m) and dS^T = P^T (dP^T - dd) / l * scale for the
// thread's keys (mask km0, km1) against a 64-query tile, as bf16 A
// fragments: key row j, query column q reads Pw[q, 63-q+j] at column
// 15-(q%16)+j of the staged block.
__device__ __forceinline__ void dkdv_p_ds(const float (&st)[32], const float (&dpt)[32],
                                          const float* pw, const float* ml, const float* linv,
                                          const float* dd, float km0, float km1, float scale,
                                          uint32_t (&pa)[16], uint32_t (&dsa)[16]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int qc = 8 * (i >> 2) + 2 * t, jr = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
    const float km = (i & 2) ? km1 : km0;
    const float* pr = pw + qc * PL + 15 - (qc & 15) + jr;
    const float x0 = (st[i] + pr[0]) * scale + km;
    const float x1 = (st[i + 1] + pr[PL - 1]) * scale + km;
    const float p0 = hop::ex2(fmaf(x0, LOG2E, -ml[qc]));
    const float p1 = hop::ex2(fmaf(x1, LOG2E, -ml[qc + 1]));
    pa[i >> 1] = hop::pack_bf16(p0, p1);
    dsa[i >> 1] = hop::pack_bf16(p0 * (dpt[i] - dd[qc]) * (linv[qc] * scale),
                                 p1 * (dpt[i + 1] - dd[qc + 1]) * (linv[qc + 1] * scale));
  }
}

template <class KK, int ST>
struct SmemKV {
  alignas(1024) bf16 k[KK::BR * KK::DH];
  alignas(1024) bf16 v[KK::BR * KK::DH];
  alignas(1024) bf16 qu[ST][BS * KK::DH];
  alignas(1024) bf16 qv[ST][BS * KK::DH];
  alignas(1024) bf16 dout[ST][BS * KK::DH];
  alignas(1024) bf16 don[ST][BS * KK::DH];  // bf16(do / l), built by the producer
  alignas(1024) bf16 pe[ST][KK::PR * KK::DH];
  float pw[KK::NWG][64 * PL];
  float ml[ST][BS], linv[ST][BS], dd[ST][BS];  // the query tile's rows
  uint64_t own_full, full[ST], empty[ST], tma[ST];
  static constexpr bool kTma = true;
};

// (b) dk, dv of one (BR keys, head, batch row).
template <class KK, int ST>
__global__ void __launch_bounds__(KK::THREADS, 1)
relpos_dkdv_kernel(const __grid_constant__ KVMaps mp, const float* __restrict__ mask,
                   const float* __restrict__ row_m, const float* __restrict__ row_l,
                   const float* __restrict__ dd, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int T, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  typedef SmemKV<KK, ST> Sm;
  Sm& sm = setup<Sm, ST, KK::NWG>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = blockIdx.x * KK::BR, h = blockIdx.y, b = blockIdx.z, c = h * KK::DH;
  const int n_q_tiles = (T + BS - 1) / BS;
  const size_t bh = ((size_t)b * H + h) * T;
  if (tid >= KK::CONSUMERS) {
    producer_regs<KK::NWG>();
    if (tid >= KK::CONSUMERS + 32) return;
    // The producer warp: the block's keys, then each query tile's rows,
    // statistics and don.
    if (lane == 0) {
      hop::mbar_expect_tx(&sm.own_full, 2 * KK::BR * KK::DH * 2);
      KK::template load<KK::BR>(sm.k, &mp.k, &sm.own_full, c, k0, b);
      KK::template load<KK::BR>(sm.v, &mp.v, &sm.own_full, c, k0, b);
    }
    for (int it = 0; it < n_q_tiles; ++it) {
      const int s = it % ST, q0 = it * BS;
      hop::mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      row_stats(sm.ml[s], sm.linv[s], sm.dd[s], row_m + bh, row_l + bh, dd + bh, q0, T);
      if (lane == 0) {
        hop::mbar_expect_tx(&sm.tma[s], (3 * BS + KK::PR) * KK::DH * 2);
        KK::template load<BS>(sm.qu[s], &mp.qu, &sm.tma[s], c, q0, b);
        KK::template load<BS>(sm.qv[s], &mp.qv, &sm.tma[s], c, q0, b);
        KK::template load<BS>(sm.dout[s], &mp.dout, &sm.tma[s], c, q0, b);
        KK::template load_2d<KK::PR>(sm.pe[s], &mp.pe, &sm.tma[s], c, T - 1 - (q0 + BS - 1) + k0);
      }
      hop::mbar_wait(&sm.tma[s], (it / ST) & 1);
      __syncwarp();
      build_don<KK>(sm.don[s], sm.dout[s], sm.linv[s]);
      hop::fence_proxy_async();
      hop::mbar_arrive(&sm.full[s]);
    }
    return;
  }
  consumer_regs<KK::NWG>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int row0 = k0 + wg * 64 + warp * 16 + (lane >> 2);  // this thread's keys: row0, row0 + 8
  const float km0 = row0 < T ? mask[(size_t)b * T + row0] : 0.f;
  const float km1 = row0 + 8 < T ? mask[(size_t)b * T + row0 + 8] : 0.f;
  float* pw = sm.pw[wg];
  float dk_acc[KK::CB][KK::NACC], dv_acc[KK::CB][KK::NACC];
  zero<KK>(dk_acc);
  zero<KK>(dv_acc);
  hop::mbar_wait(&sm.own_full, 0);

  for (int it = 0; it < n_q_tiles; ++it) {
    const int s = it % ST;
    hop::mbar_wait(&sm.full[s], (it / ST) & 1);

    // the query tile's position block against the warpgroup's window (the
    // pe tile's rows from 64 wg), staged whole: a warp reads every row
    hop::bar_sync(1 + wg, 128);
    position_block<KK, BS>(pw, sm.qv[s], 0, sm.pe[s], wg * 64);
    hop::bar_sync(1 + wg, 128);

    // S^T (64 keys x 64 q) = K Qu^T and dP^T = V dO^T
    float st[32], dpt[32];
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(st, KK::template kmaj<KK::BR>(sm.k, wg * 64, kc),
                        KK::template kmaj<BS>(sm.qu[s], 0, kc), kc);
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(dpt, KK::template kmaj<KK::BR>(sm.v, wg * 64, kc),
                        KK::template kmaj<BS>(sm.dout[s], 0, kc), kc);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    // P^T = exp(s - m), dS^T = P^T (dP^T - dd) / l * scale: bf16 A fragments
    uint32_t pa[16], dsa[16];
    dkdv_p_ds(st, dpt, pw, sm.ml[s], sm.linv[s], sm.dd[s], km0, km1, scale, pa, dsa);

    // dV += P^T don, dK += dS^T Qu (don and Qu read MN-major)
    hop::wgmma_fence();
    issue_ab<KK>(dv_acc, pa, sm.don[s]);
    issue_ab<KK>(dk_acc, dsa, sm.qu[s]);
    hop::wgmma_commit();
    hop::wgmma_wait();
    fence_all<KK>(dv_acc);
    fence_all<KK>(dk_acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }

  const int D = H * KK::DH;
  const size_t base = (size_t)b * T * D + (size_t)h * KK::DH;
  store_rows<KK>(dk + base, dk_acc, row0, T, D, 1.f, 1.f);
  store_rows<KK>(dv + base, dv_acc, row0, T, D, 1.f, 1.f);
}

template <class KK, int ST>
struct SmemQ {
  alignas(1024) bf16 qu[KK::BR * KK::DH];
  alignas(1024) bf16 qv[KK::BR * KK::DH];
  alignas(1024) bf16 dout[KK::BR * KK::DH];
  alignas(1024) bf16 k[ST][BS * KK::DH];
  alignas(1024) bf16 v[ST][BS * KK::DH];
  alignas(1024) bf16 pe[ST][KK::PR * KK::DH];
  alignas(1024) bf16 dsh[KK::NWG][2][64 * 64];  // each warpgroup's shifted dS, two 64-column halves
  float pw[KK::NWG][64 * PL];
  float mask[ST][BS];
  uint64_t own_full, full[ST], empty[ST];
  static constexpr bool kTma = false;
};

// Add a warpgroup's 64 x DH share of dpe (rows p0 .. p0+63 of pe, columns
// from col) into dpe; rows outside 0 .. 2T-2 get nothing.
template <class KK>
__device__ __forceinline__ void flush_dpe(float* dpe, const float (&a)[KK::CB][KK::NACC], int p0,
                                          int n_real, int D, int col) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
    for (int i = 0; i < KK::NACC; i += 2) {
      const int p = p0 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      if (p >= 0 && p < n_real) {
        float* at = dpe + (size_t)p * D + col + cb * KK::CW + 8 * (i >> 2) + 2 * (lane & 3);
        atomicAdd(at, a[cb][i]);
        atomicAdd(at + 1, a[cb][i + 1]);
      }
    }
}

// dpe's share of rows [r0, r0 + 64) of the shifted dS (its half `hf`):
// acc (64 pe rows x DH) = dSh[:, half]^T . Qv (both MN-major), or += with
// `add`.
template <class KK>
__device__ __forceinline__ void issue_dpe(float (&acc)[KK::CB][KK::NACC], const bf16* dsh_half,
                                          const bf16* qv, int qr0, bool add) {
#pragma unroll
  for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      KK::ss_tab(acc[cb], hop::desc(dsh_half, kk * 16 * 128),
                 KK::template mn<KK::BR>(qv, qr0, kk, cb), kk > 0 || add);
}

// dq's dS = P (dP - dd) / l * scale, P = exp(s - m), for rows g and g + 8
// of the warp's 16 (m in log2 units ml, 1/l * scale li, dd dr) against a
// 64-key tile from k0 (its mask strip mask_s): bf16 A fragments dsa, and
// written shifted into dSh (row r, column 63 - r + c), the 64 x 128 tile of
// two swizzled 64-column halves.
__device__ __forceinline__ void dq_ds(const float (&sc)[32], const float (&dp)[32],
                                      const float* pw, const float* mask_s, int k0, int T,
                                      float scale, float ml0, float ml1, float li0, float li1,
                                      float dr0, float dr1, bf16* dsh, uint32_t (&dsa)[16]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int c = 8 * (i >> 2) + 2 * t, hi = (i >> 1) & 1;
    const float ml = hi ? ml1 : ml0, li = hi ? li1 : li0, dr = hi ? dr1 : dr0;
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[e] = (sc[i + e] + shifted(pw, i + e)) * scale + mask_s[c + e];
      if (k0 + c + e >= T) x[e] = -INFINITY;  // the key tail: p = 0 past T
      x[e] = hop::ex2(fmaf(x[e], LOG2E, -ml)) * (dp[i + e] - dr) * li;
    }
    dsa[i >> 1] = hop::pack_bf16(x[0], x[1]);
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&dsa[i >> 1]);
    const int r = warp * 16 + (lane >> 2) + 8 * hi;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 63 - r + c + e, cc = col & 63;
      dsh[(col >> 6) * 64 * 64 + r * 64 + (((cc >> 3) ^ (r & 7)) << 3) + (cc & 7)] =
          e ? pair.y : pair.x;
    }
  }
}

// (c) dqu, dqv of one (BR query rows, head, batch row), and its share of dpe.
template <class KK, int ST>
__global__ void __launch_bounds__(KK::THREADS, 1)
relpos_dq_kernel(const __grid_constant__ QMaps mp, const float* __restrict__ mask,
                 const float* __restrict__ row_m, const float* __restrict__ row_l,
                 const float* __restrict__ dd, bf16* __restrict__ dqu, bf16* __restrict__ dqv,
                 float* __restrict__ dpe, int T, int H, float scale) {
  constexpr bool CARRY = KK::CB == 1;  // the upper half's dpe carried to the next tile
  extern __shared__ unsigned char smem_raw[];
  typedef SmemQ<KK, ST> Sm;
  Sm& sm = setup<Sm, ST, KK::NWG>(smem_raw);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * KK::BR, h = blockIdx.y, b = blockIdx.z;
  const int n_k_tiles = (T + BS - 1) / BS;
  if (tid >= KK::CONSUMERS) {
    producer_regs<KK::NWG>();
    if (tid < KK::CONSUMERS + 32) {
      bf16* own[3] = {sm.qu, sm.qv, sm.dout};
      produce_keys<KK, ST>(sm, mp, own, 3, mask, T);
    }
    return;
  }
  consumer_regs<KK::NWG>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);  // and row0 + 8
  const size_t bh = ((size_t)b * H + h) * T;
  // the rows' m in log2 units (+inf past T: p = 0), 1/l * scale and dd
  const float ml0 = row0 < T ? row_m[bh + row0] * LOG2E : INFINITY;
  const float ml1 = row0 + 8 < T ? row_m[bh + row0 + 8] * LOG2E : INFINITY;
  const float li0 = row0 < T ? scale / row_l[bh + row0] : 0.f;
  const float li1 = row0 + 8 < T ? scale / row_l[bh + row0 + 8] : 0.f;
  const float dr0 = row0 < T ? dd[bh + row0] : 0.f;
  const float dr1 = row0 + 8 < T ? dd[bh + row0 + 8] : 0.f;
  float* pw = sm.pw[wg];
  bf16* dsh = sm.dsh[wg][0];
  {  // zero dSh once: the band a row writes is the same on every key tile
    uint4* z = reinterpret_cast<uint4*>(dsh);
    for (int i = tid & 127; i < 2 * 64 * 64 / 8; i += 128) z[i] = make_uint4(0u, 0u, 0u, 0u);
    hop::fence_proxy_async();
    hop::bar_sync(1 + wg, 128);
  }
  float dqu_acc[KK::CB][KK::NACC], dqv_acc[KK::CB][KK::NACC], dpe_acc[KK::CB][KK::NACC];
  zero<KK>(dqu_acc);
  zero<KK>(dqv_acc);
  zero<KK>(dpe_acc);
  const int D = H * KK::DH, n_real = 2 * T - 1;
  // the warpgroup's pe window on key tile 0: rows from T-1-(qa+63)
  const int pw0 = T - 1 - (q0 + wg * 64 + 63);
  const int w0 = (KK::NWG - 1 - wg) * 64;  // the window's first row in the pe tile
  hop::mbar_wait(&sm.own_full, 0);

  for (int it = 0; it < n_k_tiles; ++it) {
    const int s = it % ST, k0 = it * BS;
    hop::mbar_wait(&sm.full[s], (it / ST) & 1);

    __syncwarp();
    position_block<KK, KK::BR>(pw, sm.qv, wg * 64, sm.pe[s], w0);
    float sc[32], dp[32];  // S = Qu K^T, dP = dO V^T
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(sc, KK::template kmaj<KK::BR>(sm.qu, wg * 64, kc),
                        KK::template kmaj<BS>(sm.k[s], 0, kc), kc);
#pragma unroll
    for (int kc = 0; kc < KK::KC; ++kc)
      hop::wgmma_ss_n64(dp, KK::template kmaj<KK::BR>(sm.dout, wg * 64, kc),
                        KK::template kmaj<BS>(sm.v[s], 0, kc), kc);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    __syncwarp();

    // dS = P (dP - dd) / l * scale, P = exp(s - m): bf16 A fragments, and
    // written shifted into dSh
    uint32_t dsa[16];
    dq_ds(sc, dp, pw, sm.mask[s], k0, T, scale, ml0, ml1, li0, li1, dr0, dr1, dsh, dsa);
    hop::fence_proxy_async();
    hop::bar_sync(1 + wg, 128);  // every warp's dSh rows are written

    // dQu += dS K (K MN-major); dQv += dSh . window (dSh K-major, two
    // 64-column halves; the window MN-major)
    hop::wgmma_fence();
    issue_ab<KK>(dqu_acc, dsa, sm.k[s]);
#pragma unroll
    for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        KK::ss_tb(dqv_acc[cb], hop::desc(dsh + (kk >> 2) * 64 * 64) + 2 * (kk & 3),
                  KK::template mn<KK::PR>(sm.pe[s], w0, kk, cb), 1);
    // dpe of the window's lower 64 rows (carried: onto the previous tile's upper 64)
    issue_dpe<KK>(dpe_acc, dsh, sm.qv, wg * 64, CARRY && it > 0);
    hop::wgmma_commit();
    hop::wgmma_wait();
    fence_all<KK>(dqu_acc);
    fence_all<KK>(dqv_acc);
    fence_all<KK>(dpe_acc);
    flush_dpe<KK>(dpe, dpe_acc, pw0 + k0, n_real, D, h * KK::DH);
    // the upper 64 rows (carried: they start the next tile's lower half)
    hop::wgmma_fence();
    issue_dpe<KK>(dpe_acc, dsh + 64 * 64, sm.qv, wg * 64, false);
    hop::wgmma_commit();
    hop::wgmma_wait();
    fence_all<KK>(dpe_acc);
    if (!CARRY) flush_dpe<KK>(dpe, dpe_acc, pw0 + k0 + 64, n_real, D, h * KK::DH);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }
  if (CARRY) flush_dpe<KK>(dpe, dpe_acc, pw0 + n_k_tiles * BS, n_real, D, h * KK::DH);

  const size_t base = (size_t)b * T * D + (size_t)h * KK::DH;
  store_rows<KK>(dqu + base, dqu_acc, row0, T, D, 1.f, 1.f);
  store_rows<KK>(dqv + base, dqv_acc, row0, T, D, 1.f, 1.f);
}

// The maps of a kernel of geometry KK: a packed (B, T, H*DH) tensor in R-row
// boxes of CW columns, and pe's 2D map over (H*DH columns, 2T-1 rows).
template <class KK, int R>
int encode_tile(CUtensorMap* map, const void* ptr, int B, int T, int H) {
  return hop_host::encode_cols(map, ptr, B, T, H * KK::DH, R, KK::CW);
}
template <class KK>
int encode_pe(CUtensorMap* map, const void* pe, int T, int H) {
  return hop_host::encode_bf16(map, pe, 2 * T - 1, H * KK::DH, H * KK::DH, KK::PR, KK::CW);
}

// The dynamic shared memory of a kernel with storage S (+ the 1024-byte
// alignment), set on every launch (the attribute is per device, and cheap).
template <class S, class Kern>
int smem_for(Kern kern, int* bytes) {
  *bytes = (int)sizeof(S) + 1024;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
}

template <int DH>
int launch_fwd(const void* qu, const void* qv, const void* k, const void* v, const void* pe,
               const void* mask, void* o, void* row_m, void* row_l, int B, int T, int H,
               float scale, cudaStream_t stream) {
  typedef typename Inst<DH>::F KK;
  constexpr int ST = Inst<DH>::FST;
  QMaps mp = {};
  int rc;
  if ((rc = encode_tile<KK, KK::BR>(&mp.own[0], qu, B, T, H)) ||
      (rc = encode_tile<KK, KK::BR>(&mp.own[1], qv, B, T, H)) ||
      (rc = encode_tile<KK, BS>(&mp.k, k, B, T, H)) ||
      (rc = encode_tile<KK, BS>(&mp.v, v, B, T, H)) ||
      (rc = encode_pe<KK>(&mp.pe, pe, T, H)))
    return rc;
  int smem;
  if ((rc = smem_for<SmemF<KK, ST>>(relpos_flash_fwd_kernel<KK, ST>, &smem))) return rc;
  dim3 grid((T + KK::BR - 1) / KK::BR, H, B);
  relpos_flash_fwd_kernel<KK, ST><<<grid, KK::THREADS, smem, stream>>>(
      mp, (const float*)mask, (bf16*)o, (float*)row_m, (float*)row_l, T, H, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bwd(const void* qu, const void* qv, const void* k, const void* v, const void* pe,
               const void* mask, const void* o, const void* dout, const void* row_m,
               const void* row_l, void* dd, void* dqu, void* dqv, void* dk, void* dv,
               void* dpe, int B, int T, int H, float scale, cudaStream_t st) {
  typedef typename Inst<DH>::KV KV;
  typedef typename Inst<DH>::Q KQ;
  constexpr int KVST = Inst<DH>::KVST, QST = Inst<DH>::QST;
  KVMaps kv = {};
  QMaps qm = {};
  int rc;
  if ((rc = encode_tile<KV, KV::BR>(&kv.k, k, B, T, H)) ||
      (rc = encode_tile<KV, KV::BR>(&kv.v, v, B, T, H)) ||
      (rc = encode_tile<KV, BS>(&kv.qu, qu, B, T, H)) ||
      (rc = encode_tile<KV, BS>(&kv.qv, qv, B, T, H)) ||
      (rc = encode_tile<KV, BS>(&kv.dout, dout, B, T, H)) ||
      (rc = encode_pe<KV>(&kv.pe, pe, T, H)) ||
      (rc = encode_tile<KQ, KQ::BR>(&qm.own[0], qu, B, T, H)) ||
      (rc = encode_tile<KQ, KQ::BR>(&qm.own[1], qv, B, T, H)) ||
      (rc = encode_tile<KQ, KQ::BR>(&qm.own[2], dout, B, T, H)) ||
      (rc = encode_tile<KQ, BS>(&qm.k, k, B, T, H)) ||
      (rc = encode_tile<KQ, BS>(&qm.v, v, B, T, H)) ||
      (rc = encode_pe<KQ>(&qm.pe, pe, T, H)))
    return rc;
  int smem_kv, smem_q;
  if ((rc = smem_for<SmemKV<KV, KVST>>(relpos_dkdv_kernel<KV, KVST>, &smem_kv)) ||
      (rc = smem_for<SmemQ<KQ, QST>>(relpos_dq_kernel<KQ, QST>, &smem_q)))
    return rc;

  cudaError_t err;
  const size_t threads = (size_t)B * T * H * (DH / 8);
  relpos_rowdot_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)o, (float*)dd, B, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  relpos_dkdv_kernel<KV, KVST><<<dim3((T + KV::BR - 1) / KV::BR, H, B), KV::THREADS, smem_kv,
                                 st>>>(kv, (const float*)mask, (const float*)row_m,
                                       (const float*)row_l, (const float*)dd, (bf16*)dk,
                                       (bf16*)dv, T, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  relpos_dq_kernel<KQ, QST><<<dim3((T + KQ::BR - 1) / KQ::BR, H, B), KQ::THREADS, smem_q,
                              st>>>(qm, (const float*)mask, (const float*)row_m,
                                    (const float*)row_l, (const float*)dd, (bf16*)dqu,
                                    (bf16*)dqv, (float*)dpe, T, H, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Heads wider than 128
//
// The wrapper zero-pads a head of 136 .. d channels to W = NC x 128 (NC >=
// 2, taken at launch: no instance per width). The 128 instance's block
// does not stretch: at 256 a 64 x 256 float32 accumulator alone is 128
// registers a thread on one warpgroup, and the 128 instance's tiles already
// take 150-215 KB. So each block owns one 128-wide chunk cc of its head's
// output columns (a grid axis over the chunks: blockIdx.y = h * NC + cc)
// and streams every chunk of the score products' operands through its
// ring, one (tile, chunk) step at a time, in the 128 instance's tiles (KW:
// 64 rows x 128 columns in two 64-column blocks, 128-byte swizzle). Over
// the NC steps of a tile the content scores (and dP in the backward)
// accumulate in the wgmma registers and the position block in its float32
// staging buffer (`position_block` with `add`); the tile's last step, whose
// slot holds chunk cc's operands, runs the softmax (or dS) and the products
// that give the block's own 128 columns, with the 128 instance's
// arithmetic. Every block thus redoes its (rows, head)'s score products:
// NC x the score work of the 128 instance, with one consumer warpgroup and
// a producer warp a block as there. The forward streams qu, qv, k, pe (and
// v of chunk cc on a tile's last step) through a 2-stage ring of 96 KB a
// stage; dkdv (k, v, qu, qv, do, pe and don: 128 KB) and dq (qu, qv, do,
// k, v, pe: 112 KB) through one stage. The forward takes the chunks in the
// order 0 .. NC-1 in every block, so the row statistics agree between a
// (rows, head)'s blocks and chunk 0's block writes them; the backward's
// blocks take cc last (chunk (cc + 1 + j) % NC at step j), so the slot of a
// tile's last step holds the block's own chunk. The backward's arithmetic
// is the instances' helpers (`row_stats`, `build_don`, `dkdv_p_ds`,
// `dq_ds`, `flush_dpe`); the forward's is `softmax_tile` and `finish_fwd`
// below, the same arithmetic as the instances' forward, which keeps its own
// inline copy (calling these helpers, the 64 instance's forward timed 4%
// slower in `chip_smoke.py --k3k5-turns`).

typedef K<128, 1> KW;  // the wide route's tiles and consumer geometry
constexpr int WFST = 2;  // the wide forward's ring depth (dkdv and dq: 1)

// The forward's softmax on one 64-key tile, rows g and g + 8 of each
// warp's 16: the content scores sc plus the shifted position block, scaled
// and masked (the key tile's mask strip `mask_s`); the online max and sum,
// acc rescaled; p = exp(s - m) into the bf16 A fragments pa of P.V.
template <class KK>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], const float* pw,
                                             const float* mask_s, int k0, int T, float scale,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float (&acc)[KK::CB][KK::NACC],
                                             uint32_t (&pa)[16]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    sc[i] = (sc[i] + shifted(pw, i)) * scale + mask_s[8 * (i >> 2) + 2 * t + (i & 1)];
  if (k0 + BS > T) {  // the key tail: zero-filled keys must not score bd * scale
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
  for (int cb = 0; cb < KK::CB; ++cb)
#pragma unroll
    for (int i = 0; i < KK::NACC; ++i) acc[cb][i] *= (i & 2) ? a1 : a0;

  // p = exp(s - m) into the bf16 A fragments of P.V
  const float mc0 = m0 * LOG2E, mc1 = m1 * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float mc = (i & 2) ? mc1 : mc0;
    const float p0 = hop::ex2(fmaf(sc[i], LOG2E, -mc));
    const float p1 = hop::ex2(fmaf(sc[i + 1], LOG2E, -mc));
    if (i & 2) l1 += p0 + p1;
    else l0 += p0 + p1;
    pa[i >> 1] = hop::pack_bf16(p0, p1);
  }
}

// The forward's end: the row sums over each quad, o's rows (the head's
// first column at `o`) divided by them, and unless row_m is null the rows'
// max and sum (row_m, row_l: the (b, h) row of the statistics).
template <class KK>
__device__ __forceinline__ void finish_fwd(bf16* o, const float (&acc)[KK::CB][KK::NACC],
                                           int row0, int T, int D, float m0, float m1, float l0,
                                           float l1, float* row_m, float* row_l) {
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  store_rows<KK>(o, acc, row0, T, D, l0, l1);
  if (row_m != nullptr && (threadIdx.x & 3) == 0) {
    if (row0 < T) {
      row_m[row0] = m0;
      row_l[row0] = l0;
    }
    if (row0 + 8 < T) {
      row_m[row0 + 8] = m1;
      row_l[row0 + 8] = l1;
    }
  }
}

// Every map of the wide kernels: 64-row boxes of 64 columns of the packed
// (B, T, H*W) tensors, pe's 2D map over (H*W columns, 2T-1 rows) in
// 128-row boxes.
struct WMaps {
  CUtensorMap qu, qv, dout, k, v, pe;
};

template <int ST>
struct SmemWF {
  alignas(1024) bf16 qu[ST][BS * 128];
  alignas(1024) bf16 qv[ST][BS * 128];
  alignas(1024) bf16 k[ST][BS * 128];
  alignas(1024) bf16 v[ST][BS * 128];  // chunk cc's, on a tile's last step
  alignas(1024) bf16 pe[ST][KW::PR * 128];
  float pw[64 * PL];
  float mask[ST][BS];
  uint64_t own_full, full[ST], empty[ST];
  static constexpr bool kTma = false;
};

// The wide forward: one block per (64 query rows, head x output chunk,
// batch row).
__global__ void __launch_bounds__(KW::THREADS, 1)
relpos_wide_fwd_kernel(const __grid_constant__ WMaps mp, const float* __restrict__ mask,
                       bf16* __restrict__ o, float* __restrict__ row_m,
                       float* __restrict__ row_l, int T, int H, int NC, float scale) {
  constexpr int ST = WFST;
  extern __shared__ unsigned char smem_raw[];
  typedef SmemWF<ST> Sm;
  Sm& sm = setup<Sm, ST, 1>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.x * BS, h = blockIdx.y / NC, cc = blockIdx.y % NC, b = blockIdx.z;
  const int col = h * NC * 128;  // the head's first column
  const int steps = (T + BS - 1) / BS * NC;
  if (tid >= KW::CONSUMERS) {
    if (tid >= KW::CONSUMERS + 32) return;
    // the producer warp: step it is chunk it % NC of key tile it / NC
    for (int it = 0; it < steps; ++it) {
      const int s = it % ST, c = col + 128 * (it % NC), k0 = it / NC * BS;
      const bool last = it % NC == NC - 1;
      hop::mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      if (last)
        for (int i = lane; i < BS; i += 32)
          sm.mask[s][i] = k0 + i < T ? mask[(size_t)b * T + k0 + i] : 0.f;
      if (lane == 0) {
        hop::mbar_expect_tx(&sm.full[s], ((last ? 4 : 3) * BS + KW::PR) * 128 * 2);
        KW::template load<BS>(sm.qu[s], &mp.qu, &sm.full[s], c, q0, b);
        KW::template load<BS>(sm.qv[s], &mp.qv, &sm.full[s], c, q0, b);
        KW::template load<BS>(sm.k[s], &mp.k, &sm.full[s], c, k0, b);
        KW::template load_2d<KW::PR>(sm.pe[s], &mp.pe, &sm.full[s], c, T - 1 - (q0 + BS - 1) + k0);
        if (last) KW::template load<BS>(sm.v[s], &mp.v, &sm.full[s], col + 128 * cc, k0, b);
      } else {
        hop::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  const int warp = (tid >> 5) & 3;
  float acc[KW::CB][KW::NACC], sc[32];
  zero<KW>(acc);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % ST, c = it % NC, k0 = it / NC * BS;
    hop::mbar_wait(&sm.full[s], (it / ST) & 1);
    __syncwarp();
    // this chunk's share of the position block, added to the staged one,
    // and S += qu k^T over its channels
    position_block<KW, BS>(sm.pw, sm.qv[s], 0, sm.pe[s], 0, c > 0);
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KW::KC; ++kc)
      hop::wgmma_ss_n64(sc, KW::template kmaj<BS>(sm.qu[s], 0, kc),
                        KW::template kmaj<BS>(sm.k[s], 0, kc), c > 0 || kc > 0);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(sc);
    __syncwarp();
    if (c == NC - 1) {
      uint32_t pa[16];
      softmax_tile<KW>(sc, sm.pw, sm.mask[s], k0, T, scale, m0, m1, l0, l1, acc, pa);
      hop::wgmma_fence();
      issue_ab<KW>(acc, pa, sm.v[s]);  // acc (64 x 128) += p v over chunk cc
      hop::wgmma_commit();
      hop::wgmma_wait();
      fence_all<KW>(acc);
      __syncwarp();
    }
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }
  const int D = H * NC * 128, row0 = q0 + warp * 16 + (lane >> 2);
  const size_t bh = ((size_t)b * H + h) * T;
  const bool stats = row_m != nullptr && cc == 0;
  finish_fwd<KW>(o + (size_t)b * T * D + col + 128 * cc, acc, row0, T, D, m0, m1, l0, l1,
                 stats ? row_m + bh : nullptr, stats ? row_l + bh : nullptr);
}

// (a) at the wide route: sixteen threads a (row, head), each adding its
// 16-byte slices of the NC chunks in order, then the sixteen partials.
__global__ void relpos_rowdot_wide_kernel(const bf16* __restrict__ dout,
                                          const bf16* __restrict__ o, float* __restrict__ dd,
                                          int B, int T, int H, int NC) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t w = i / 16;  // the (row, head): b * T * H + t * H + h
  const bool live = w < (size_t)B * T * H;
  float sum = 0.f;
  if (live) {
    const size_t at = w * NC * 128 + (i & 15) * 8;
    for (int c = 0; c < NC; ++c) {
      const uint4 x = *reinterpret_cast<const uint4*>(dout + at + 128 * c);
      const uint4 y = *reinterpret_cast<const uint4*>(o + at + 128 * c);
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(xa[j]), e = __bfloat1622float2(ya[j]);
        sum += a.x * e.x + a.y * e.y;
      }
    }
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (live && (i & 15) == 0) {
    const int h = (int)(w % H);
    const size_t bt = w / H;  // b * T + t
    dd[((bt / T) * H + h) * T + bt % T] = sum;
  }
}

template <int ST>
struct SmemWKV {
  alignas(1024) bf16 k[ST][BS * 128];  // the block's own keys, chunk by chunk
  alignas(1024) bf16 v[ST][BS * 128];
  alignas(1024) bf16 qu[ST][BS * 128];
  alignas(1024) bf16 qv[ST][BS * 128];
  alignas(1024) bf16 dout[ST][BS * 128];
  alignas(1024) bf16 don[ST][BS * 128];  // chunk cc's bf16(do / l), on a tile's last step
  alignas(1024) bf16 pe[ST][KW::PR * 128];
  float pw[64 * PL];
  float ml[ST][BS], linv[ST][BS], dd[ST][BS];
  uint64_t own_full, full[ST], empty[ST], tma[ST];
  static constexpr bool kTma = true;
};

// (b) at the wide route: dk, dv of one (64 keys, head x output chunk, batch row).
template <int ST>
__global__ void __launch_bounds__(KW::THREADS, 1)
relpos_wide_dkdv_kernel(const __grid_constant__ WMaps mp, const float* __restrict__ mask,
                        const float* __restrict__ row_m, const float* __restrict__ row_l,
                        const float* __restrict__ dd, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int T, int H, int NC, float scale) {
  extern __shared__ unsigned char smem_raw[];
  typedef SmemWKV<ST> Sm;
  Sm& sm = setup<Sm, ST, 1>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = blockIdx.x * BS, h = blockIdx.y / NC, cc = blockIdx.y % NC, b = blockIdx.z;
  const int col = h * NC * 128;
  const int steps = (T + BS - 1) / BS * NC;
  const size_t bh = ((size_t)b * H + h) * T;
  if (tid >= KW::CONSUMERS) {
    if (tid >= KW::CONSUMERS + 32) return;
    // the producer warp: step it is chunk (cc + 1 + it % NC) % NC of query
    // tile it / NC; on a tile's last step also its rows' statistics and don
    for (int it = 0; it < steps; ++it) {
      const int s = it % ST, q0 = it / NC * BS, c = col + 128 * ((cc + 1 + it % NC) % NC);
      const bool last = it % NC == NC - 1;
      hop::mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      if (last) row_stats(sm.ml[s], sm.linv[s], sm.dd[s], row_m + bh, row_l + bh, dd + bh, q0, T);
      if (lane == 0) {
        hop::mbar_expect_tx(&sm.tma[s], (5 * BS + KW::PR) * 128 * 2);
        KW::template load<BS>(sm.k[s], &mp.k, &sm.tma[s], c, k0, b);
        KW::template load<BS>(sm.v[s], &mp.v, &sm.tma[s], c, k0, b);
        KW::template load<BS>(sm.qu[s], &mp.qu, &sm.tma[s], c, q0, b);
        KW::template load<BS>(sm.qv[s], &mp.qv, &sm.tma[s], c, q0, b);
        KW::template load<BS>(sm.dout[s], &mp.dout, &sm.tma[s], c, q0, b);
        KW::template load_2d<KW::PR>(sm.pe[s], &mp.pe, &sm.tma[s], c, T - 1 - (q0 + BS - 1) + k0);
      }
      hop::mbar_wait(&sm.tma[s], (it / ST) & 1);
      __syncwarp();
      if (last) build_don<KW>(sm.don[s], sm.dout[s], sm.linv[s]);
      hop::fence_proxy_async();
      hop::mbar_arrive(&sm.full[s]);
    }
    return;
  }

  const int warp = (tid >> 5) & 3;
  const int row0 = k0 + warp * 16 + (lane >> 2);  // this thread's keys: row0, row0 + 8
  const float km0 = row0 < T ? mask[(size_t)b * T + row0] : 0.f;
  const float km1 = row0 + 8 < T ? mask[(size_t)b * T + row0 + 8] : 0.f;
  float dk_acc[KW::CB][KW::NACC], dv_acc[KW::CB][KW::NACC], st[32], dpt[32];
  zero<KW>(dk_acc);
  zero<KW>(dv_acc);
  for (int it = 0; it < steps; ++it) {
    const int s = it % ST, j = it % NC;
    hop::mbar_wait(&sm.full[s], (it / ST) & 1);

    // this chunk's share of the query tile's position block, added to the
    // staged one: a warp reads every staged row, so the warpgroup meets
    // before a tile's first share and after its last
    if (j == 0) hop::bar_sync(1, 128);
    position_block<KW, BS>(sm.pw, sm.qv[s], 0, sm.pe[s], 0, j > 0);
    if (j == NC - 1) hop::bar_sync(1, 128);

    // S^T += K Qu^T and dP^T += V dO^T over this chunk's channels
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KW::KC; ++kc)
      hop::wgmma_ss_n64(st, KW::template kmaj<BS>(sm.k[s], 0, kc),
                        KW::template kmaj<BS>(sm.qu[s], 0, kc), j > 0 || kc > 0);
#pragma unroll
    for (int kc = 0; kc < KW::KC; ++kc)
      hop::wgmma_ss_n64(dpt, KW::template kmaj<BS>(sm.v[s], 0, kc),
                        KW::template kmaj<BS>(sm.dout[s], 0, kc), j > 0 || kc > 0);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    if (j == NC - 1) {  // chunk cc: dV += P^T don, dK += dS^T Qu
      uint32_t pa[16], dsa[16];
      dkdv_p_ds(st, dpt, sm.pw, sm.ml[s], sm.linv[s], sm.dd[s], km0, km1, scale, pa, dsa);
      hop::wgmma_fence();
      issue_ab<KW>(dv_acc, pa, sm.don[s]);
      issue_ab<KW>(dk_acc, dsa, sm.qu[s]);
      hop::wgmma_commit();
      hop::wgmma_wait();
      fence_all<KW>(dv_acc);
      fence_all<KW>(dk_acc);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }
  const int D = H * NC * 128;
  const size_t base = (size_t)b * T * D + col + 128 * cc;
  store_rows<KW>(dk + base, dk_acc, row0, T, D, 1.f, 1.f);
  store_rows<KW>(dv + base, dv_acc, row0, T, D, 1.f, 1.f);
}

template <int ST>
struct SmemWQ {
  alignas(1024) bf16 qu[ST][BS * 128];  // the block's own rows, chunk by chunk
  alignas(1024) bf16 qv[ST][BS * 128];
  alignas(1024) bf16 dout[ST][BS * 128];
  alignas(1024) bf16 k[ST][BS * 128];
  alignas(1024) bf16 v[ST][BS * 128];
  alignas(1024) bf16 pe[ST][KW::PR * 128];
  alignas(1024) bf16 dsh[2][64 * 64];  // the shifted dS, two 64-column halves
  float pw[64 * PL];
  float mask[ST][BS];
  uint64_t own_full, full[ST], empty[ST];
  static constexpr bool kTma = false;
};

// (c) at the wide route: dqu, dqv of one (64 query rows, head x output
// chunk, batch row), and its share of dpe's columns of chunk cc (both
// 64-row halves added each tile, as the 128 instance).
template <int ST>
__global__ void __launch_bounds__(KW::THREADS, 1)
relpos_wide_dq_kernel(const __grid_constant__ WMaps mp, const float* __restrict__ mask,
                      const float* __restrict__ row_m, const float* __restrict__ row_l,
                      const float* __restrict__ dd, bf16* __restrict__ dqu,
                      bf16* __restrict__ dqv, float* __restrict__ dpe, int T, int H, int NC,
                      float scale) {
  extern __shared__ unsigned char smem_raw[];
  typedef SmemWQ<ST> Sm;
  Sm& sm = setup<Sm, ST, 1>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.x * BS, h = blockIdx.y / NC, cc = blockIdx.y % NC, b = blockIdx.z;
  const int col = h * NC * 128;
  const int steps = (T + BS - 1) / BS * NC;
  if (tid >= KW::CONSUMERS) {
    if (tid >= KW::CONSUMERS + 32) return;
    // the producer warp: step it is chunk (cc + 1 + it % NC) % NC of key
    // tile it / NC; on a tile's last step also its mask strip
    for (int it = 0; it < steps; ++it) {
      const int s = it % ST, k0 = it / NC * BS, c = col + 128 * ((cc + 1 + it % NC) % NC);
      const bool last = it % NC == NC - 1;
      hop::mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      if (last)
        for (int i = lane; i < BS; i += 32)
          sm.mask[s][i] = k0 + i < T ? mask[(size_t)b * T + k0 + i] : 0.f;
      if (lane == 0) {
        hop::mbar_expect_tx(&sm.full[s], (5 * BS + KW::PR) * 128 * 2);
        KW::template load<BS>(sm.qu[s], &mp.qu, &sm.full[s], c, q0, b);
        KW::template load<BS>(sm.qv[s], &mp.qv, &sm.full[s], c, q0, b);
        KW::template load<BS>(sm.dout[s], &mp.dout, &sm.full[s], c, q0, b);
        KW::template load<BS>(sm.k[s], &mp.k, &sm.full[s], c, k0, b);
        KW::template load<BS>(sm.v[s], &mp.v, &sm.full[s], c, k0, b);
        KW::template load_2d<KW::PR>(sm.pe[s], &mp.pe, &sm.full[s], c, T - 1 - (q0 + BS - 1) + k0);
      } else {
        hop::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  const int warp = (tid >> 5) & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const size_t bh = ((size_t)b * H + h) * T;
  // the rows' m in log2 units (+inf past T: p = 0), 1/l * scale and dd
  const float ml0 = row0 < T ? row_m[bh + row0] * LOG2E : INFINITY;
  const float ml1 = row0 + 8 < T ? row_m[bh + row0 + 8] * LOG2E : INFINITY;
  const float li0 = row0 < T ? scale / row_l[bh + row0] : 0.f;
  const float li1 = row0 + 8 < T ? scale / row_l[bh + row0 + 8] : 0.f;
  const float dr0 = row0 < T ? dd[bh + row0] : 0.f;
  const float dr1 = row0 + 8 < T ? dd[bh + row0 + 8] : 0.f;
  bf16* dsh = sm.dsh[0];
  {  // zero dSh once: the band a row writes is the same on every key tile
    uint4* z = reinterpret_cast<uint4*>(dsh);
    for (int i = tid; i < 2 * 64 * 64 / 8; i += 128) z[i] = make_uint4(0u, 0u, 0u, 0u);
    hop::fence_proxy_async();
    hop::bar_sync(1, 128);
  }
  float dqu_acc[KW::CB][KW::NACC], dqv_acc[KW::CB][KW::NACC], dpe_acc[KW::CB][KW::NACC];
  float sc[32], dp[32];
  zero<KW>(dqu_acc);
  zero<KW>(dqv_acc);
  const int D = H * NC * 128, n_real = 2 * T - 1, dcol = col + 128 * cc;
  const int pw0 = T - 1 - (q0 + 63);  // the pe window's first row on key tile 0
  for (int it = 0; it < steps; ++it) {
    const int s = it % ST, j = it % NC, k0 = it / NC * BS;
    hop::mbar_wait(&sm.full[s], (it / ST) & 1);

    // this chunk's share of the position block, S += Qu K^T, dP += dO V^T
    __syncwarp();
    position_block<KW, BS>(sm.pw, sm.qv[s], 0, sm.pe[s], 0, j > 0);
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KW::KC; ++kc)
      hop::wgmma_ss_n64(sc, KW::template kmaj<BS>(sm.qu[s], 0, kc),
                        KW::template kmaj<BS>(sm.k[s], 0, kc), j > 0 || kc > 0);
#pragma unroll
    for (int kc = 0; kc < KW::KC; ++kc)
      hop::wgmma_ss_n64(dp, KW::template kmaj<BS>(sm.dout[s], 0, kc),
                        KW::template kmaj<BS>(sm.v[s], 0, kc), j > 0 || kc > 0);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    __syncwarp();

    if (j == NC - 1) {  // chunk cc
      uint32_t dsa[16];
      dq_ds(sc, dp, sm.pw, sm.mask[s], k0, T, scale, ml0, ml1, li0, li1, dr0, dr1, dsh, dsa);
      hop::fence_proxy_async();
      hop::bar_sync(1, 128);  // every warp's dSh rows are written
      // dQu += dS K; dQv += dSh . window; dpe of the window's lower 64 rows
      hop::wgmma_fence();
      issue_ab<KW>(dqu_acc, dsa, sm.k[s]);
#pragma unroll
      for (int cb = 0; cb < KW::CB; ++cb)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          KW::ss_tb(dqv_acc[cb], hop::desc(dsh + (kk >> 2) * 64 * 64) + 2 * (kk & 3),
                    KW::template mn<KW::PR>(sm.pe[s], 0, kk, cb), 1);
      issue_dpe<KW>(dpe_acc, dsh, sm.qv[s], 0, false);
      hop::wgmma_commit();
      hop::wgmma_wait();
      fence_all<KW>(dqu_acc);
      fence_all<KW>(dqv_acc);
      fence_all<KW>(dpe_acc);
      flush_dpe<KW>(dpe, dpe_acc, pw0 + k0, n_real, D, dcol);
      // and of its upper 64 rows
      hop::wgmma_fence();
      issue_dpe<KW>(dpe_acc, dsh + 64 * 64, sm.qv[s], 0, false);
      hop::wgmma_commit();
      hop::wgmma_wait();
      fence_all<KW>(dpe_acc);
      flush_dpe<KW>(dpe, dpe_acc, pw0 + k0 + 64, n_real, D, dcol);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }
  const size_t base = (size_t)b * T * D + dcol;
  store_rows<KW>(dqu + base, dqu_acc, row0, T, D, 1.f, 1.f);
  store_rows<KW>(dqv + base, dqv_acc, row0, T, D, 1.f, 1.f);
}

// The wide kernels' maps over (B, T, H*W) tensors (dout may be null).
int encode_wide(WMaps* mp, const void* qu, const void* qv, const void* k, const void* v,
                const void* pe, const void* dout, int B, int T, int HW) {
  int rc;
  if ((rc = hop_host::encode_cols(&mp->qu, qu, B, T, HW, BS, 64)) ||
      (rc = hop_host::encode_cols(&mp->qv, qv, B, T, HW, BS, 64)) ||
      (rc = hop_host::encode_cols(&mp->k, k, B, T, HW, BS, 64)) ||
      (rc = hop_host::encode_cols(&mp->v, v, B, T, HW, BS, 64)) ||
      (rc = hop_host::encode_bf16(&mp->pe, pe, 2 * T - 1, HW, HW, KW::PR, 64)))
    return rc;
  return dout == nullptr ? 0 : hop_host::encode_cols(&mp->dout, dout, B, T, HW, BS, 64);
}

int launch_wide_fwd(const void* qu, const void* qv, const void* k, const void* v, const void* pe,
                    const void* mask, void* o, void* row_m, void* row_l, int B, int T, int H,
                    int NC, float scale, cudaStream_t stream) {
  WMaps mp = {};
  int rc, smem;
  if ((rc = encode_wide(&mp, qu, qv, k, v, pe, nullptr, B, T, H * NC * 128)) ||
      (rc = smem_for<SmemWF<WFST>>(relpos_wide_fwd_kernel, &smem)))
    return rc;
  relpos_wide_fwd_kernel<<<dim3((T + BS - 1) / BS, H * NC, B), KW::THREADS, smem, stream>>>(
      mp, (const float*)mask, (bf16*)o, (float*)row_m, (float*)row_l, T, H, NC, scale);
  return (int)cudaGetLastError();
}

int launch_wide_bwd(const void* qu, const void* qv, const void* k, const void* v, const void* pe,
                    const void* mask, const void* o, const void* dout, const void* row_m,
                    const void* row_l, void* dd, void* dqu, void* dqv, void* dk, void* dv,
                    void* dpe, int B, int T, int H, int NC, float scale, cudaStream_t st) {
  WMaps mp = {};
  int rc, smem_kv, smem_q;
  if ((rc = encode_wide(&mp, qu, qv, k, v, pe, dout, B, T, H * NC * 128)) ||
      (rc = smem_for<SmemWKV<1>>(relpos_wide_dkdv_kernel<1>, &smem_kv)) ||
      (rc = smem_for<SmemWQ<1>>(relpos_wide_dq_kernel<1>, &smem_q)))
    return rc;
  cudaError_t err;
  const size_t threads = (size_t)B * T * H * 16;
  relpos_rowdot_wide_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)o, (float*)dd, B, T, H, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((T + BS - 1) / BS, H * NC, B);
  relpos_wide_dkdv_kernel<1><<<grid, KW::THREADS, smem_kv, st>>>(
      mp, (const float*)mask, (const float*)row_m, (const float*)row_l, (const float*)dd,
      (bf16*)dk, (bf16*)dv, T, H, NC, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  relpos_wide_dq_kernel<1><<<grid, KW::THREADS, smem_q, st>>>(
      mp, (const float*)mask, (const float*)row_m, (const float*)row_l, (const float*)dd,
      (bf16*)dqu, (bf16*)dqv, (float*)dpe, T, H, NC, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qu, qv, k, v, o: (B, T, H*DH) bf16, DH 32, 64, 128 or a multiple of 128
// above (the wide route, in DH / 128 chunks; the wrapper pads other
// widths); pe: (n_pe >= 2T-1, H*DH) bf16 (rows 0 .. 2T-2 read); mask:
// (B, T) f32 additive; all contiguous and 16-byte aligned. scale: the
// score's d_head^-0.5. row_m, row_l: (B, H, T) f32 outputs (the row max and
// sum the backward reads), or both null. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for another DH, or a negative code if a
// tensor map could not be encoded.
extern "C" int relpos_flash_fwd(const void* qu, const void* qv, const void* k,
                                const void* v, const void* pe, const void* mask, void* o,
                                void* row_m, void* row_l, int B, int T, int H, int DH,
                                float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define FWD(W) launch_fwd<W>(qu, qv, k, v, pe, mask, o, row_m, row_l, B, T, H, scale, st)
  if (DH == 32) return FWD(32);
  if (DH == 64) return FWD(64);
  if (DH == 128) return FWD(128);
#undef FWD
  if (DH > 128 && DH % 128 == 0)
    return launch_wide_fwd(qu, qv, k, v, pe, mask, o, row_m, row_l, B, T, H, DH / 128, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of relpos_flash_fwd. Inputs as there, plus o and dout
// (B, T, H*DH) bf16 and the forward's row_m, row_l (B, H, T) f32; dd:
// (B, H, T) f32 scratch; outputs dqu, dqv, dk, dv (B, T, H*DH) bf16 and dpe
// (n_pe, H*DH) f32, which the caller zeroes (rows from 2T-1 on stay 0).
// Launches (a), (b), (c) on `stream`; returns the first cudaGetLastError()
// that is not cudaSuccess, cudaErrorInvalidValue for another DH, a negative
// code if a tensor map could not be encoded, or cudaSuccess.
extern "C" int relpos_flash_bwd(const void* qu, const void* qv, const void* k,
                                const void* v, const void* pe, const void* mask,
                                const void* o, const void* dout, const void* row_m,
                                const void* row_l, void* dd, void* dqu, void* dqv, void* dk,
                                void* dv, void* dpe, int B, int T, int H, int DH, float scale,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define BWD(W)                                                                             \
  launch_bwd<W>(qu, qv, k, v, pe, mask, o, dout, row_m, row_l, dd, dqu, dqv, dk, dv, dpe, B, \
                T, H, scale, st)
  if (DH == 32) return BWD(32);
  if (DH == 64) return BWD(64);
  if (DH == 128) return BWD(128);
#undef BWD
  if (DH > 128 && DH % 128 == 0)
    return launch_wide_bwd(qu, qv, k, v, pe, mask, o, dout, row_m, row_l, dd, dqu, dqv, dk, dv,
                           dpe, B, T, H, DH / 128, scale, st);
  return (int)cudaErrorInvalidValue;
}
