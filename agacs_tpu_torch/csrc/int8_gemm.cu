// K8: the W8A8 linear of the frozen int8 trunk, forward and dgrad, as
// hand-written sm_90a kernels (int32 accumulation on the s8 tensor cores).
//
// Replaces agacs_tpu/ops/int8_linear.py `int8_matmul` (:83-127): on the
// TPU an XLA int8 dot_general with `_row_quant` fused into its producers,
// not a Pallas kernel.
//
//   K8q int8_rowquant: per row of x (M, K), float32 v = x (* colscale), s =
//       max(max|v|, 1e-12) / 127, q = round(v / s) -> int8 q (M, K), f32 s
//       (M,). The colscale is the dgrad's `dy * w_s` (:111). HBM-bound: it
//       reads the row once and writes a byte an element. A group of TPR
//       threads (one warp, or 2-8 warps for rows above 4 KB) owns a row:
//       each thread issues all its 16-byte loads of the row at once and keeps
//       them in registers (6 a thread, so one read of up to 96 x TPR bytes), the group takes the row maximum (on bf16 pairs where there
//       is no column scale; shuffles, then shared memory across its warps),
//       and each thread quantises its registers with a correctly rounded
//       reciprocal (the IEEE quotient, as i8::quant_by) rounded onto an
//       integer by a magic-number add, into 8-byte (bf16) or 4-byte (f32)
//       stores: few instructions an element, so the issue rate stays below
//       HBM's. 256-thread blocks, four an SM, hold 8 to 1 rows each; parts
//       of a row past the registers are read again (none at K <= 768 x TPR
//       / 16 for bf16). A K whose rows are not 16-byte aligned takes the
//       same kernel one element a load.
//   K8g: out = (acc * s_row) [* w_s[col]] cast to bf16 or f32, acc = q (M,
//       K) . B, int32; B = w_q (d_in, d_out) in the forward (K = d_in, N =
//       d_out), w_q^T in the dgrad (K = d_out, N = d_in). Bias is added
//       outside, as in JAX (:151-152). Two kernels:
//     * wide_gemm_kernel, the entry `int8_gemm` (every dgrad and every
//       forward above 64 rows; it takes any M): s8 wgmma (m64n128k32 or
//       m64n64k32) fed by TMA. s8 wgmma reads A and B K-major only: A is q
//       as stored, the dgrad's B is w_q as stored ((N, K) row-major), the
//       forward's B is w_q^T, which the caller keeps (`Int8Linear.weight_t`,
//       the fused projections' cache). A persistent grid (one block an SM)
//       walks a schedule of BM x 128 output tiles (BM 128, or 64 where
//       128-row tiles leave SMs idle: `int8_linear.gemm_tiling`); a producer
//       warp keeps a ring of 4 slots (a BM x 128-byte A box and a 128 x
//       128-byte B box each) filled by TMA, two consumer warpgroups take 64
//       rows x 128 columns (BM 128) or 64 x 64 (BM 64) each, keep one
//       k-block's products in flight, and write their tile through shared
//       memory in coalesced 16-byte rows, while the producer already loads
//       the next tile. TMA fills the M, N and K tails with zeros; the stores
//       are masked.
//     * thin_gemm_kernel, the entry `int8_thin_matmul`: the forward at 64
//       rows or fewer (a decode step's 8 or 40) with K8q folded in, x in
//       bf16 or f32, one launch a product, on the thin-row design of
//       thin_rows.cuh. The raw int8 weight streams through a 4-slot cp.async
//       ring of 128-row stages (3 in flight); the weight tile is the mma's A
//       (its columns as A's rows), the quantised rows are B, and each thread
//       turns the 4-byte words it reads (rows 8t..8t+7 of a 32-row step,
//       columns 4g..4g+3) into A fragments with a 4x4 byte transpose in
//       registers, so w_q is never copied. K is split over a cluster of S <=
//       8 blocks (`int8_serve.thin_tiling`) whose int32 partials rank 0
//       adds: exact, so the result is bit-identical to the plain version
//       whatever the order. Each rank takes the row maxima of its own
//       k-range of x, the ranks exchange them through distributed shared
//       memory (one more cluster barrier), every rank takes the max of the S
//       partials, so all hold the same scales, and each stage's slice of x
//       is quantised in registers into the ring beside the weight
//       (i8::quant_by: a correctly rounded reciprocal a row and two FMA
//       corrections give the IEEE quotient, i8::quotient; each column block
//       quantises its rank's slice of every row), its loads issued before
//       the mma of the stage three earlier. x is read twice from L2 (12 KB
//       at a decode step's 8 x 768), never staged whole.
//
// Bound on the H100 (1979 TOPS int8 dense, 3.35 TB/s): at (12000, 768) ->
// 768 the product is 14.2 GOP (7.2 us) and the bytes ~28 MB (8.3 us):
// bytes-bound; at 8 rows the 0.6-2.4 MB weight read bounds it (< 1 us),
// and a launch's own latency (~3-4 us) is what a decode step pays.
#include "hopper.cuh"
#include "int8_mma.cuh"
#include "thin_rows.cuh"

#include <type_traits>

namespace {

constexpr int RQ_THREADS = 256;  // a K8q block
constexpr int RQ_V = 6;          // loads a thread keeps in registers (at most)

// The low bytes of four i8::quant_bits words, in order, as one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// One load of K8q: 16 bytes (VEC: 8 bf16 or 4 f32) or one element.
template <bool BF16, bool VEC>
struct RqUnit {
  static constexpr int E = VEC ? 16 / (BF16 ? 2 : 4) : 1;  // elements
  typedef typename std::conditional<VEC, uint4,
                                    typename std::conditional<BF16, __nv_bfloat16,
                                                              float>::type>::type Raw;
  // element e of a raw load as float32
  static __device__ __forceinline__ float val(const Raw& r, int e) {
    if constexpr (VEC && BF16)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&r)[e]);
    else if constexpr (VEC)
      return reinterpret_cast<const float*>(&r)[e];
    else if constexpr (BF16)
      return __bfloat162float(r);
    else
      return r;
  }
  // a load's elements as float32, times the column scale (if any; VEC: read
  // with 16-byte loads)
  static __device__ __forceinline__ void vals(const Raw& r, const float* cs, int c,
                                              float (&v)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = val(r, e);
    if (cs) {
      float sv[E];
      if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < E / 4; ++i) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(cs + c) + i);
          sv[4 * i] = f.x, sv[4 * i + 1] = f.y, sv[4 * i + 2] = f.z, sv[4 * i + 3] = f.w;
        }
      } else {
        sv[0] = cs[c];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = __fmul_rn(v[e], sv[e]);
    }
  }
  // max(m, |v|) over a load's elements (bf16 without a column scale: on
  // bf16 pairs, exact)
  static __device__ __forceinline__ float amax(float m, const Raw& r, const float* cs, int c) {
    if constexpr (VEC && BF16) {
      if (!cs) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
        __nv_bfloat162 m2 = __habs2(p[0]);
#pragma unroll
        for (int e = 1; e < 4; ++e) m2 = __hmax2(m2, __habs2(p[e]));
        return fmaxf(m, fmaxf(__low2float(m2), __high2float(m2)));
      }
    }
    float v[E];
    vals(r, cs, c, v);
#pragma unroll
    for (int e = 0; e < E; ++e) m = fmaxf(m, fabsf(v[e]));
    return m;
  }
  // quantise a load and store its E bytes at q[c]
  static __device__ __forceinline__ void put(int8_t* q, size_t c, const Raw& r,
                                             const float* cs, int col, float s, float y) {
    float v[E];
    vals(r, cs, col, v);
    if constexpr (E == 1) {
      q[c] = (int8_t)(uint8_t)i8::quant_bits(v[0], s, y);
    } else {
      uint32_t w[E / 4];
#pragma unroll
      for (int i = 0; i < E / 4; ++i)
        w[i] = pack4(i8::quant_bits(v[4 * i], s, y), i8::quant_bits(v[4 * i + 1], s, y),
                     i8::quant_bits(v[4 * i + 2], s, y), i8::quant_bits(v[4 * i + 3], s, y));
      if constexpr (E == 8)
        *reinterpret_cast<uint2*>(q + c) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(q + c) = w[0];
    }
  }
};

// K8q: rows of TPR threads, RQ_THREADS / TPR rows a block, V loads a
// thread in registers (fewer registers where a row needs only 3: more
// blocks an SM).
template <bool BF16, bool VEC, int TPR, int V>
__global__ void __launch_bounds__(RQ_THREADS, 4)
rowquant_kernel(const void* __restrict__ x, const float* __restrict__ cs,
                int8_t* __restrict__ q, float* __restrict__ s, int M, int K) {
  typedef RqUnit<BF16, VEC> U;
  typedef typename U::Raw Raw;
  constexpr int WPR = TPR / 32;  // warps a row
  __shared__ float red[RQ_THREADS / 32];
  const int tid = threadIdx.x, li = tid % TPR;
  const int row = blockIdx.x * (RQ_THREADS / TPR) + tid / TPR;
  const bool live = row < M;
  const int nu = K / U::E;  // loads a row (VEC: K % E == 0)
  const Raw* xr = reinterpret_cast<const Raw*>(x) + (size_t)(live ? row : 0) * nu;
  Raw r[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (live && li + j * TPR < nu) r[j] = __ldcs(xr + li + j * TPR);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int u = li + j * TPR;
    if (live && u < nu) m = U::amax(m, r[j], cs, u * U::E);
  }
  for (int u = li + V * TPR; live && u < nu; u += TPR)  // past the registers
    m = U::amax(m, xr[u], cs, u * U::E);
  m = i8::warp_max(m);
  if constexpr (WPR > 1) {
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    const int w0 = (tid / TPR) * WPR;
#pragma unroll
    for (int w = 0; w < WPR; ++w) m = fmaxf(m, red[w0 + w]);
  }
  if (!live) return;
  const float sc = i8::quant_scale(m), y = __frcp_rn(sc);
  int8_t* qr = q + (size_t)row * K;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int u = li + j * TPR;
    if (u < nu) U::put(qr, (size_t)u * U::E, r[j], cs, u * U::E, sc, y);
  }
  for (int u = li + V * TPR; u < nu; u += TPR) U::put(qr, (size_t)u * U::E, xr[u], cs, u * U::E, sc, y);
  if (li == 0) s[row] = sc;
}

// The threads a row of `nu` loads takes: one warp while its loads fit the
// registers, else up to 8 warps.
inline int rowquant_tpr(int nu) {
  int tpr = 32;
  while (tpr < RQ_THREADS && nu > tpr * RQ_V) tpr *= 2;
  return tpr;
}

template <bool BF16, bool VEC>
int launch_rowquant(const void* x, const float* cs, int8_t* q, float* s, int M, int K,
                    cudaStream_t stream) {
  const int nu = K / RqUnit<BF16, VEC>::E;
  const int tpr = rowquant_tpr(nu), rows = RQ_THREADS / tpr;
  const bool v3 = nu <= 3 * tpr;
  const dim3 grid((M + rows - 1) / rows);
#define RQ(T)                                                                          \
  if (v3)                                                                              \
    rowquant_kernel<BF16, VEC, T, 3><<<grid, RQ_THREADS, 0, stream>>>(x, cs, q, s, M, K); \
  else                                                                                 \
    rowquant_kernel<BF16, VEC, T, RQ_V><<<grid, RQ_THREADS, 0, stream>>>(x, cs, q, s, M, K)
  switch (tpr) {
    case 32: RQ(32); break;
    case 64: RQ(64); break;
    case 128: RQ(128); break;
    default: RQ(256); break;
  }
#undef RQ
  return (int)cudaGetLastError();
}

// ---- the wide kernel --------------------------------------------------------

constexpr int WBK = 128;                // bytes of a k-block: one swizzled 128-byte row
constexpr int WBN = 128;                // output columns of a tile
constexpr int WSTAGES = 4;              // ring slots
constexpr int WCONSUMERS = 256;         // two consumer warpgroups
constexpr int WTHREADS = WCONSUMERS + 32;  // and a producer warp

struct WideMaps {
  CUtensorMap a, b;  // q (M, K); B (N, K), both int8 row-major, 128-byte boxes
};

template <int BM>
__host__ __device__ constexpr int wide_slot() {
  return BM * WBK + WBN * WBK;
}

// A warpgroup's output columns: the whole 128 with 128-row tiles (each
// warpgroup 64 of the rows), else 64 (both take the tile's 64 rows).
template <int BM>
__host__ __device__ constexpr int wide_wn() {
  return BM == 128 ? WBN : WBN / 2;
}

// Row stride, in bytes, of a warpgroup's output staging: 16 bytes of pad,
// so the fragment stores of a warp's 8 rows start in 8 different banks.
template <int BM, bool OUT_BF16>
__host__ __device__ constexpr int wide_ldo() {
  return wide_wn<BM>() * (OUT_BF16 ? 2 : 4) + 16;
}

// Dynamic shared memory: the 1024-byte alignment, the ring, the two
// warpgroups' staging and the ring's barriers.
template <int BM, bool OUT_BF16>
__host__ __device__ constexpr size_t wide_smem() {
  return 1024 + (size_t)WSTAGES * wide_slot<BM>() + 2 * 64 * wide_ldo<BM, OUT_BF16>() +
         2 * WSTAGES * 8;
}

template <bool BF16>
__device__ __forceinline__ void st2(unsigned char* p, float a, float b) {
  if constexpr (BF16) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

// One BM x 128 tile of out per schedule step, tiles in row-major order
// (the 128-column tiles of a row block side by side, so the blocks that
// run together share their A rows through L2).
template <int BM, bool DGRAD, bool OUT_BF16>
__global__ void __launch_bounds__(WTHREADS, 1) wide_gemm_kernel(
    const __grid_constant__ WideMaps mp, const float* __restrict__ s_row,
    const float* __restrict__ w_s, void* __restrict__ out, int M, int N, int K) {
  constexpr int SLOT = wide_slot<BM>(), WN = wide_wn<BM>(), LDO = wide_ldo<BM, OUT_BF16>();
  constexpr int OSZ = OUT_BF16 ? 2 : 4;
  extern __shared__ unsigned char raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = base + WSTAGES * SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * 64 * LDO);
  uint64_t* empty = full + WSTAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_n = (N + WBN - 1) / WBN, tiles = (M + BM - 1) / BM * tiles_n;
  const int nkb = (K + WBK - 1) / WBK;
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], WCONSUMERS / 32);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == WCONSUMERS / 32) {  // the producer: lane 0 issues every load
    if (lane == 0) {
      hop::prefetch_map(&mp.a);
      hop::prefetch_map(&mp.b);
      int s = 0, ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * WBN;
        for (int kb = 0; kb < nkb; ++kb) {
          hop::mbar_wait(&empty[s], ph ^ 1);
          unsigned char* slot = base + s * SLOT;
          hop::mbar_expect_tx(&full[s], SLOT);
          hop::tma_load_2d(slot, &mp.a, &full[s], kb * WBK, m0);
          hop::tma_load_2d(slot + BM * WBK, &mp.b, &full[s], kb * WBK, n0);
          if (++s == WSTAGES) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows [r0, r0 + 64) and columns
  // [c0, c0 + WN) of each tile
  const int wg = tid >> 7, wtid = tid & 127, g = lane >> 2, t = lane & 3;
  const int r0 = BM == 128 ? 64 * wg : 0, c0 = BM == 128 ? 0 : 64 * wg;
  const int row0 = 16 * (warp & 3) + g;  // this thread's accumulator rows: row0, row0 + 8
  unsigned char* st = staging + wg * 64 * LDO;
  int s = 0, ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * WBN;
    int acc[WN / 2];
    int prev = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      hop::mbar_wait(&full[s], ph);
      __syncwarp();  // the wgmma below is .aligned: the warp converged
      const unsigned char* a = base + s * SLOT + r0 * WBK;
      const unsigned char* b = base + s * SLOT + BM * WBK + c0 * WBK;
      hop::wgmma_fence();
#pragma unroll
      for (int k = 0; k < WBK / 32; ++k) {
        if constexpr (WN == 128)
          hop::wgmma_s8_n128(acc, hop::desc(a, 32 * k), hop::desc(b, 32 * k), kb | k);
        else
          hop::wgmma_s8_n64(acc, hop::desc(a, 32 * k), hop::desc(b, 32 * k), kb | k);
      }
      hop::wgmma_commit();
      hop::wgmma_wait_n<1>();  // the k-block before this one has landed: free its slot
      if (kb > 0 && lane == 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == WSTAGES) s = 0, ph ^= 1;
    }
    hop::wgmma_wait();
    hop::fence_regs(acc);
    if (lane == 0) hop::mbar_arrive(&empty[prev]);

    // epilogue: (acc * s_row) [* w_s] in the plain version's float order,
    // staged row-major, then 16-byte stores of whole rows
    float sr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + row0 + 8 * h;
      sr[h] = row < M ? s_row[row] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c0 + c;
      float ws0 = 1.f, ws1 = 1.f;
      if (!DGRAD && col < N) ws0 = w_s[col], ws1 = w_s[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fmul_rn((float)acc[4 * j + 2 * h], sr[h]);
        float v1 = __fmul_rn((float)acc[4 * j + 2 * h + 1], sr[h]);
        if (!DGRAD) {
          v0 = __fmul_rn(v0, ws0);
          v1 = __fmul_rn(v1, ws1);
        }
        st2<OUT_BF16>(st + (row0 + 8 * h) * LDO + c * OSZ, v0, v1);
      }
    }
    hop::bar_sync(1 + wg, 128);
    constexpr int CH = WN * OSZ / 16;  // 16-byte chunks of a staged row
    for (int i = wtid; i < 64 * CH; i += 128) {
      const int r = i / CH, c = i % CH;
      const int row = m0 + r0 + r, col = n0 + c0 + c * (16 / OSZ);
      if (row < M && col < N)
        *reinterpret_cast<int4*>(reinterpret_cast<unsigned char*>(out) +
                                 ((size_t)row * N + col) * OSZ) =
            *reinterpret_cast<const int4*>(st + r * LDO + c * 16);
    }
    hop::bar_sync(1 + wg, 128);  // the staging is free for the next tile
  }
}

template <int BM, bool DGRAD, bool OUT_BF16>
int launch_wide_t(const WideMaps& mp, const float* s_row, const float* w_s, void* out, int M,
                  int N, int K, cudaStream_t stream) {
  constexpr size_t smem = wide_smem<BM, OUT_BF16>();
  auto kern = wide_gemm_kernel<BM, DGRAD, OUT_BF16>;
  // Set on every launch: the attribute is per device, and it is cheap.
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int tiles = (M + BM - 1) / BM * ((N + WBN - 1) / WBN);
  kern<<<tiles < sms ? tiles : sms, WTHREADS, smem, stream>>>(mp, s_row, w_s, out, M, N, K);
  return (int)cudaGetLastError();
}

// b: B (N, K) int8 row-major, K-major for the wgmma.
int launch_wide(const int8_t* a, const float* s_row, const int8_t* b, const float* w_s,
                void* out, bool out_bf16, int M, int N, int K, bool dgrad, int bm,
                cudaStream_t stream) {
  if (bm != 64 && bm != 128) return (int)cudaErrorInvalidValue;
  WideMaps mp = {};
  int rc;
  if ((rc = hop_host::encode_i8(&mp.a, a, M, K, bm)) ||
      (rc = hop_host::encode_i8(&mp.b, b, N, K, WBN)))
    return rc;
#define WIDE(BMV, DG, BF) launch_wide_t<BMV, DG, BF>(mp, s_row, w_s, out, M, N, K, stream)
  if (bm == 128) {
    if (dgrad) return out_bf16 ? WIDE(128, true, true) : WIDE(128, true, false);
    return out_bf16 ? WIDE(128, false, true) : WIDE(128, false, false);
  }
  if (dgrad) return out_bf16 ? WIDE(64, true, true) : WIDE(64, true, false);
  return out_bf16 ? WIDE(64, false, true) : WIDE(64, false, false);
#undef WIDE
}

// ---- the thin kernel ---------------------------------------------------------

// The thin forward (M <= 64): 128 weight rows a stage, 4 mma steps of 32.
constexpr int TKR = 128;
constexpr int TG = 8;  // rows a thread reads per step (wrow's pad period)
constexpr int THIN_ROWS = 64;

template <int BN>
__host__ __device__ constexpr int thin_w_bytes() {
  return TKR * BN + (TKR / TG) * 32;
}

template <int BN, int NT>
__host__ __device__ constexpr int thin_stage_bytes() {
  return thin_w_bytes<BN>() + 8 * NT * thin::A_LD;
}

// o[c] = byte c of r0, r1, r2, r3 (in that order): a 4x4 byte transpose.
__device__ __forceinline__ void trans4(uint32_t (&o)[4], uint32_t r0, uint32_t r1,
                                       uint32_t r2, uint32_t r3) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Eight consecutive values of x (bf16 or f32, 16-byte aligned) as loaded,
// and as float.
template <typename XT>
struct Raw8 {
  uint4 u[sizeof(XT) / 2];
};

template <typename XT>
__device__ __forceinline__ Raw8<XT> ld_raw8(const XT* p) {
  Raw8<XT> r;
#pragma unroll
  for (int i = 0; i < (int)sizeof(XT) / 2; ++i) r.u[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

template <typename XT>
__device__ __forceinline__ void unpack8(const Raw8<XT>& r, float (&v)[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(r.u);
  if constexpr (sizeof(XT) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      v[2 * i] = __low2float(b), v[2 * i + 1] = __high2float(b);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __uint_as_float(w[i]);
  }
}

// The fused product's rows: thread tid takes rows (tid >> 4) + 8 n (n <
// NT, the block's 8 NT rows) and the 8 values at byte (tid & 15) * 8 of
// each 128-row stage, in the max pass and in the quantisation alike.

// Stage [k0, k0 + TKR) of this thread's rows of x (M, K); zeros past M or
// K (K % 16 == 0: a group of 8 is all in or all out). All loads first.
template <typename XT, int NT>
__device__ __forceinline__ void ld_stage(Raw8<XT> (&raw)[NT], const XT* x, int M, int K,
                                         int k0, int tid) {
  const int k = k0 + (tid & 15) * 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = (tid >> 4) + 8 * n;
    if (r < M && k < K)
      raw[n] = ld_raw8(x + (size_t)r * K + k);
    else
      raw[n] = Raw8<XT>{};
  }
}

// Those values quantised with their rows' scales into a ring slot's
// activation rows (stride A_LD).
template <typename XT, int NT>
__device__ __forceinline__ void st_quant(unsigned char* act, const Raw8<XT> (&raw)[NT],
                                         const float (&sc)[NT], int M, int tid) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = (tid >> 4) + 8 * n;
    if (r >= M) break;
    float v[8];
    unpack8(raw[n], v);
    const float y = __frcp_rn(sc[n]);
    uint32_t u[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) u[e >> 2] |= i8::quant_by(v[e], sc[n], y) << (8 * (e & 3));
    *reinterpret_cast<uint2*>(act + r * thin::A_LD + (tid & 15) * 8) = make_uint2(u[0], u[1]);
  }
}

// Block (x, rank): columns [BN x, BN x + BN), all M rows, k stages
// [rank * per, rank * per + per) of 128 rows. The mma's k order is
// permuted: thread t's k bytes 4t..4t+3 and 16+4t..16+4t+3 of a step are
// the step's rows 8t..8t+3 and 8t+4..8t+7, in A and in B alike. x (M, K)
// is bf16 or float, quantised here (K8q folded in).
template <int BN, int NT, bool OUT_BF16, typename XT>
__global__ void __launch_bounds__(thin::THREADS) thin_gemm_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ w_s,
    void* __restrict__ out, int M, int N, int K, int per) {
  using namespace thin;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float pmax[MAX_SPLITS][8 * MAX_NT];  // every rank's row maxima (exchanged)
  __shared__ float sc[8 * MAX_NT];                // the rows' scales
  constexpr int WK = THREADS / BN;
  constexpr int SB = thin_stage_bytes<BN, NT>();
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (S > 1) cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % (BN / 32), wk = warp / (BN / 32);
  const int n0 = blockIdx.x * BN;
  const int n_stages = (K + TKR - 1) / TKR;
  const int st0 = rank * per, nst = max(0, min(n_stages, st0 + per) - st0);

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the weight of stage j into its slot
  auto fetch = [&](int j) {
    if (j < nst)
      fetch_stage<BN, TKR, TG, NT>(smem + (j % STAGES) * SB, nullptr, w, K, N,
                                   (st0 + j) * TKR, n0, nullptr, 0, 0, 0, 0, tid);
    cp_commit();
  };
  for (int j = 0; j < STAGES - 1; ++j) fetch(j);

  // each row's max |x| over this rank's k-range, the stages last to first
  // (stage 0's values stay in registers for its quantisation), the 16
  // threads of a row reduced by shuffles, stored into every rank's table;
  // every rank then takes the max of the S partials
  Raw8<XT> raw[NT];
  float pm[NT] = {};
  for (int j = nst - 1; j >= 0; --j) {
    ld_stage(raw, x, M, K, (st0 + j) * TKR, tid);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float v[8];
      unpack8(raw[n], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) pm[n] = fmaxf(pm[n], fabsf(v[e]));
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int o = 8; o; o >>= 1) pm[n] = fmaxf(pm[n], __shfl_xor_sync(0xffffffffu, pm[n], o));
  if (S > 1) cluster_wait();  // every block of the cluster has started
  if ((tid & 15) < S) {  // the 16 threads of a row hold its max: one rank each
    float* dst = cluster.map_shared_rank(&pmax[0][0], tid & 15) + rank * 8 * MAX_NT;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if ((tid >> 4) + 8 * n < M) dst[(tid >> 4) + 8 * n] = pm[n];
  }
  if (S > 1)
    cluster.sync();  // the partial maxima exchanged
  else
    __syncthreads();
  float xs[NT];  // the scales of this thread's rows
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = min((tid >> 4) + 8 * n, M - 1);
    float m = 0.f;
    for (int q = 0; q < S; ++q) m = fmaxf(m, pmax[q][r]);
    xs[n] = i8::quant_scale(m);
    if ((tid & 15) == 0) sc[r] = xs[n];  // the epilogue's, visible after the loop's barriers
  }
  if (S > 1) cluster_arrive_relaxed();  // reduce_put waits on it
  // stages 0 .. STAGES - 2's rows of x, quantised into their slots
  for (int j = 0; j < min(nst, STAGES - 1); ++j) {
    if (j > 0) ld_stage(raw, x, M, K, (st0 + j) * TKR, tid);
    st_quant(smem + j * SB + thin_w_bytes<BN>(), raw, xs, M, tid);
  }

  for (int j = 0; j < nst; ++j) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    fetch(j + STAGES - 1);
    // stage j + 3's rows of x: loaded before this stage's mma, quantised
    // after it into the slot stage j - 1 left (every thread is past this
    // iteration's barrier), so the loads' latency hides behind the mma
    const bool ahead = j + STAGES - 1 < nst;
    if (ahead) ld_stage(raw, x, M, K, (st0 + j + STAGES - 1) * TKR, tid);
    const unsigned char* tile = smem + (j % STAGES) * SB;
    const unsigned char* act = tile + thin_w_bytes<BN>();
#pragma unroll
    for (int s = 0; s < STEPS / WK; ++s) {
      const int q = wk + s * WK;
      uint32_t wv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wv[r] = ld32(tile + wrow<BN, TG>(32 * q + 8 * t + r) + wn * 32 + 4 * g);
      uint32_t lo[4], hi[4];  // lo[c]: rows 8t..8t+3 of column 4g + c; hi: 8t+4..8t+7
      trans4(lo, wv[0], wv[1], wv[2], wv[3]);
      trans4(hi, wv[4], wv[5], wv[6], wv[7]);
      const uint32_t af[2][4] = {{lo[0], lo[1], hi[0], hi[1]}, {lo[2], lo[3], hi[2], hi[3]}};
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const uint2 b2 = ld64(act + (8 * jt + g) * A_LD + 32 * q + 8 * t);
        const uint32_t b[2] = {b2.x, b2.y};
        i8::mma(acc[0][jt], af[0], b);
        i8::mma(acc[1][jt], af[1], b);
      }
    }
    if (ahead)
      st_quant(smem + ((j + STAGES - 1) % STAGES) * SB + thin_w_bytes<BN>(), raw, xs, M, tid);
  }
  cp_wait<0>();
  __syncthreads();

  reduce_put<BN, NT>(acc, reinterpret_cast<int*>(smem),
                     reinterpret_cast<int*>(smem + STAGES * SB), wn, wk, M, S, rank,
                     [&](int r, int c, int4 v) {
                       const int col = n0 + c;
                       if (col >= N) return;  // four columns, all in or all out
                       const float sr = sc[r];
                       const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                       for (int e = 0; e < 4; ++e)
                         i8::stf<OUT_BF16>(out, (size_t)r * N + col + e,
                                           __fmul_rn(__fmul_rn((float)vs[e], sr), w_s[col + e]));
                     });
}

template <int BN, int NT, bool OUT_BF16, typename XT>
int launch_thin_nt(const XT* x, const int8_t* w, const float* w_s, void* out, int M, int N,
                   int K, int S, cudaStream_t stream) {
  static bool opted[thin::MAX_DEVICES] = {};
  return thin::launch_split<BN, NT, thin_stage_bytes<BN, NT>(), int>(
      thin_gemm_kernel<BN, NT, OUT_BF16, XT>, opted, (K + TKR - 1) / TKR, S, (N + BN - 1) / BN, 1,
      stream, x, w, w_s, out, M, N, K);
}

template <int BN, bool OUT_BF16, typename XT>
int launch_thin_rows(const XT* x, const int8_t* w, const float* w_s, void* out, int M, int N,
                     int K, int S, cudaStream_t stream) {
  if (M <= 8) return launch_thin_nt<BN, 1, OUT_BF16>(x, w, w_s, out, M, N, K, S, stream);
  if (M <= 16) return launch_thin_nt<BN, 2, OUT_BF16>(x, w, w_s, out, M, N, K, S, stream);
  if (M <= 32) return launch_thin_nt<BN, 4, OUT_BF16>(x, w, w_s, out, M, N, K, S, stream);
  // beam 5's 40 rows: five row tiles, not eight (half the registers)
  if (M <= 40) return launch_thin_nt<BN, 5, OUT_BF16>(x, w, w_s, out, M, N, K, S, stream);
  return launch_thin_nt<BN, 8, OUT_BF16>(x, w, w_s, out, M, N, K, S, stream);
}

// x in bf16 (OUT_BF16) or float; the output in x's dtype.
template <bool OUT_BF16, typename XT>
int launch_thin(const XT* x, const int8_t* w, const float* w_s, void* out, int M, int N, int K,
                int bn, int S, cudaStream_t stream) {
  if (M > THIN_ROWS || (bn != 32 && bn != 128)) return (int)cudaErrorInvalidValue;
  if (bn == 128) return launch_thin_rows<128, OUT_BF16>(x, w, w_s, out, M, N, K, S, stream);
  return launch_thin_rows<32, OUT_BF16>(x, w, w_s, out, M, N, K, S, stream);
}

}  // namespace

// K8q: x (M, K) bf16 (x_bf16) or f32, contiguous and 16-byte aligned;
// colscale (K,) f32 or null; q (M, K) int8, s (M,) f32 out.
extern "C" int int8_rowquant(const void* x, int x_bf16, const float* colscale,
                             int8_t* q, float* s, int M, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  // 16-byte loads when every row starts on 16 bytes
  const bool vec = (size_t)K * (x_bf16 ? 2 : 4) % 16 == 0;
  if (x_bf16)
    return vec ? launch_rowquant<true, true>(x, colscale, q, s, M, K, stream)
               : launch_rowquant<true, false>(x, colscale, q, s, M, K, stream);
  return vec ? launch_rowquant<false, true>(x, colscale, q, s, M, K, stream)
             : launch_rowquant<false, false>(x, colscale, q, s, M, K, stream);
}

// out (M, N) = (a (M, K) . B) * s_row [* w_s]; B = w (K, N) if !dgrad, else
// w^T with w (N, K). Any M > 0; K % 16 == 0 and N % 16 == 0; 16-byte
// aligned buffers. The wide kernel with bm (64 or 128) rows a tile
// (`int8_linear.gemm_tiling`); the forward reads w_t = w^T (N, K), kept by
// the caller. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for what the kernel does not take, or a negative
// code if a tensor map could not be encoded.
extern "C" int int8_gemm(const int8_t* a, const float* s_row, const int8_t* w,
                         const int8_t* w_t, const float* w_s, void* out, int out_bf16, int M,
                         int N, int K, int dgrad, int bm, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 16 || (!dgrad && !w_s))
    return (int)cudaErrorInvalidValue;
  // B K-major, (N, K): the dgrad's w as stored, the forward's w^T
  const int8_t* b = dgrad ? w : w_t;
  if (!b) return (int)cudaErrorInvalidValue;
  return launch_wide(a, s_row, b, w_s, out, out_bf16, M, N, K, dgrad, bm, stream);
}

// K8q folded into the thin K8g: out (M, N) = int8_matmul(x, w, w_s) in x's
// dtype for x (M, K) bf16 (x_bf16) or f32, M <= 64, in one launch; w (K, N)
// int8, w_s (N,) f32; bn (32 or 128) columns a block and K split over
// `splits` (1..8) blocks of a cluster (`int8_serve.thin_tiling`).
extern "C" int int8_thin_matmul(const void* x, int x_bf16, const int8_t* w, const float* w_s,
                                void* out, int M, int N, int K, int bn, int splits,
                                cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 16 || !w_s) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return launch_thin<true>(static_cast<const __nv_bfloat16*>(x), w, w_s, out, M, N, K, bn,
                             splits, stream);
  return launch_thin<false>(static_cast<const float*>(x), w, w_s, out, M, N, K, bn, splits,
                            stream);
}
