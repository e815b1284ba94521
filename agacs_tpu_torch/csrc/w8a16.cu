// K6: the weight-only int8 (W8A16) matmul of thin-row serving (sm_90a).
//
// Replaces agacs_tpu/ops/int8_serve.py `_w8a16_2d` / `_kernel` (:64-94):
//   y = x . bf16(f32(w_q) * w_s)   x (M, K) bf16, w_q (K, N) int8 row-major,
//                                  w_s (N,) f32, y (M, N) bf16.
// Each weight value is dequantised on chip, in float32, with its column's
// scale and rounded to bf16 once before the dot (the TPU kernel's `wt`);
// the dot is bf16 mma.sync with float32 accumulation and the output is
// rounded to bf16 once.
//
// What bounds it on the H100: the weight's bytes. A decode step's 8 rows
// do 16 operations per weight byte, far below the card's ~295 FLOP/byte
// ridge: (768, 768) is 0.59 MB (0.18 us at 3.35 TB/s), fc1 and fc2 2.36 MB
// (0.70 us), the padded logits head (768, 52224) 40.1 MB (12.0 us).
//
// The design (thin_rows.cuh): one launch a call. The raw int8 weight
// streams through a 4-slot cp.async ring (3 stages of 64 k rows in flight
// beside the stage being used), x's 64-column slice of the block's rows
// beside each stage. A thread reads 4-byte words of the weight from shared
// memory, widens each byte exactly (the byte ^ 0x80 as the low mantissa of
// 2^23, less 2^23 + 128), multiplies by its column's scale in float32 and
// rounds to bf16: those registers are the mma's A fragments (the weight
// tile is A, x^T is B), so no bf16 copy of the weight exists anywhere.
// A block is 4 warps over 128 columns (the logits head: 408 blocks, 8.5 KB
// a stage) or over 32 columns with the warps splitting each stage's four
// k-steps; below 264 column tiles K is split over a cluster of S <= 8
// blocks whose float32 partials rank 0 adds in rank order
// (`int8_serve.thin_tiling` picks BN and S from the shapes).

#include <cuda_bf16.h>

#include "thin_rows.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace thin;

constexpr int KR = 64;  // weight rows (k) a stage: 4 mma steps of 16
constexpr int G = 4;    // rows a thread reads per step (wrow's pad period)

template <int BN>
__host__ __device__ constexpr int w_bytes() {
  return KR * BN + (KR / G) * 32;
}

template <int BN, int NT>
__host__ __device__ constexpr int stage_bytes() {
  return w_bytes<BN>() + 8 * NT * A_LD;
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte c of w as the exact float32 of its int8 value.
__device__ __forceinline__ float i8f(uint32_t w, int c) {
  return __fsub_rn(__uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650 | c)),
                   8388736.f);
}

// bf16 pair (lo in the low half), each rounded once.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Block (x, rank, z): columns [BN x, BN x + BN), rows [64 z, 64 z + 8 NT),
// k stages [rank * per, rank * per + per) of 64 rows.
template <int BN, int NT>
__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ w_s, bf16* __restrict__ y, int M, int N, int K,
             int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WK = THREADS / BN;  // warps of a column group: they split each stage
  constexpr int SB = stage_bytes<BN, NT>();
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (S > 1) cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % (BN / 32), wk = warp / (BN / 32);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * 8 * MAX_NT;
  const int rows = min(8 * NT, M - m0);
  const int n_stages = (K + KR - 1) / KR;
  const int st0 = rank * per, nst = max(0, min(n_stages, st0 + per) - st0);

  // this thread's columns 4g..4g+3 of the warp's 32 (all in or all out: N % 16 == 0)
  const int cq = n0 + wn * 32 + 4 * g;
  float sc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) sc[c] = cq < N ? w_s[cq + c] : 0.f;

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const unsigned char* xa = reinterpret_cast<const unsigned char*>(x + (size_t)m0 * K);
  // Stage j of this split into slot j % STAGES as one cp.async group; past
  // the end an empty group, so every step commits one.
  auto fetch = [&](int j) {
    if (j < nst) {
      unsigned char* slot = smem + (j % STAGES) * SB;
      const int k0 = (st0 + j) * KR;
      fetch_stage<BN, KR, G, NT>(slot, slot + w_bytes<BN>(), w, K, N, k0, n0, xa,
                                 (size_t)K * 2, rows, (size_t)k0 * 2, (size_t)K * 2, tid);
    }
    cp_commit();
  };
  for (int j = 0; j < STAGES - 1; ++j) fetch(j);

  for (int j = 0; j < nst; ++j) {
    cp_wait<STAGES - 2>();  // stage j has landed (this thread's copies)
    __syncthreads();        // ... and everyone's; slot (j - 1) % STAGES is free
    fetch(j + STAGES - 1);
    const unsigned char* tile = smem + (j % STAGES) * SB;
    const unsigned char* act = tile + w_bytes<BN>();
#pragma unroll
    for (int s = 0; s < STEPS / WK; ++s) {
      const int q = wk + s * WK;
      // k rows 16q + 4t .. + 3: the mma's k pairs (2t, 2t+1) and (2t+8, 2t+9)
      uint32_t wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[r] = ld32(tile + wrow<BN, G>(16 * q + 4 * t + r) + wn * 32 + 4 * g);
      float f[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) f[r][c] = __fmul_rn(i8f(wv[r], c), sc[c]);
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = pack(f[0][2 * i], f[1][2 * i]);
        a[i][1] = pack(f[0][2 * i + 1], f[1][2 * i + 1]);
        a[i][2] = pack(f[2][2 * i], f[3][2 * i]);
        a[i][3] = pack(f[2][2 * i + 1], f[3][2 * i + 1]);
      }
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const uint2 b2 = ld64(act + (8 * jt + g) * A_LD + (16 * q + 4 * t) * 2);
        const uint32_t b[2] = {b2.x, b2.y};
        mma_bf16(acc[0][jt], a[0], b);
        mma_bf16(acc[1][jt], a[1], b);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  reduce_put<BN, NT>(acc, reinterpret_cast<float*>(smem),
                     reinterpret_cast<float*>(smem + STAGES * SB), wn, wk, rows, S, rank,
                     [&](int r, int c, float4 v) {
                       if (n0 + c < N) {  // four columns, all in or all out
                         __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
                             y + (size_t)(m0 + r) * N + n0 + c);
                         o[0] = __floats2bfloat162_rn(v.x, v.y);
                         o[1] = __floats2bfloat162_rn(v.z, v.w);
                       }
                     });
}

template <int BN, int NT>
int launch_k6(const void* x, const void* w_q, const void* w_s, void* y, int M, int N, int K,
              int S, cudaStream_t stream) {
  static bool opted[MAX_DEVICES] = {};
  return launch_split<BN, NT, stage_bytes<BN, NT>(), float>(
      w8a16_kernel<BN, NT>, opted, (K + KR - 1) / KR, S, (N + BN - 1) / BN,
      (M + 8 * MAX_NT - 1) / (8 * MAX_NT), stream, (const bf16*)x, (const int8_t*)w_q,
      (const float*)w_s, (bf16*)y, M, N, K);
}

template <int BN>
int launch_k6_rows(const void* x, const void* w_q, const void* w_s, void* y, int M, int N,
                   int K, int S, cudaStream_t stream) {
  if (M <= 8) return launch_k6<BN, 1>(x, w_q, w_s, y, M, N, K, S, stream);
  if (M <= 16) return launch_k6<BN, 2>(x, w_q, w_s, y, M, N, K, S, stream);
  if (M <= 32) return launch_k6<BN, 4>(x, w_q, w_s, y, M, N, K, S, stream);
  return launch_k6<BN, 8>(x, w_q, w_s, y, M, N, K, S, stream);
}

}  // namespace

// y (M, N) bf16 = x (M, K) bf16 . bf16(w_q (K, N) int8 * w_s (N,) f32), one
// launch. K % 16 == 0, N % 16 == 0, 16-byte aligned contiguous buffers. bn
// (32 or 128) output columns a block and K split over `splits` (1..8; 1
// at bn 128) blocks of a cluster, each ceil(stages / splits) 64-row stages
// (none empty). Returns cudaGetLastError() after the launch.
extern "C" int w8a16_matmul(const void* x, const void* w_q, const void* w_s, void* y,
                            int M, int N, int K, int bn, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 16 || (bn != 32 && bn != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 128) return launch_k6_rows<128>(x, w_q, w_s, y, M, N, K, splits, s);
  return launch_k6_rows<32>(x, w_q, w_s, y, M, N, K, splits, s);
}
